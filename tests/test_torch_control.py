"""The port's control plane held against the JAX package.

Candidate tables, window decisions of both ported policies, the
numpy-state carry-over of ``repro_torch.convert``, and the serving
adapters' conservation ledger — each through the reference and the
port on the same inputs (torch on the CPU here). The port's ``vmap``
backend is held against the reference's ``vmap``, and its ``ref``
backend (the plain versions of the fused kernels) against the
reference's ``pallas`` backend, which off a TPU runs the jitted oracle
with the same table-interpolated arithmetic. Decisions are held
exactly; predicted latencies within ``rtol=2e-6``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propstub import given, settings, st

import repro.control.admission as j_adm
import repro.control.policies as j_pol
import repro.core.catalogue as j_cat
import repro.core.latency_model as j_lm
import repro.core.router as j_router
import repro.core.scheduler as j_sched
import repro.serving.batch_router as j_br
import repro_torch.control.admission as t_adm
import repro_torch.control.policies as t_pol
import repro_torch.core.catalogue as t_cat
import repro_torch.core.latency_model as t_lm
import repro_torch.core.router as t_router
import repro_torch.core.scheduler as t_sched
import repro_torch.serving.batch_router as t_br
from repro.kernels import ops as j_ops
from repro.kernels.routing_score import build_erlang_table as j_table
from repro_torch.control.fleet import FleetPlane as TFleet
from repro_torch.convert import candidate_table_from_numpy
from repro_torch.kernels import ops as t_ops

POLICIES = ("route_best", "guarded_alg1")


def two_tier(cat, lm, sched, n_edge: int = 2, n_cloud: int = 2):
    edge = dataclasses.replace(lm.PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(lm.CLOUD, net_rtt=0.086)
    return cat.Cluster([
        cat.Deployment(lm.YOLOV5M, edge, sched.QualityClass.BALANCED,
                       n_replicas=n_edge, n_max=6),
        cat.Deployment(lm.YOLOV5M, cloud, sched.QualityClass.BALANCED,
                       n_replicas=n_cloud, n_max=16),
    ])


JAX = dict(cat=j_cat, lm=j_lm, sched=j_sched)
TORCH = dict(cat=t_cat, lm=t_lm, sched=t_sched)


def clusters(name: str):
    if name == "paper":
        return j_cat.paper_cluster(), t_cat.paper_cluster()
    return two_tier(**JAX), two_tier(**TORCH)


def mk_reqs(sched, n: int, slo=None, quality=None, model="yolov5m"):
    q = quality if quality is not None else sched.QualityClass.BALANCED
    return [sched.Request(model=model, quality=q, arrival=0.001 * k,
                          slo=slo) for k in range(n)]


#: the reference backend each port backend is held against
JAX_BACKEND = {"vmap": "vmap", "ref": "pallas"}


def policies(name: str, backend: str, cluster: str = "two_tier", **kw):
    jc, tc = clusters(cluster)
    jp = j_pol.make_policy(name, jc, j_router.Router(jc),
                           j_adm.AdmissionConfig(
                               backend=JAX_BACKEND[backend], block_r=8,
                               **kw))
    tp = t_pol.make_policy(name, tc, t_router.Router(tc, device="cpu"),
                           t_adm.AdmissionConfig(backend=backend,
                                                 device="cpu", block_r=8,
                                                 **kw))
    return jp, tp


class TestCandidateTable:
    @pytest.mark.parametrize("cluster", ["paper", "two_tier"])
    def test_columns_equal(self, cluster):
        jp, tp = policies("route_best", "vmap", cluster)
        jt, tt = jp.table, tp.table
        for col in ("alpha", "beta", "gamma", "mu", "rtt", "cost", "tau",
                    "upstream"):
            np.testing.assert_array_equal(getattr(tt, col),
                                          getattr(jt, col), err_msg=col)
        np.testing.assert_array_equal(tt.n(), jt.n())
        assert [d.key for d in tt.deps] == [d.key for d in jt.deps]
        assert tt.tiers == jt.tiers
        assert {int(k): v.tolist() for k, v in tt.lane_mask.items()} == \
            {int(k): v.tolist() for k, v in jt.lane_mask.items()}


class TestWindowDecisions:
    SLO_CASES = (None, 5.0, 1e-6)

    @pytest.mark.parametrize("backend", ["vmap", "ref"])
    @pytest.mark.parametrize("slo", SLO_CASES)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_decide_matches_jax(self, policy, slo, backend):
        jp, tp = policies(policy, backend)
        dj = jp.decide(mk_reqs(j_sched, 12, slo=slo), 0.1)
        dt = tp.decide(mk_reqs(t_sched, 12, slo=slo), 0.1)
        np.testing.assert_array_equal(dt.primary, dj.primary)
        np.testing.assert_array_equal(dt.feasible, dj.feasible)
        np.testing.assert_array_equal(dt.offload, dj.offload)
        np.testing.assert_array_equal(dt.lam, dj.lam)
        np.testing.assert_array_equal(dt.slo, dj.slo)
        np.testing.assert_array_equal(dt.mask, dj.mask)
        np.testing.assert_allclose(dt.predicted, dj.predicted, rtol=2e-6)
        if backend == "vmap":
            np.testing.assert_allclose(dt.g, dj.g, rtol=2e-6)
        else:
            assert dt.g is None and dj.g is None   # fused: no (R, I) matrix

    @pytest.mark.parametrize("backend", ["vmap", "ref"])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_mixed_lane_window_on_paper_cluster(self, policy, backend):
        jp, tp = policies(policy, backend, cluster="paper")
        for k, (sched, pol) in enumerate(((j_sched, jp), (t_sched, tp))):
            reqs = []
            for q, m in ((sched.QualityClass.LOW_LATENCY, "efficientdet"),
                         (sched.QualityClass.BALANCED, "yolov5m"),
                         (sched.QualityClass.PRECISE, "faster_rcnn")):
                reqs += mk_reqs(sched, 5, quality=q, model=m)
            d = pol.decide(reqs, 0.2)
            if k == 0:
                want = d
        np.testing.assert_array_equal(d.primary, want.primary)
        np.testing.assert_array_equal(d.feasible, want.feasible)
        np.testing.assert_array_equal(d.offload, want.offload)

    def test_guarded_home_arrival_telemetry(self):
        """An offloaded guarded request still arrives at its home tier
        (Alg. 1 line 7) — the same telemetry on both sides."""
        jp, tp = policies("guarded_alg1", "vmap")
        jp.decide(mk_reqs(j_sched, 40), 0.1)
        tp.decide(mk_reqs(t_sched, 40), 0.1)
        for dj, dt in zip(jp.deps, tp.deps):
            assert jp.router.tel(dj.key).sliding.rate(0.1) == \
                tp.router.tel(dt.key).sliding.rate(0.1)

    def test_scalar_reference_window_matches_jax(self):
        jp, tp = policies("route_best", "vmap")
        ji, jok = jp.route_window_scalar(mk_reqs(j_sched, 16, slo=1.0), 0.1)
        ti, tok = tp.route_window_scalar(mk_reqs(t_sched, 16, slo=1.0), 0.1)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tok, jok)

    def test_unported_policies_raise_key_error(self):
        for name in ("safetail", "reliable", "hybrid"):
            with pytest.raises(KeyError, match="not ported"):
                t_pol.get_policy(name)
        with pytest.raises(KeyError, match="unknown"):
            t_pol.get_policy("no_such_policy")
        assert sorted(t_pol.POLICIES) == sorted(POLICIES)


class TestDeviceColumnCache:
    @pytest.mark.parametrize("backend", ["vmap", "ref"])
    def test_static_columns_upload_once(self, backend):
        _, pol = policies("route_best", backend)
        assert pol.host_uploads == 0
        for _ in range(5):
            pol.decide(mk_reqs(t_sched, 4), 0.1)
        assert pol.host_uploads == 7     # 6 static columns + n

    def test_replica_change_reuploads_only_n(self):
        _, pol = policies("guarded_alg1", "ref")
        pol.decide(mk_reqs(t_sched, 4), 0.1)
        assert pol.host_uploads == 7
        pol.deps[0].n_replicas += 1
        pol.decide(mk_reqs(t_sched, 4), 0.1)
        assert pol.host_uploads == 8
        pol.decide(mk_reqs(t_sched, 4), 0.1)
        assert pol.host_uploads == 8

    @pytest.mark.parametrize("r,want", [(1, 8), (8, 8), (9, 16), (300, 512)])
    def test_pad_block_buckets_like_reference(self, r, want):
        jp, tp = policies("route_best", "ref")
        assert tp._pad_block(r) == jp._pad_block(r)
        assert tp._pad_block(r)[1] >= r


class TestConvert:
    @pytest.mark.parametrize("cluster", ["paper", "two_tier"])
    def test_state_carried_from_a_jax_policy_decides_the_same(self, cluster):
        jp, _ = policies("route_best", "vmap", cluster)
        jt = jp.table
        cols = {c: getattr(jt, c) for c in ("alpha", "beta", "gamma", "mu",
                                            "rtt", "cost", "tau",
                                            "upstream")}
        cols["n"] = jt.n()
        table = np.asarray(j_table(jt.mu, jt.n().astype(np.int64)))
        dev = candidate_table_from_numpy(cols, table, "cpu")
        for c, v in cols.items():
            np.testing.assert_array_equal(dev[c].numpy(),
                                          v.astype(dev[c].numpy().dtype))
        np.testing.assert_array_equal(dev["erlang_table"].numpy(), table)
        rng = np.random.default_rng(len(jt))
        lam = rng.uniform(0.0, 6.0, (32, len(jt))).astype(np.float32)
        slo = np.broadcast_to(jt.tau, lam.shape).copy()
        names = ("alpha", "beta", "gamma", "mu", "n", "rtt")
        ti, tg, tok = t_ops.routing_score(
            torch.as_tensor(lam),
            *[dev[c] for c in names],
            torch.as_tensor(slo), dev["cost"],
            dev["erlang_table"], impl="ref")
        ji, jg, jok = j_ops.routing_score(
            jnp.asarray(lam), *[jnp.asarray(cols[c], jnp.float32)
                                for c in names],
            jnp.asarray(slo), jnp.asarray(cols["cost"], jnp.float32),
            jnp.asarray(table), impl="ref")
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-6)

    def test_rejects_malformed_columns(self):
        cols = {c: np.ones(3, np.float32) for c in
                ("alpha", "beta", "gamma", "mu", "rtt", "cost", "tau", "n")}
        cols["upstream"] = np.array([1, -1, 5])
        with pytest.raises(ValueError, match="upstream"):
            candidate_table_from_numpy(cols, np.ones((3, 65)), "cpu")
        cols["upstream"] = np.array([1, -1, -1])
        with pytest.raises(ValueError, match="erlang_table"):
            candidate_table_from_numpy(cols, np.ones((2, 65)), "cpu")


def routers(backend: str, policy: str, engines: bool, **cfg):
    jc, tc = clusters("two_tier")
    out = []
    for br_mod, adm, sched, cl, extra in (
            (j_br, j_adm, j_sched, jc, {"backend": JAX_BACKEND[backend]}),
            (t_br, t_adm, t_sched, tc, {"backend": backend,
                                        "device": "cpu"})):
        eng = ({"yolov5m@pi4-edge": adm.SlotBank(4),
                "yolov5m@cloud": adm.SlotBank(3)} if engines else None)
        out.append(br_mod.BatchRouter(
            cl, engines=eng, config=adm.AdmissionConfig(
                policy=policy, block_r=8, **extra, **cfg)))
    return out


class TestBatchRouter:
    @pytest.mark.parametrize("backend", ["vmap", "ref"])
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("engines", [False, True])
    def test_outcomes_match_jax_and_conserve(self, backend, policy,
                                             engines):
        jb, tb = routers(backend, policy, engines, max_batch=8)
        outs = []
        for br, sched in ((jb, j_sched), (tb, t_sched)):
            got = []
            for rq in mk_reqs(sched, 29, slo=1.5):
                got += [(d.outcome, d.target_key, d.slot)
                        for d in br.submit(rq, rq.arrival) or []]
            got += [(d.outcome, d.target_key, d.slot)
                    for d in br.flush(0.2)]
            br.check_conservation()
            assert br.decided == 29
            outs.append(got)
        assert outs[0] == outs[1]
        assert tb.outcomes == jb.outcomes

    @settings(max_examples=25, deadline=None)
    @given(n=st.integers(1, 60), batch=st.integers(1, 16),
           edge=st.integers(0, 4), cloud=st.integers(0, 4))
    def test_conservation_property(self, n, batch, edge, cloud):
        _, tc = clusters("two_tier")
        br = t_br.BatchRouter(
            tc, engines={"yolov5m@pi4-edge": t_adm.SlotBank(edge),
                         "yolov5m@cloud": t_adm.SlotBank(cloud)},
            config=t_adm.AdmissionConfig(backend="ref", device="cpu",
                                         max_batch=batch, block_r=8))
        for rq in mk_reqs(t_sched, n):
            br.submit(rq, rq.arrival)
        br.flush(1.0)
        br.check_conservation()
        assert br.decided == n
        assert br.outcomes[t_adm.ADMITTED] <= edge + cloud

    def test_fleet_plane_matches_jax(self):
        from repro.control.fleet import FleetPlane as JFleet
        jc, tc = clusters("two_tier")
        planes = (
            JFleet(jc, pods={"yolov5m@pi4-edge": [j_adm.SlotBank(2),
                                                  j_adm.SlotBank(2)],
                             "yolov5m@cloud": [j_adm.SlotBank(3)]},
                   config=j_adm.AdmissionConfig(max_batch=8)),
            TFleet(tc, pods={"yolov5m@pi4-edge": [t_adm.SlotBank(2),
                                                  t_adm.SlotBank(2)],
                             "yolov5m@cloud": [t_adm.SlotBank(3)]},
                   config=t_adm.AdmissionConfig(max_batch=8,
                                                device="cpu")))
        outs = []
        for plane, sched in zip(planes, (j_sched, t_sched)):
            got = []
            for rq in mk_reqs(sched, 12):
                got += [(d.outcome, d.target_key, d.slot)
                        for d in plane.submit(rq, rq.arrival) or []]
            got += [(d.outcome, d.target_key, d.slot)
                    for d in plane.flush(0.1)]
            plane.check_conservation()
            outs.append((got, plane.fleet_stats()))
        assert outs[0] == outs[1]
