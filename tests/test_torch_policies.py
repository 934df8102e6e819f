"""The redundant-dispatch policies (``safetail``, ``reliable``,
``hybrid``) of the port held against the JAX package.

Each case builds the same cluster, router and ``AdmissionConfig`` in both
packages and feeds both the same windows of requests. The port decides
under its ``vmap`` backend (the batched torch scorer) and its ``ref``
backend (the plain versions of the ``routing_topk`` / ``routing_attain``
kernels); the JAX package decides under ``vmap``, the semantics
reference. Decisions and duplicate tuples are held field for field.
Predicted latencies are held within ``rtol=2e-6`` against the JAX
backend with the same arithmetic: ``vmap`` for ``vmap`` (the exact
Erlang-C recurrence), ``pallas`` for ``ref`` (the interpolated Erlang
table; off a TPU it runs the jitted oracle). The hybrid's burst detector
is held on its state after every window.
"""
import dataclasses

import numpy as np
import pytest

import repro.control.admission as j_adm
import repro.control.plane as j_plane
import repro.control.policies as j_pol
import repro.core.catalogue as j_cat
import repro.core.latency_model as j_lm
import repro.core.router as j_router
import repro.core.scheduler as j_sched
import repro_torch.control as t_control
import repro_torch.control.admission as t_adm
import repro_torch.control.plane as t_plane
import repro_torch.control.policies as t_pol
import repro_torch.core.catalogue as t_cat
import repro_torch.core.latency_model as t_lm
import repro_torch.core.router as t_router
import repro_torch.core.scheduler as t_sched
from test_torch_telemetry import traced_decide

JAX = dict(cat=j_cat, lm=j_lm, sched=j_sched, adm=j_adm, pol=j_pol,
           router=j_router, plane=j_plane)
PORT = dict(cat=t_cat, lm=t_lm, sched=t_sched, adm=t_adm, pol=t_pol,
            router=t_router, plane=t_plane)
SLO_CASES = (None, 5.0, 1e-6)
BACKENDS = ("vmap", "ref")


def two_tier(pkg: dict):
    cat, lm, sched = pkg["cat"], pkg["lm"], pkg["sched"]
    edge = dataclasses.replace(lm.PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(lm.CLOUD, net_rtt=0.086)
    return cat.Cluster([
        cat.Deployment(lm.YOLOV5M, edge, sched.QualityClass.BALANCED,
                       n_replicas=2, n_max=6),
        cat.Deployment(lm.YOLOV5M, cloud, sched.QualityClass.BALANCED,
                       n_replicas=2, n_max=16),
    ])


def mk_reqs(pkg: dict, n: int, slo=None, t0: float = 0.0):
    sched = pkg["sched"]
    return [sched.Request(model="yolov5m",
                          quality=sched.QualityClass.BALANCED,
                          arrival=t0 + 0.001 * k, slo=slo)
            for k in range(n)]


def make(pkg: dict, name: str, **cfg):
    """A fresh policy on a fresh router over the two-tier cluster."""
    cl = two_tier(pkg)
    if pkg is PORT:
        router = pkg["router"].Router(cl, device="cpu")
        cfg.setdefault("device", "cpu")
    else:
        router = pkg["router"].Router(cl)
    return pkg["pol"].make_policy(
        name, cl, router, pkg["adm"].AdmissionConfig(block_r=8, **cfg))


#: the JAX backend whose predicted latencies each port backend matches
SAME_ARITHMETIC = {"vmap": "vmap", "ref": "pallas"}


def assert_same_decision(dt, dj) -> None:
    for field in ("primary", "feasible", "offload"):
        np.testing.assert_array_equal(getattr(dt, field),
                                      getattr(dj, field), err_msg=field)
    assert dt.duplicates == dj.duplicates


def check_window(name: str, backend: str, slo, **cfg) -> None:
    """One 12-request window through the port (``backend``) and the JAX
    package (``vmap`` for decisions, the same arithmetic for predicted
    latencies)."""
    dt = make(PORT, name, backend=backend, **cfg).decide(
        mk_reqs(PORT, 12, slo), 0.1)
    dj = make(JAX, name, backend="vmap", **cfg).decide(
        mk_reqs(JAX, 12, slo), 0.1)
    assert_same_decision(dt, dj)
    dp = make(JAX, name, backend=SAME_ARITHMETIC[backend], **cfg).decide(
        mk_reqs(JAX, 12, slo), 0.1)
    assert_same_decision(dp, dj)
    np.testing.assert_allclose(dt.predicted, dp.predicted, rtol=2e-6)
    assert (dt.g is None) == (backend == "ref")   # fused: no (R, I) matrix


class TestFusedPolicyParity:
    """The twin of the reference's ``TestFusedPolicyParity``
    (``tests/test_batch_router.py``): each port backend against the JAX
    ``vmap`` decide, on fresh-telemetry windows including the
    per-request SLO edge branches."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("slo", SLO_CASES)
    @pytest.mark.parametrize("redundancy", [1, 2, 3])
    def test_safetail_decisions_and_duplicates_match(self, redundancy, slo,
                                                     backend):
        check_window("safetail", backend, slo, redundancy=redundancy)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("slo", SLO_CASES)
    @pytest.mark.parametrize("redundancy,margin", [(1, 0.0), (2, 0.0),
                                                   (3, 0.2)])
    def test_reliable_decisions_and_duplicates_match(self, redundancy,
                                                     margin, slo, backend):
        check_window("reliable", backend, slo, redundancy=redundancy,
                     headroom_margin=margin,
                     link_loss={"edge": 0.0, "cloud": 0.05})

    def test_duplicates_are_sent_somewhere(self):
        """The parity cases above are not vacuous: a generous SLO leaves
        room for duplicates in both strategies."""
        for name in ("safetail", "reliable"):
            d = make(PORT, name, backend="ref", redundancy=3,
                     headroom_margin=0.0).decide(mk_reqs(PORT, 12, 5.0), 0.1)
            assert any(d.duplicates), name

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_paper_cluster_mixed_lanes(self, backend):
        """Three quality lanes on the paper cluster: lane exclusions go
        into the kernels as slo = -1."""
        outs = []
        for pkg, be in ((JAX, "vmap"), (PORT, backend)):
            cl = pkg["cat"].paper_cluster()
            router = (pkg["router"].Router(cl, device="cpu") if pkg is PORT
                      else pkg["router"].Router(cl))
            extra = {"device": "cpu"} if pkg is PORT else {}
            sched = pkg["sched"]
            for name in ("safetail", "reliable"):
                pol = pkg["pol"].make_policy(
                    name, cl, router, pkg["adm"].AdmissionConfig(
                        backend=be, block_r=8, redundancy=3,
                        headroom_margin=0.1, **extra))
                reqs = []
                for q, m in ((sched.QualityClass.LOW_LATENCY,
                              "efficientdet"),
                             (sched.QualityClass.BALANCED, "yolov5m"),
                             (sched.QualityClass.PRECISE, "faster_rcnn")):
                    reqs += [sched.Request(model=m, quality=q,
                                           arrival=0.001 * k)
                             for k in range(5)]
                outs.append(pol.decide(reqs, 0.2))
        for dt, dj in zip(outs[2:], outs[:2]):
            assert_same_decision(dt, dj)


class TestDeviceColumnCache:
    """The twin of ``test_fused_guard_and_topk_share_the_cache``: the
    fused path uploads the seven table columns once (plus the two
    distribution columns for ``reliable``), counted by the flush span's
    host-to-device copies."""

    @pytest.mark.parametrize("name,want", [("guarded_alg1", 7),
                                           ("safetail", 7),
                                           ("reliable", 9)])
    def test_fused_guard_and_topk_share_the_cache(self, name, want):
        pol = make(PORT, name, backend="ref", redundancy=2)
        copies = [traced_decide(pol, mk_reqs(PORT, 4), 0.1)[0]
                  for _ in range(3)]
        assert copies[1] == copies[2]
        # the columns and the Erlang table come with the first window
        assert copies[0] - copies[1] == want + 1


def hybrid_pair(**cfg):
    """The hybrid policy of a ControlPlane in each package."""
    planes = (
        j_plane.ControlPlane(two_tier(JAX), config=j_adm.AdmissionConfig(
            window=0.1, policy="hybrid", **cfg)),
        t_plane.ControlPlane(two_tier(PORT), config=t_adm.AdmissionConfig(
            window=0.1, policy="hybrid", device="cpu", **cfg)))
    return [p.policy for p in planes]


class TestBurstDetector:
    """The reference's ``TestBurstDetector`` cases
    (``tests/test_placement.py``), each through both packages."""

    def test_cold_start_never_bursts(self):
        for pol in hybrid_pair():
            assert pol.observe_window(1000, 0.0) is False
            assert pol.bursting is False

    def test_enter_exit_hysteresis(self):
        for pol in hybrid_pair(burst_min_rate=1.0):
            t = 0.0
            for _ in range(20):                 # settle the EWMA near 10/s
                t += 1.0
                assert pol.observe_window(10, t) is False
            t += 1.0
            assert pol.observe_window(60, t) is True     # 6x step: enter
            t += 1.0                            # inside the band: hold
            assert pol.observe_window(int(1.5 * pol._ewma), t) is True
            for _ in range(10):
                t += 1.0
                pol.observe_window(10, t)
            assert pol.bursting is False

    def test_min_rate_floor_blocks_trickle_bursts(self):
        for pol in hybrid_pair(burst_min_rate=5.0):
            t = 0.0
            for _ in range(10):
                t += 10.0
                pol.observe_window(1, t)        # 0.1 req/s baseline
            t += 10.0
            assert pol.observe_window(10, t) is False
            assert pol.bursting is False

    def test_invalid_hysteresis_band_raises(self):
        with pytest.raises(ValueError, match="hysteresis"):
            t_plane.ControlPlane(two_tier(PORT), config=t_adm.AdmissionConfig(
                window=0.1, policy="hybrid", device="cpu", burst_enter=1.2,
                burst_exit=1.5))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_window_sequence_matches(self, backend):
        """A quiet / burst / quiet sequence of windows through
        ``decide``: the same detector state, switches, scale floor and
        decisions after every window in both packages."""
        jc, tc = two_tier(JAX), two_tier(PORT)
        jp = j_pol.make_policy("hybrid", jc, j_router.Router(jc),
                               j_adm.AdmissionConfig(window=0.1,
                                                     burst_min_rate=2.0))
        tp = t_pol.make_policy("hybrid", tc,
                               t_router.Router(tc, device="cpu"),
                               t_adm.AdmissionConfig(
                                   window=0.1, burst_min_rate=2.0,
                                   backend=backend, device="cpu"))
        sizes = [1] * 20 + [8] * 15 + [1] * 40
        t = 0.0
        for n in sizes:
            t += 0.1
            dj = jp.decide(mk_reqs(JAX, n, t0=t), t)
            dt = tp.decide(mk_reqs(PORT, n, t0=t), t)
            assert tp.bursting == jp.bursting
            assert tp.switches == jp.switches
            assert tp.scale_floor(t) == jp.scale_floor(t)
            assert_same_decision(dt, dj)
        assert jp.switches >= 2          # entered and left a burst


class TestRegistry:
    def test_every_reference_policy_is_registered(self):
        assert sorted(t_pol.POLICIES) == sorted(j_pol.POLICIES)
        for name, cls in j_pol.POLICIES.items():
            assert t_pol.get_policy(name).__name__ == cls.__name__

    def test_exports_match_the_reference(self):
        import repro.control as j_control
        import repro.control.policy as j_shim
        import repro_torch.control.policy as t_shim
        assert set(t_pol.__all__) == set(j_pol.__all__)
        assert set(j_control.__all__) <= set(t_control.__all__)
        assert set(t_shim.__all__) == set(j_shim.__all__)
        assert t_control.RoutingPolicy is t_pol.RouteBestPolicy
        assert t_shim.SafeTailRedundantPolicy is \
            t_pol.SafeTailRedundantPolicy
