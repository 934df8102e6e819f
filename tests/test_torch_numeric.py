"""Numeric core of the PyTorch port held against the JAX package.

The same seeded numpy inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (torch, CPU). Tolerances:

* float32 tensor paths (Erlang-C, Eq. 5 scoring): XLA and torch use
  different exp/log/pow code — measured over 1M draws, ``exp(g*log x)``
  differs in 12.9% of values by up to 1.07e-6 relative and ``pow`` by
  one ulp in 1.8%. ``erlang_c``/``mmc_wait`` are held to ``rtol=1e-5``
  (the Erlang recurrence compounds those per-step gaps), the router's g
  to ``rtol=2e-6`` (twice the measured exp/log gap), decisions exactly;
* numpy/float64 twins (``*_np``, ``*_scalar``, workload generators,
  calibration): bitwise — the golden digests rely on them.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import latency_model as jlm
from repro.core import queueing as jq
from repro.core import router as jr
from repro.core import workload as jw
from repro_torch.core import latency_model as tlm
from repro_torch.core import queueing as tq
from repro_torch.core import router as tr
from repro_torch.core import workload as tw

CPU = torch.device("cpu")
# XLA on the CPU flushes float32 subnormals to zero and torch does not:
# an Erlang-C probability below the smallest normal float32 may read 0
# on one side and a subnormal on the other
TINY = float(np.finfo(np.float32).tiny)


def t32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def queue_draws(seed: int, n: int = 400, cmax: int = 40):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 30.0, n).astype(np.float32)
    c = rng.integers(1, cmax, n).astype(np.int32)
    mu = rng.uniform(0.3, 3.0, n).astype(np.float32)
    return lam, c, mu


class TestQueueing:
    @pytest.mark.parametrize("seed,cmax", [(0, 8), (1, 40), (2, 512)])
    def test_erlang_c_matches_jax(self, seed, cmax):
        lam, c, mu = queue_draws(seed, cmax=cmax)
        want = np.asarray(jq.erlang_c(jnp.asarray(lam), jnp.asarray(c),
                                      jnp.asarray(mu)))
        got = tq.erlang_c(t32(lam), torch.as_tensor(c), t32(mu)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=TINY)

    @pytest.mark.parametrize("seed,cmax", [(3, 8), (4, 40), (5, 512)])
    def test_mmc_wait_matches_jax(self, seed, cmax):
        lam, c, mu = queue_draws(seed, cmax=cmax)
        want = np.asarray(jq.mmc_wait(jnp.asarray(lam), jnp.asarray(c),
                                      jnp.asarray(mu)))
        got = tq.mmc_wait(t32(lam), torch.as_tensor(c), t32(mu)).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert fin.any() and not fin.all()      # both regimes exercised
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=TINY)

    def test_mmc_wait_unstable_value_and_broadcast(self):
        lam = np.array([[0.5, 2.5], [1.5, 9.0]], np.float32)
        c = np.array([[1, 3], [1, 3]], np.int32)
        mu = np.array([[1.0, 1.0], [1.0, 1.0]], np.float32)
        want = np.asarray(jq.mmc_wait(jnp.asarray(lam), jnp.asarray(c),
                                      jnp.asarray(mu), unstable_value=1e9))
        got = tq.mmc_wait(t32(lam), torch.as_tensor(c), t32(mu),
                          unstable_value=1e9).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[1, 0] == 1e9 and got[1, 1] == 1e9

    def test_closed_forms_match_jax(self):
        rng = np.random.default_rng(6)
        lam = rng.uniform(0.0, 3.0, 64).astype(np.float32)
        mu = rng.uniform(0.5, 2.0, 64).astype(np.float32)
        np.testing.assert_allclose(
            tq.mm1_wait(t32(lam), t32(mu)).numpy(),
            np.asarray(jq.mm1_wait(jnp.asarray(lam), jnp.asarray(mu))),
            rtol=1e-6)
        np.testing.assert_array_equal(
            tq.min_stable_replicas(t32(lam), t32(mu)).numpy(),
            np.asarray(jq.min_stable_replicas(jnp.asarray(lam),
                                              jnp.asarray(mu))))
        # M/M/1 is the c = 1 case of the Erlang-C wait
        np.testing.assert_allclose(
            tq.mmc_wait(t32(lam), torch.ones(64, dtype=torch.int32),
                        t32(mu)).numpy(),
            tq.mm1_wait(t32(lam), t32(mu)).numpy(), rtol=1e-5)

    def test_replicas_for_wait_batch_matches_jax(self):
        """Scalar rates (the reference's vmap-over-c form takes one
        rate per call)."""
        rng = np.random.default_rng(7)
        for _ in range(24):
            lam, mu, target = (np.float32(rng.uniform(0.1, 20.0)),
                               np.float32(rng.uniform(0.5, 2.0)),
                               np.float32(rng.uniform(0.01, 1.0)))
            want = int(jq.replicas_for_wait_batch(
                jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(target)))
            got = int(tq.replicas_for_wait_batch(t32(lam), t32(mu),
                                                 t32(target)))
            assert got == want

    @pytest.mark.parametrize("seed", [0, 1])
    def test_numpy_and_scalar_twins_bitwise(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(60):
            lam = float(rng.uniform(0.0, 40.0))
            mu = float(rng.uniform(0.2, 4.0))
            cs = rng.integers(1, 60, 5)
            np.testing.assert_array_equal(tq.mmc_wait_np(lam, cs, mu),
                                          jq.mmc_wait_np(lam, cs, mu))
            np.testing.assert_array_equal(
                tq.erlang_b_np(max(lam, 1e-3), cs),
                jq.erlang_b_np(max(lam, 1e-3), cs))
            c = int(cs[0])
            assert tq.mmc_wait_scalar(lam, c, mu) == \
                jq.mmc_wait_scalar(lam, c, mu)
            assert tq.erlang_b_scalar(max(lam, 1e-3), c) == \
                jq.erlang_b_scalar(max(lam, 1e-3), c)
            target = float(rng.uniform(0.01, 2.0))
            assert tq.replicas_for_wait(lam, mu, target) == \
                jq.replicas_for_wait(lam, mu, target)

    @pytest.mark.parametrize("buckets", [None, 16])
    def test_erlang_memo_bitwise(self, buckets):
        rng = np.random.default_rng(8)
        mt, mj = tq.ErlangMemo(1.37, buckets), jq.ErlangMemo(1.37, buckets)
        for _ in range(300):
            lam = float(rng.choice([0.0, 0.5, 1.0, 2.0, 3.5]) +
                        rng.integers(0, 3))
            c = int(rng.integers(0, 8))
            assert mt.wait(lam, c) == mj.wait(lam, c)
        assert (mt.hits, mt.misses) == (mj.hits, mj.misses)


class TestLatencyModel:
    def test_profiles_and_affine_params_equal(self):
        for m in (tlm.EFFICIENTDET, tlm.YOLOV5M, tlm.FASTER_RCNN):
            mj = getattr(jlm, m.name.upper())
            assert dataclasses.asdict(m) == dataclasses.asdict(mj)
            for it, ij in ((tlm.PI4_EDGE, jlm.PI4_EDGE),
                           (tlm.CLOUD, jlm.CLOUD)):
                assert tlm.affine_params(m, it, 1.18) == \
                    jlm.affine_params(mj, ij, 1.18)
                assert tlm.service_rate(m, it) == jlm.service_rate(mj, ij)

    @pytest.mark.parametrize("inst", ["PI4_EDGE", "CLOUD"])
    def test_g_fixed_replicas_matches_jax(self, inst):
        rng = np.random.default_rng(9)
        lam = rng.uniform(0.0, 12.0, 200).astype(np.float32)
        n = rng.integers(1, 9, 200).astype(np.int32)
        m_t, m_j = tlm.YOLOV5M, jlm.YOLOV5M
        i_t, i_j = getattr(tlm, inst), getattr(jlm, inst)
        want = np.asarray(jlm.g_fixed_replicas(jnp.asarray(lam),
                                               jnp.asarray(n), m_j, i_j,
                                               1.49))
        got = tlm.g_fixed_replicas(t32(lam), torch.as_tensor(n), m_t, i_t,
                                   1.49).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
        got_t = tlm.g_fixed_traffic(torch.as_tensor(n), t32(lam), m_t, i_t,
                                    1.49).numpy()
        np.testing.assert_array_equal(got_t, got)

    def test_g_fixed_replicas_np_bitwise(self):
        for lam in (0.0, 0.7, 2.0, 5.5, 11.0):
            ns = np.arange(1, 10)
            np.testing.assert_array_equal(
                tlm.g_fixed_replicas_np(lam, ns, tlm.YOLOV5M, tlm.PI4_EDGE,
                                        1.18),
                jlm.g_fixed_replicas_np(lam, ns, jlm.YOLOV5M, jlm.PI4_EDGE,
                                        1.18))

    def test_power_laws_match_jax(self):
        rng = np.random.default_rng(10)
        x = rng.uniform(0.0, 5.0, 256).astype(np.float32)
        np.testing.assert_allclose(
            tlm.affine_power_law(t32(x), 0.73, 1.29, 1.49).numpy(),
            np.asarray(jlm.affine_power_law(jnp.asarray(x), 0.73, 1.29,
                                            1.49)), rtol=2e-6)
        np.testing.assert_allclose(
            tlm.processing_delay(0.73, 1.0, t32(x), 1.49).numpy(),
            np.asarray(jlm.processing_delay(0.73, 1.0, jnp.asarray(x),
                                            1.49)), rtol=2e-6)

    def test_calibrate_table_iv_bitwise(self):
        ct, cj = tlm.calibrate_from_table_iv(), jlm.calibrate_from_table_iv()
        assert (ct.alpha, ct.beta, ct.gamma, ct.mape) == \
            (cj.alpha, cj.beta, cj.gamma, cj.mape)
        free_t = tlm.calibrate_from_table_iv(saturated_only=False)
        free_j = jlm.calibrate_from_table_iv(saturated_only=False)
        assert dataclasses.asdict(free_t) == dataclasses.asdict(free_j)
        x = np.linspace(0.0, 4.0, 9)
        np.testing.assert_allclose(ct.predict(x, device=CPU).numpy(),
                                   np.asarray(cj.predict(x)), rtol=2e-6)

    def test_slo_attain_prob_bitwise(self):
        rng = np.random.default_rng(11)
        g = rng.uniform(0.1, 3.0, 100)
        g[:3] = [0.0, np.inf, -1.0]
        sigma = rng.uniform(0.0, 0.8, 100)
        sigma[5] = 0.0
        np.testing.assert_array_equal(tlm.slo_attain_prob(g, sigma, 1.5),
                                      jlm.slo_attain_prob(g, sigma, 1.5))
        assert tlm.LatencyDistribution(0.8, 0.3, 0.9).attain(1.2) == \
            jlm.LatencyDistribution(0.8, 0.3, 0.9).attain(1.2)


def candidate_table(seed: int, i: int):
    rng = np.random.default_rng(seed)
    return dict(
        alpha=rng.uniform(0.1, 1.0, i).astype(np.float32),
        beta=rng.uniform(0.1, 2.0, i).astype(np.float32),
        gamma=rng.uniform(0.9, 1.8, i).astype(np.float32),
        mu=rng.uniform(0.5, 3.0, i).astype(np.float32),
        n=rng.integers(1, 8, i).astype(np.float32),
        rtt=rng.uniform(0, 0.1, i).astype(np.float32),
    ), rng


class TestRouter:
    @pytest.mark.parametrize("i,r,rows", [(2, 64, False), (6, 128, True),
                                          (11, 96, True)])
    def test_score_instances_batch_matches_jax(self, i, r, rows):
        p, rng = candidate_table(30 + i, i)
        lam = rng.uniform(0.0, 20.0, (r, i) if rows else r) \
            .astype(np.float32)
        want = np.asarray(jr.score_instances_batch(
            jnp.asarray(lam), *[jnp.asarray(v) for v in p.values()]))
        got = tr.score_instances_batch(
            t32(lam), *[t32(v) for v in p.values()]).numpy()
        np.testing.assert_array_equal(got == jr.BIG, want == jr.BIG)
        fin = want < jr.BIG
        assert fin.any() and not fin.all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6)

    @pytest.mark.parametrize("i,r,rows", [(2, 64, False), (6, 128, True),
                                          (11, 96, True)])
    def test_select_instance_batch_decides_as_jax(self, i, r, rows):
        """Identical f32 scores -> identical decisions, with shared (I,)
        or per-request (R, I) SLO rows and lane masks."""
        rng = np.random.default_rng(40 + i)
        g = rng.uniform(0.1, 3.0, (r, i)).astype(np.float32)
        g[:, -1] = g[:, 0] * np.float32(1.0 + 4e-6)       # near-band ties
        slo = rng.uniform(0.5, 3.0, (r, i) if rows else i) \
            .astype(np.float32)
        cost = rng.uniform(1.0, 3.0, i).astype(np.float32)
        mask = rng.uniform(size=(r, i) if rows else i) < 0.8
        ji, jok = jr.select_instance_batch(jnp.asarray(g), jnp.asarray(slo),
                                           jnp.asarray(cost),
                                           jnp.asarray(mask))
        ti, tok = tr.select_instance_batch(t32(g), t32(slo), t32(cost),
                                           torch.as_tensor(mask))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def test_select_instance_boundary_cases(self):
        """The reference's pinned float32 boundary cases: exact SLO hit,
        one ulp above, exact and near cost ties, all infeasible."""
        up = float(np.nextafter(np.float32(1.0), np.float32(np.inf)))
        cases = [([1.0, 2.0], [1.0, 1.0], [1.0, 1.0]),
                 ([up, 2.0], [1.0, 2.0], [1.0, 1.0]),
                 ([0.5, 0.5], [1.0, 1.0], [3.0, 1.0]),
                 ([0.5, 0.5, 0.5], [1.0] * 3, [2.0] * 3),
                 ([1.0, 1.0 + 5e-6], [2.0, 2.0], [2.0, 1.0]),
                 ([1.0, 1.0 + 5e-5], [2.0, 2.0], [2.0, 1.0]),
                 ([3.0, 4.0], [1.0, 1.0], [1.0, 1.0]),
                 ([0.0, 1.0], [1.0, 1.0], [5.0, 1.0])]
        for g, slo, cost in cases:
            mask = np.ones(len(g), bool)
            ji, jok = jr.select_instance(jnp.asarray(g, jnp.float32),
                                         jnp.asarray(slo, jnp.float32),
                                         jnp.asarray(cost, jnp.float32),
                                         jnp.asarray(mask))
            ti, tok = tr.select_instance(t32(g), t32(slo), t32(cost),
                                         torch.as_tensor(mask))
            assert bool(tok) == bool(jok), g
            assert int(ti) == int(ji), g
            assert (int(ti), bool(tok)) == \
                tr.select_instance_scalar(g, slo, cost, mask)

    def test_scalar_twins_bitwise(self):
        rng = np.random.default_rng(12)
        p, _ = candidate_table(13, 5)
        for _ in range(100):
            lam = float(rng.uniform(0.0, 12.0))
            k = int(rng.integers(0, 5))
            args = (lam, float(p["alpha"][k]), float(p["beta"][k]),
                    float(p["gamma"][k]), float(p["mu"][k]),
                    float(p["n"][k]), float(p["rtt"][k]))
            assert tr.score_instance_scalar(*args) == \
                jr.score_instance_scalar(*args)
            np.testing.assert_array_equal(
                tr.score_instances_np(lam, *p.values()),
                jr.score_instances_np(lam, *p.values()))

    def test_router_route_best_decides_as_jax(self):
        from repro.core.catalogue import paper_cluster as j_cluster
        from repro.core.scheduler import QualityClass as JQ
        from repro.core.scheduler import Request as JReq
        from repro_torch.core.catalogue import paper_cluster as t_cluster
        from repro_torch.core.scheduler import QualityClass as TQ
        from repro_torch.core.scheduler import Request as TReq
        rj = jr.Router(j_cluster())
        rt = tr.Router(t_cluster(), device="cpu")
        for k in range(60):
            q = k % 3
            t_now = 0.05 * k
            dj = rj.route_best(JReq(model="yolov5m", quality=JQ(q),
                                    arrival=t_now), t_now)
            dt = rt.route_best(TReq(model="yolov5m", quality=TQ(q),
                                    arrival=t_now), t_now)
            assert dj.action.value == dt.action.value
            assert dj.target.key == dt.target.key
            assert dt.predicted_latency == pytest.approx(
                dj.predicted_latency, rel=2e-6)


class TestWorkload:
    GENERATORS = {
        "poisson": lambda m: m.poisson_arrivals(4.0, 120.0, "yolov5m",
                                                seed=5),
        "pareto": lambda m: m.bounded_pareto_bursts(3.0, 120.0, "yolov5m",
                                                    seed=11),
        "ramp": lambda m: m.ramp_arrivals([1, 2, 3, 4], 60.0, "yolov5m",
                                          seed=11),
        "robot": lambda m: m.robot_trace(6, 0.5, 60.0, "yolov5m", seed=3),
        "diurnal": lambda m: m.diurnal_arrivals(3.0, 90.0, "yolov5m",
                                                seed=5, amplitude=0.9,
                                                period=45.0),
        "mmpp": lambda m: m.mmpp_arrivals([1.0, 8.0], 10.0, 80.0,
                                          "yolov5m", seed=5),
        "flash": lambda m: m.flash_crowd_arrivals(
            2.0, 12.0, 60.0, "yolov5m", seed=7, t_start=15.0,
            duration=12.0, ramp=5.0),
        "mixed": lambda m: m.mixed_traffic(
            {"efficientdet": 4.0, "yolov5m": 2.0, "faster_rcnn": 0.5},
            60.0, seed=5),
    }

    @pytest.mark.parametrize("name", sorted(GENERATORS))
    def test_generator_identical_per_seed(self, name):
        gen = self.GENERATORS[name]
        a, b = gen(tw), gen(jw)
        assert len(a) == len(b) > 0
        assert [dataclasses.astuple(x) for x in a] == \
            [dataclasses.astuple(x) for x in b]
