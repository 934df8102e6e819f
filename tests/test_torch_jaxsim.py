"""The bucketed twin of the port (``repro_torch.core.jaxsim``) against
the port's event loop and against the JAX twin.

Every class of ``tests/test_jaxsim.py`` runs here on the port, on the
CPU (``twin_device="cpu"``, ``admission_device="cpu"``): the smoke cells
within ``TOLERANCES`` of the port's event loop, bit-identical reruns,
conservation, the cluster never mutated, the empty trace, the event
backend's golden digests, the six refused configurations with the
reference's messages and the failed-aware summary.

Parity with the JAX twin: the same cluster, trace and config go through
both packages (each building its own from the same seeded draws).
``n_arrivals``, the trace size, ``offload_fast``, the pods booted and
drained and the event count are exact; the bulk offload, P50, P99 and
every latency sample are within ``PARITY_RTOL`` relative. Over the
36 scenario x config cells the largest gaps measured on the CPU are
1.3e-7 per sample and 1.2e-8 on P50 / P99, with ``offload_fast``
equal everywhere: every bucket routes the same counts in both twins
(a count moved between buckets or pods would shift samples by a whole
service time), so the samples differ only by float32 rounding of the
service law. The full matrix is in ``test_torch_jaxsim_matrix.py``,
which prints these largest gaps when run as a script.
"""
import functools
import math

import numpy as np
import pytest
import torch

import test_sim_golden as jsg
from _propstub import given, settings, st
from benchmarks.common import split_latencies
from repro.core import jaxsim as j_twin
from repro.core import simulator as jsim
from repro_torch.core import jaxsim
from repro_torch.core import simulator as tsim
from repro_torch.core import workload as twl
from repro_torch.core.catalogue import paper_cluster
from repro_torch.core.scheduler import QualityClass, Request
from test_torch_sim import two_tier, trace_for

#: relative bound on P50, P99 and each latency sample, port twin against
#: the JAX twin (largest gap measured: 1.3e-7)
PARITY_RTOL = 1e-5

SCENARIOS = jsg.SCENARIOS
SMOKE_CELLS = [
    ("poisson", 0.0, "route_best", 1),
    ("flash", 0.0, "route_best", 2),
    ("mmpp", 0.1, "route_best", 1),
    ("poisson", 0.1, "route_best", 2),
    ("diurnal", 0.1, "guarded_alg1", 1),
    ("bursts", 0.1, "guarded_alg1", 2),
    ("mixed", 0.1, "guarded_alg1", 1),
]


def scenario(name: str):
    """The port's twin of ``test_sim_golden.scenario``: a fresh cluster
    and trace per call."""
    if name == "poisson":
        return two_tier(), twl.poisson_arrivals(4.0, 60.0, "yolov5m", seed=5)
    if name == "bursts":
        return two_tier(), twl.bounded_pareto_bursts(2.0, 60.0, "yolov5m",
                                                     seed=5)
    if name == "diurnal":
        return two_tier(), twl.diurnal_arrivals(3.0, 90.0, "yolov5m", seed=5,
                                                amplitude=0.9, period=45.0)
    if name == "mmpp":
        return two_tier(), twl.mmpp_arrivals([1.0, 8.0], 10.0, 80.0,
                                             "yolov5m", seed=5)
    if name == "flash":
        return two_tier(), twl.flash_crowd_arrivals(
            1.0, 12.0, 90.0, "yolov5m", seed=5, t_start=30.0,
            duration=20.0, ramp=5.0)
    if name == "mixed":
        return paper_cluster(), twl.mixed_traffic(
            {"efficientdet": 4.0, "yolov5m": 2.0, "faster_rcnn": 0.5},
            60.0, seed=5)
    raise KeyError(name)


def cfg_for(window: float, policy: str, pods: int, backend: str,
            pkg=tsim):
    kw = dict(mode="laimr", seed=5, slo=1.8, jitter_sigma=0.2,
              admission_window=window, policy=policy,
              pods_per_deployment=pods, backend=backend)
    if pkg is tsim:
        kw.update(twin_device="cpu", admission_device="cpu")
    return pkg.SimConfig(**kw)


def port_run(name, window, policy, pods, backend):
    cluster, arr = scenario(name)
    res = tsim.ClusterSimulator(
        cluster, cfg_for(window, policy, pods, backend)).run(arr)
    return res, len(arr)


@functools.lru_cache(maxsize=None)
def port_twin(name, window, policy, pods):
    """The port twin's result of one cell, run once per process (the
    rerun tests make their own runs)."""
    return port_run(name, window, policy, pods, "jax")[0]


def jax_twin_run(name, window, policy, pods):
    cluster, arr = jsg.scenario(name)
    return jsim.ClusterSimulator(
        cluster, cfg_for(window, policy, pods, "jax", jsim)).run(arr)


def assert_equivalent(oracle, twin, n, label):
    """The reference's distribution wall: conservation exact, P50/P99
    and the offload rate within ``TOLERANCES`` of the event loop."""
    assert twin.backend == "jax"
    assert twin.n_arrivals == n
    assert twin.latency_trace.size == n
    assert twin.failed_count() == 0
    assert np.isfinite(twin.latency_trace).all()
    assert len(oracle.completed) + len(oracle.failed) == n
    for q, tol in ((50.0, jaxsim.TOLERANCES["p50_rel"]),
                   (99.0, jaxsim.TOLERANCES["p99_rel"])):
        ref, got = oracle.percentile(q), twin.percentile(q)
        assert ref > 0
        rel = abs(got - ref) / ref
        assert rel <= tol, f"{label} P{q:.0f}: {got} vs {ref} (rel {rel})"
    d_off = abs(twin.offload_fast - oracle.offload_fast) / n
    assert d_off <= jaxsim.TOLERANCES["offload_abs"], (
        f"{label} offload: {twin.offload_fast} vs {oracle.offload_fast} "
        f"of {n}")


def assert_parity(got, want, label):
    """The port's twin against the JAX twin on the same cell."""
    assert got.n_arrivals == want.n_arrivals
    assert got.latency_trace.size == want.latency_trace.size
    assert got.offload_fast == want.offload_fast, label
    assert (got.pods_booted, got.pods_drained, got.n_events) == \
        (want.pods_booted, want.pods_drained, want.n_events), label
    assert got.offload_bulk == pytest.approx(want.offload_bulk,
                                             rel=PARITY_RTOL), label
    for q in (50.0, 99.0):
        assert got.percentile(q) == pytest.approx(
            want.percentile(q), rel=PARITY_RTOL), f"{label} P{q:.0f}"
    np.testing.assert_allclose(got.latency_trace, want.latency_trace,
                               rtol=PARITY_RTOL, atol=0.0, err_msg=label)


class TestDistributionEquivalence:
    @pytest.mark.parametrize("name,window,policy,pods", SMOKE_CELLS)
    def test_smoke_cells(self, name, window, policy, pods):
        oracle, n = port_run(name, window, policy, pods, "event")
        twin = port_twin(name, window, policy, pods)
        assert_equivalent(oracle, twin, n,
                          f"{name} w={window} {policy} pods={pods}")

    def test_tolerances_are_the_references(self):
        assert jaxsim.TOLERANCES == j_twin.TOLERANCES


class TestParityWithJaxTwin:
    @pytest.mark.parametrize("name,window,policy,pods", SMOKE_CELLS)
    def test_smoke_cells(self, name, window, policy, pods):
        got = port_twin(name, window, policy, pods)
        want = jax_twin_run(name, window, policy, pods)
        assert_parity(got, want, f"{name} w={window} {policy} pods={pods}")

    @pytest.mark.parametrize("n", [1, 2, 16, 40, 64, 100])
    def test_erlang_wait_matches_the_reference(self, n):
        """The inverse-Erlang-B recurrence over ``n`` steps, gathered at
        c, against the reference's ``_erlang_wait`` on the same float32
        inputs (stable, unstable and c beyond the scan). XLA flushes
        float32 subnormals to zero and PyTorch keeps them, so values
        below the smallest normal float32 may differ by that much."""
        rng = np.random.default_rng(n)
        lam = rng.uniform(0.0, 40.0, 257).astype(np.float32)
        mu = rng.uniform(0.3, 3.0, 257).astype(np.float32)
        c = rng.integers(1, n + 8, 257).astype(np.int32)
        want = np.asarray(j_twin._erlang_wait(lam, c, mu, n))
        got = jaxsim._erlang_wait(
            torch.as_tensor(lam), torch.as_tensor(c), torch.as_tensor(mu),
            torch.arange(1, n + 1, dtype=torch.float32)).numpy()
        assert np.array_equal(got >= 1e9, want >= 1e9)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=np.finfo(np.float32).tiny)


class TestTwinDeterminism:
    @given(st.sampled_from(SCENARIOS),
           st.sampled_from([(0.0, "route_best", 1),
                            (0.1, "route_best", 1),
                            (0.1, "guarded_alg1", 2)]))
    @settings(max_examples=8, deadline=None)
    def test_bit_identical_reruns_and_conservation(self, name, config):
        window, policy, pods = config
        traces = []
        for _ in range(2):
            res, n = port_run(name, window, policy, pods, "jax")
            assert res.n_arrivals == n
            assert res.latency_trace.size == n
            assert (res.latency_trace > 0).all()
            assert 0 <= res.offload_fast <= n
            traces.append(np.asarray(res.latency_trace))
        np.testing.assert_array_equal(traces[0], traces[1])

    def test_cluster_never_mutated(self):
        """The twin is pure in (cluster, cfg, arrivals): the event loop
        bumps ``n_replicas`` in place, the twin must not."""
        cluster, arr = scenario("flash")
        before = [d.n_replicas for d in cluster]
        tsim.ClusterSimulator(cluster, cfg_for(0.0, "route_best", 1,
                                               "jax")).run(arr)
        assert [d.n_replicas for d in cluster] == before

    def test_empty_trace(self):
        cluster, _ = scenario("poisson")
        res = tsim.ClusterSimulator(cluster, cfg_for(0.0, "route_best", 1,
                                                     "jax")).run([])
        assert res.n_arrivals == 0
        assert res.latency_trace.size == 0
        assert np.isnan(res.percentile(50.0))


class TestGraphDriver:
    """What the card's CUDA graphs replay, checked on the CPU: the
    replay plan and the static-buffer bookkeeping (device bucket
    counter, ``index_copy_`` of each bucket's outputs, carry copied back
    after each advance), run eagerly instead of captured."""

    @pytest.mark.parametrize("k", [1, 3, 16])
    @pytest.mark.parametrize("ticks", [[], [0], [2, 3], [5, 9], [0, 4, 9]])
    def test_replay_plan_covers_each_bucket_once(self, k, ticks):
        mask = np.zeros(10, bool)
        mask[ticks] = True
        plan = jaxsim._replay_plan(mask, k)
        b, seen = 0, []
        for kind in plan:
            n = 1 if kind == "tick" else kind
            assert kind == "tick" or kind in (1, k)
            seen += [(b + j, kind == "tick") for j in range(n)]
            b += n
        assert seen == [(i, bool(mask[i])) for i in range(10)]

    @pytest.mark.parametrize("k", [1, 7, 16])
    @pytest.mark.parametrize("name,window,policy,pods", [
        ("flash", 0.0, "route_best", 2), ("mixed", 0.1, "guarded_alg1", 1),
        ("poisson", 0.1, "route_best", 2)])
    def test_static_buffers_match_the_eager_scan(self, monkeypatch, k, name,
                                                 window, policy, pods):
        want = port_twin(name, window, policy, pods)
        monkeypatch.setattr(
            jaxsim, "_scan_eager",
            lambda c, st_, carry, A, tm: jaxsim._scan_static(
                c, st_, carry, A, tm, k, capture=False))
        got, _ = port_run(name, window, policy, pods, "jax")
        np.testing.assert_array_equal(got.latency_trace, want.latency_trace)
        assert (got.offload_fast, got.offload_bulk, got.n_events) == \
            (want.offload_fast, want.offload_bulk, want.n_events)

    def test_cuda_device_without_a_card_raises(self, monkeypatch):
        """``twin_device="cuda"`` never falls back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cluster, arr = scenario("poisson")
        cfg = cfg_for(0.0, "route_best", 1, "jax")
        cfg.twin_device = "cuda"
        with pytest.raises(RuntimeError, match="twin_device"):
            tsim.ClusterSimulator(cluster, cfg).run(arr)

    def test_twin_device_defaults_to_the_card(self):
        assert tsim.SimConfig().twin_device == "cuda"

    @pytest.mark.cuda
    @pytest.mark.parametrize("name,window,policy,pods", SMOKE_CELLS)
    def test_graphs_on_the_card_match_the_cpu(self, name, window, policy,
                                              pods):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        want = port_twin(name, window, policy, pods)
        cluster, arr = scenario(name)
        cfg = cfg_for(window, policy, pods, "jax")
        cfg.twin_device = "cuda"
        stats = {}
        got = jaxsim.simulate(cluster, cfg, arr, stats=stats)
        assert stats["replays"] > 0
        assert got.offload_fast == want.offload_fast
        np.testing.assert_allclose(got.latency_trace, want.latency_trace,
                                   rtol=PARITY_RTOL, atol=0.0)


class TestEventBackendUntouched:
    """``backend="event"`` (spelled out) keeps reproducing the reference's
    golden digests: the twin's wiring does not perturb the oracle."""

    @pytest.mark.parametrize("trace,mode", sorted(jsg.GOLDEN))
    def test_golden_digests(self, trace, mode):
        arr = trace_for(trace)
        sim = tsim.ClusterSimulator(two_tier(), tsim.SimConfig(
            mode=mode, seed=11, slo=1.0, backend="event",
            admission_device="cpu"))
        res = sim.run(arr, horizon=500.0)
        want = jsg.GOLDEN[(trace, mode)]
        s = res.summary()
        assert int(s["n"]) == want["n"]
        assert res.offload_fast == want["offload_fast"]
        assert s["p50"] == pytest.approx(want["p50"], rel=1e-9)
        assert s["p99"] == pytest.approx(want["p99"], rel=1e-9)
        assert res.backend == "event"
        assert res.latency_trace is None


class TestUnsupportedConfigs:
    """The twin refuses physics it does not model, with the reference's
    messages."""

    def setup_method(self):
        self.cluster, self.arr = scenario("poisson")

    def run_cfg(self, **kw):
        cfg = tsim.SimConfig(mode="laimr", seed=5, backend="jax",
                             twin_device="cpu", admission_device="cpu", **kw)
        return tsim.ClusterSimulator(self.cluster, cfg).run(self.arr)

    def reference_message(self, exc_type=ValueError, **kw):
        cluster, arr = jsg.scenario("poisson")
        kw = {"mode": "laimr", "seed": 5, "backend": "jax", **kw}
        with pytest.raises(exc_type) as exc:
            jsim.ClusterSimulator(cluster, jsim.SimConfig(**kw)).run(arr)
        return str(exc.value)

    def test_baseline_mode_rejected(self):
        cfg = tsim.SimConfig(mode="baseline", seed=5, backend="jax",
                             twin_device="cpu", admission_device="cpu")
        with pytest.raises(ValueError, match="laimr") as exc:
            tsim.ClusterSimulator(self.cluster, cfg).run(self.arr)
        assert str(exc.value) == self.reference_message(mode="baseline")

    def test_faults_rejected(self):
        with pytest.raises(ValueError, match="fault") as exc:
            self.run_cfg(faults=tsim.FaultPlan(drop_prob={"cloud": 0.1}))
        assert str(exc.value) == self.reference_message(
            faults=jsim.FaultPlan(drop_prob={"cloud": 0.1}))

    def test_redundant_policy_rejected(self):
        with pytest.raises(ValueError, match="safetail") as exc:
            self.run_cfg(admission_window=0.1, policy="safetail")
        assert str(exc.value) == self.reference_message(
            admission_window=0.1, policy="safetail")

    def test_rho_buckets_rejected(self):
        with pytest.raises(ValueError, match="rho") as exc:
            self.run_cfg(control_rho_buckets=4)
        assert str(exc.value) == self.reference_message(
            control_rho_buckets=4)

    def test_bad_bucket_width_rejected(self):
        with pytest.raises(ValueError, match="bucket_width") as exc:
            self.run_cfg(bucket_width=0.0)
        assert str(exc.value) == self.reference_message(bucket_width=0.0)

    def test_unknown_backend_rejected(self):
        cfg = tsim.SimConfig(mode="laimr", seed=5, backend="tpu")
        with pytest.raises(ValueError, match="backend") as exc:
            tsim.ClusterSimulator(self.cluster, cfg).run(self.arr)
        assert str(exc.value) == self.reference_message(backend="tpu")


def rq(arrival: float, latency=None) -> Request:
    r = Request(model="yolov5m", quality=QualityClass.BALANCED,
                arrival=arrival)
    if latency is not None:
        r.completion = arrival + latency
    return r


class TestFailedAwareSummary:
    """``SimResult`` percentile/summary follow the ``split_latencies``
    rule: non-finite completions are failures and never enter the
    percentile pool; a twin's trace counts arrivals."""

    def test_summary_counts_failures_like_split_latencies(self):
        completed = [rq(0.0, 1.0), rq(1.0, 3.0), rq(2.0)]
        failed = [rq(3.0)]
        res = tsim.SimResult(completed=completed, scale_events=[],
                             offload_fast=0, offload_bulk=0.0, failed=failed)
        lat, n_failed = split_latencies(completed, failed)
        s = res.summary()
        assert res.failed_count() == n_failed == 2
        assert int(s["n"]) == lat.size == 2
        assert int(s["failed"]) == 2
        assert s["p50"] == pytest.approx(np.percentile(lat, 50.0))

    def test_all_failed_yields_nan_not_silence(self):
        res = tsim.SimResult(completed=[], scale_events=[], offload_fast=0,
                             offload_bulk=0.0, failed=[rq(0.0), rq(1.0)])
        s = res.summary()
        assert int(s["failed"]) == 2
        assert int(s["n"]) == 0
        assert math.isnan(s["p50"]) and math.isnan(s["p99"])

    def test_trace_backed_result_uses_trace(self):
        trace = np.array([1.0, 2.0, 3.0, 4.0])
        res = tsim.SimResult(completed=[], scale_events=[], offload_fast=1,
                             offload_bulk=0.0, latency_trace=trace,
                             n_arrivals=4, backend="jax")
        assert res.failed_count() == 0
        assert res.percentile(50.0) == pytest.approx(
            np.percentile(trace, 50.0))
        assert int(res.summary()["n"]) == 4

    def test_trace_slo_attainment_counts_arrivals(self):
        trace = np.array([0.5, 1.5, np.inf, 0.8])
        res = tsim.SimResult(completed=[], scale_events=[], offload_fast=0,
                             offload_bulk=0.0, latency_trace=trace,
                             n_arrivals=4, backend="jax")
        assert res.failed_count() == 1
        assert res.slo_attainment(1.0) == pytest.approx(0.5)
        assert res.slo_attainment(None) == pytest.approx(0.75)
