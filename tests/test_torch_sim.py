"""The slice as a whole: the port's event simulator against the JAX one.

The same seeded traces (each package building its own requests from the
same numpy draws) go through ``repro.core.simulator`` and
``repro_torch.core.simulator``; the per-request latency arrays must be
equal element for element (``np.array_equal``), and both runs must hit
the digests the reference tests pin:

* the scalar path (``GOLDEN``, ``GOLDEN_MULTIPOD``, ``GOLDEN_FAULTS`` of
  ``tests/test_sim_golden.py``), which runs no torch at all;
* the windowed path (``GOLDEN_WINDOWED`` and ``GOLDEN_WINDOWED_MULTIPOD``
  of ``tests/test_control_plane.py``) for the two ported policies, under
  the port's ``vmap`` backend (the batched torch scorer) and its ``ref``
  backend (the plain versions of the CUDA kernels), on the CPU. The JAX
  side runs its default ``vmap`` backend.

No windowed cell flips on the CPU, so none is marked ``xfail``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import test_control_plane as jcp
import test_sim_golden as jsg

from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.latency_model import CLOUD, PI4_EDGE, YOLOV5M
from repro_torch.core.scheduler import QualityClass
from repro_torch.core.workload import bounded_pareto_bursts, ramp_arrivals

PORTED = ("route_best", "guarded_alg1")
WINDOWED = sorted(k for k in jcp.GOLDEN_WINDOWED if k[2] in PORTED)
WINDOWED_MULTIPOD = sorted(
    k for k in jcp.TestWindowedGoldenDigests.GOLDEN_WINDOWED_MULTIPOD
    if k[2] in PORTED)
BACKENDS = ("vmap", "ref")


def two_tier() -> Cluster:
    """The port's twin of the reference tests' golden cluster."""
    edge = dataclasses.replace(PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(CLOUD, net_rtt=0.086)
    return Cluster([
        Deployment(YOLOV5M, edge, QualityClass.BALANCED,
                   n_replicas=2, n_max=6),
        Deployment(YOLOV5M, cloud, QualityClass.BALANCED,
                   n_replicas=2, n_max=16),
    ])


def trace_for(name: str):
    if name == "ramp":
        return ramp_arrivals([1, 2, 3, 4], 60.0, "yolov5m", seed=11)
    return bounded_pareto_bursts(3.0, 120.0, "yolov5m", seed=11)


def crash_plan() -> tsim.FaultPlan:
    """The port's twin of the reference's pinned chaos scenario."""
    return tsim.FaultPlan(
        crashes=(tsim.PodCrash(t=30.0, dep_key=jsg.FAULTS_EDGE),),
        stragglers=(tsim.Straggler(t_start=40.0, t_end=80.0,
                                   dep_key=jsg.FAULTS_EDGE, factor=4.0),),
        drop_prob={"cloud": 0.1}, seed=3)


def outcome(res, sim) -> dict:
    """Everything one run is compared on."""
    s = res.summary()
    out = dict(
        latencies=res.latencies(), n=int(s["n"]), p50=s["p50"],
        p99=s["p99"], offload_fast=res.offload_fast,
        pods_booted=res.pods_booted, pods_drained=res.pods_drained,
        faults=res.fault_counts(),
        scale_events=[(e.t, e.deployment_key, e.from_n, e.to_n, e.reason)
                      for e in res.scale_events])
    plane = getattr(sim, "plane", None)
    out["flushes"] = plane.flushes if plane is not None else None
    return out


@functools.lru_cache(maxsize=None)
def jax_run(trace: str, window: float, policy: str, pods: int,
            faults: bool, mode: str = "laimr") -> dict:
    """The reference simulator's run of one cell (shared by the port's
    backends)."""
    kw = dict(mode=mode, seed=11, slo=1.0, pods_per_deployment=pods)
    if window:
        kw.update(admission_window=window, policy=policy)
    if faults:
        kw["faults"] = jsg.crash_plan()
    sim = jsim.ClusterSimulator(jsg.two_tier(), jsim.SimConfig(**kw))
    return outcome(sim.run(jsg.trace_for(trace), horizon=500.0), sim)


def port_run(trace: str, window: float, policy: str, pods: int,
             faults: bool, mode: str = "laimr",
             backend: str = "vmap") -> dict:
    kw = dict(mode=mode, seed=11, slo=1.0, pods_per_deployment=pods,
              admission_device="cpu", admission_backend=backend)
    if window:
        kw.update(admission_window=window, policy=policy)
    if faults:
        kw["faults"] = crash_plan()
    sim = tsim.ClusterSimulator(two_tier(), tsim.SimConfig(**kw))
    arr = trace_for(trace)
    res = sim.run(arr, horizon=500.0)
    out = outcome(res, sim)
    out["arrivals"] = len(arr)
    out["completed"] = len(res.completed) + len(res.failed)
    if window:
        sim.plane.check_conservation()
    return out


def assert_same_run(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got["latencies"], want["latencies"])
    for key in ("n", "p50", "p99", "offload_fast", "pods_booted",
                "pods_drained", "faults", "scale_events", "flushes"):
        assert got[key] == want[key], key
    assert got["completed"] == got["arrivals"]


def assert_digest(got: dict, pinned: dict) -> None:
    assert got["n"] == pinned["n"]
    for key in ("offload_fast", "pods_booted", "pods_drained"):
        if key in pinned:
            assert got[key] == pinned[key], key
    assert got["p50"] == pytest.approx(pinned["p50"], rel=1e-9)
    assert got["p99"] == pytest.approx(pinned["p99"], rel=1e-9)


class TestScalarPath:
    """Per-arrival Algorithm 1 (no admission window)."""

    @pytest.mark.parametrize("trace,mode", sorted(jsg.GOLDEN))
    def test_golden(self, trace, mode):
        got = port_run(trace, 0.0, "", 1, False, mode)
        assert_same_run(got, jax_run(trace, 0.0, "", 1, False, mode))
        assert_digest(got, jsg.GOLDEN[(trace, mode)])

    @pytest.mark.parametrize("trace,mode", sorted(jsg.GOLDEN_MULTIPOD))
    def test_golden_multipod(self, trace, mode):
        got = port_run(trace, 0.0, "", 2, False, mode)
        assert_same_run(got, jax_run(trace, 0.0, "", 2, False, mode))
        assert_digest(got, jsg.GOLDEN_MULTIPOD[(trace, mode)])

    @pytest.mark.parametrize("mode", sorted(jsg.GOLDEN_FAULTS))
    def test_golden_faults(self, mode):
        got = port_run("burst", 0.0, "", 2, True, mode)
        assert_same_run(got, jax_run("burst", 0.0, "", 2, True, mode))
        pinned = jsg.GOLDEN_FAULTS[mode]
        assert_digest(got, pinned)
        assert got["faults"] == {k: pinned[k] for k in
                                 ("crashes", "drops", "straggled",
                                  "retried", "failed")}


class TestWindowedPath:
    """One admission window at a time through the port's control plane
    and policies."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("trace,window,policy", WINDOWED)
    def test_golden_windowed(self, trace, window, policy, backend):
        got = port_run(trace, window, policy, 1, False, backend=backend)
        assert_same_run(got, jax_run(trace, window, policy, 1, False))
        assert_digest(got, jcp.GOLDEN_WINDOWED[(trace, window, policy)])

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("trace,window,policy", WINDOWED_MULTIPOD)
    def test_golden_windowed_multipod(self, trace, window, policy,
                                      backend):
        got = port_run(trace, window, policy, 2, False, backend=backend)
        assert_same_run(got, jax_run(trace, window, policy, 2, False))
        assert_digest(got, jcp.TestWindowedGoldenDigests
                      .GOLDEN_WINDOWED_MULTIPOD[(trace, window, policy)])

    def test_every_ported_policy_has_pinned_cells(self):
        assert {k[2] for k in WINDOWED} == set(PORTED)
        assert len(WINDOWED) == 6 and len(WINDOWED_MULTIPOD) == 2


class TestUnportedSurface:
    def test_bucketed_backend_raises(self):
        sim = tsim.ClusterSimulator(two_tier(), tsim.SimConfig(
            mode="laimr", seed=11, slo=1.0, backend="jax"))
        with pytest.raises(ValueError, match="not ported"):
            sim.run(trace_for("ramp"), horizon=10.0)

    @pytest.mark.parametrize("policy", ["safetail", "reliable", "hybrid"])
    def test_unported_policy_raises(self, policy):
        with pytest.raises(KeyError, match="not ported"):
            tsim.ClusterSimulator(two_tier(), tsim.SimConfig(
                mode="laimr", seed=11, slo=1.0, admission_window=0.1,
                policy=policy, admission_device="cpu"))
