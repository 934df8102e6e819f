"""The slice as a whole: the port's event simulator against the JAX one.

The same seeded traces (each package building its own requests from the
same numpy draws) go through ``repro.core.simulator`` and
``repro_torch.core.simulator``; the per-request latency arrays must be
equal element for element (``np.array_equal``), and both runs must hit
the digests the reference tests pin:

* the scalar path (``GOLDEN``, ``GOLDEN_MULTIPOD``, ``GOLDEN_FAULTS`` of
  ``tests/test_sim_golden.py``), which runs no torch at all;
* the windowed path (``GOLDEN_WINDOWED`` and ``GOLDEN_WINDOWED_MULTIPOD``
  of ``tests/test_control_plane.py``) for the four policies with pinned
  cells, under the port's ``vmap`` backend (the batched torch scorer)
  and its ``ref`` backend (the plain versions of the CUDA kernels), on
  the CPU. The JAX side runs its default ``vmap`` backend;
* streams with no pinned digest, compared run against run: the
  ``hybrid`` policy on the flash-crowd stream (one pod ``first_fit``,
  two pods ``jsq``) and on the oscillating MMPP trace (latencies,
  ``offload_fast`` and the burst detector's ``switches``), and
  ``safetail`` / ``reliable`` under crashes, a straggler and link drops
  (the same completed and failed requests).

No windowed cell flips on the CPU, so none is marked ``xfail``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import test_control_plane as jcp
import test_sim_golden as jsg

import repro.core.catalogue as j_cat
import repro.core.latency_model as j_lm
import repro.core.scheduler as j_sched
import repro.core.workload as j_wl
import repro_torch.core.catalogue as t_cat
import repro_torch.core.latency_model as t_lm
import repro_torch.core.scheduler as t_sched
import repro_torch.core.workload as t_wl
from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.latency_model import CLOUD, PI4_EDGE, YOLOV5M
from repro_torch.core.scheduler import QualityClass
from repro_torch.core.workload import bounded_pareto_bursts, ramp_arrivals

PORTED = ("route_best", "guarded_alg1", "safetail", "reliable")
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
        assert len(WINDOWED) == 10 and len(WINDOWED_MULTIPOD) == 2


# ------------------------------------------------------ unpinned streams --
JAX_PKG = dict(cat=j_cat, lm=j_lm, sched=j_sched, wl=j_wl, sim=jsim)
PORT_PKG = dict(cat=t_cat, lm=t_lm, sched=t_sched, wl=t_wl, sim=tsim)


def experiment_cluster(pkg: dict):
    """The two-tier robot-fleet cluster of the reference benchmarks
    (edge RTT 1.0 s; cloud RTT 1.036 s at speed-up 2.0)."""
    cat, lm, sched = pkg["cat"], pkg["lm"], pkg["sched"]
    edge = dataclasses.replace(lm.PI4_EDGE, net_rtt=1.0)
    cloud = dataclasses.replace(lm.CLOUD, net_rtt=1.036, speedup=2.0)
    return cat.Cluster([
        cat.Deployment(lm.YOLOV5M, edge, sched.QualityClass.BALANCED,
                       n_replicas=3, n_max=6),
        cat.Deployment(lm.YOLOV5M, cloud, sched.QualityClass.BALANCED,
                       n_replicas=1, n_max=2),
    ])


def golden_cluster(pkg: dict):
    cat, lm, sched = pkg["cat"], pkg["lm"], pkg["sched"]
    edge = dataclasses.replace(lm.PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(lm.CLOUD, net_rtt=0.086)
    return cat.Cluster([
        cat.Deployment(lm.YOLOV5M, edge, sched.QualityClass.BALANCED,
                       n_replicas=2, n_max=6),
        cat.Deployment(lm.YOLOV5M, cloud, sched.QualityClass.BALANCED,
                       n_replicas=2, n_max=16),
    ])


def chaos_plan(sim) -> object:
    """One draw of the reference's random chaos plan
    (``tests/test_faults.py``): both tiers crash and restart, the edge
    straggles, a fifth of cloud deliveries drop and are not retried."""
    edge, cloud = "yolov5m@pi4-edge", "yolov5m@cloud"
    return sim.FaultPlan(
        crashes=(sim.PodCrash(t=12.0, dep_key=edge, restart=True),
                 sim.PodCrash(t=21.0, dep_key=cloud, restart=True)),
        stragglers=(sim.Straggler(t_start=6.0, t_end=26.0, dep_key=edge,
                                  factor=4.0),),
        drop_prob={"cloud": 0.2}, on_crash="retry", on_drop="fail",
        max_retries=1, seed=3)


#: name -> (cluster, arrivals, SimConfig fields, horizon)
STREAMS = {
    "flash": (experiment_cluster,
              lambda wl: wl.flash_crowd_arrivals(
                  2.0, 12.0, 60.0, "yolov5m", seed=7, t_start=15.0,
                  duration=12.0, ramp=5.0),
              dict(seed=7, slo=1.8, jitter_sigma=0.2), None),
    "mmpp": (golden_cluster,
             lambda wl: wl.mmpp_arrivals([2.0, 16.0], 60.0 / 8.0, 60.0,
                                         "yolov5m", seed=7),
             dict(seed=7, slo=1.8, jitter_sigma=0.2), None),
    "chaos": (golden_cluster,
              lambda wl: wl.bounded_pareto_bursts(3.0, 60.0, "yolov5m",
                                                  seed=11),
              dict(seed=11, slo=1.8, jitter_sigma=0.2, redundancy=2),
              400.0),
}


def stream_run(pkg: dict, stream: str, policy: str, pods: int,
               placement: str, **backend) -> dict:
    """One stream through one package's simulator: the latency array,
    offloads, the hybrid detector's switches, and every request's
    terminal state keyed by its creation order."""
    cluster, arrivals, cfg, horizon = STREAMS[stream]
    sim_mod = pkg["sim"]
    kw = dict(cfg, mode="laimr", admission_window=0.1, policy=policy,
              pods_per_deployment=pods, placement=placement, **backend)
    if stream == "chaos":
        kw["faults"] = chaos_plan(sim_mod)
    sim = sim_mod.ClusterSimulator(cluster(pkg), sim_mod.SimConfig(**kw))
    arr = arrivals(pkg["wl"])
    res = sim.run(arr, horizon=horizon)
    sim.plane.check_conservation()
    done = res.completed + res.failed
    assert len(done) == len(arr)
    base = min(r.req_id for r in done)
    return dict(
        latencies=res.latencies(), offload_fast=res.offload_fast,
        switches=getattr(sim.plane.policy, "switches", None),
        completed=sorted(r.req_id - base for r in res.completed),
        failed=sorted(r.req_id - base for r in res.failed),
        faults=res.fault_counts(), flushes=sim.plane.flushes)


@functools.lru_cache(maxsize=None)
def jax_stream(stream: str, policy: str, pods: int, placement: str) -> dict:
    return stream_run(JAX_PKG, stream, policy, pods, placement)


class TestUnpinnedStreams:
    """Cells with no pinned digest: the port's run against the JAX run."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("stream,pods,placement", [
        ("flash", 1, "first_fit"), ("flash", 2, "jsq"), ("mmpp", 2, "jsq")])
    def test_hybrid(self, stream, pods, placement, backend):
        got = stream_run(PORT_PKG, stream, "hybrid", pods, placement,
                         admission_device="cpu", admission_backend=backend)
        want = jax_stream(stream, "hybrid", pods, placement)
        np.testing.assert_array_equal(got["latencies"], want["latencies"])
        for key in ("offload_fast", "switches", "flushes"):
            assert got[key] == want[key], key
        if stream == "flash":
            # the flash crowd must drive the detector into safetail
            assert got["switches"] >= 1

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("policy", ["safetail", "reliable"])
    def test_chaos(self, policy, backend):
        got = stream_run(PORT_PKG, "chaos", policy, 2, "first_fit",
                         admission_device="cpu", admission_backend=backend)
        want = jax_stream("chaos", policy, 2, "first_fit")
        assert got["completed"] == want["completed"]
        assert got["failed"] == want["failed"]
        assert got["faults"] == want["faults"]
        assert want["faults"]["crashes"] >= 1 and want["failed"]
        np.testing.assert_array_equal(got["latencies"], want["latencies"])


class TestBucketedBackend:
    def test_bucketed_backend_runs(self):
        """``backend="jax"`` runs the port's bucketed twin: one latency
        sample per arrival, the event loop's pools left untouched."""
        arr = trace_for("ramp")
        sim = tsim.ClusterSimulator(two_tier(), tsim.SimConfig(
            mode="laimr", seed=11, slo=1.0, backend="jax",
            twin_device="cpu"))
        res = sim.run(arr, horizon=500.0)
        assert res.backend == "jax"
        assert res.n_arrivals == res.latency_trace.size == len(arr)
        assert (res.latency_trace > 0).all()
        assert [d.n_replicas for d in sim.cluster] == [2, 2]

    def test_unknown_backend_raises_the_references_message(self):
        arr = trace_for("ramp")
        want = jsim.ClusterSimulator(jsg.two_tier(), jsim.SimConfig(
            mode="laimr", seed=11, slo=1.0, backend="tpu"))
        got = tsim.ClusterSimulator(two_tier(), tsim.SimConfig(
            mode="laimr", seed=11, slo=1.0, backend="tpu"))
        with pytest.raises(ValueError) as exc_want:
            want.run(jsg.trace_for("ramp"), horizon=10.0)
        with pytest.raises(ValueError,
                           match="expected 'event' or 'jax'") as exc_got:
            got.run(arr, horizon=10.0)
        assert str(exc_got.value) == str(exc_want.value)
