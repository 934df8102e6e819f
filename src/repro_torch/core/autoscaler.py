"""Autoscalers: PM-HPA (the paper's contribution, §IV-D/§V-A3) and the
reactive latency-threshold baseline it is evaluated against (§V-B).

PM-HPA
------
Each deployment computes ``desired_replicas`` from the *inverse* of the
closed-form latency model: the smallest N such that
``g_mi(lam_accum, N) <= tau_m``. The value is exported as a custom metric
(here: :class:`MetricsRegistry`; in the paper: Prometheus + adapter) and
enacted by an HPA-style reconciliation loop every ``reconcile_period``
seconds — scale by the exact difference, bounded by ``n_max`` and a
cluster quota, with graceful termination on scale-in.

Baseline
--------
``ReactiveAutoscaler`` models 'traditional latency-only autoscaling': it
scales out one replica when the *measured* recent P95 latency exceeds the
SLO, with the 60-120 s decision lag the paper attributes to lagging
CPU/latency metrics (metric scrape + stabilisation window), and scales in
after a long cool-down.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.telemetry import MetricsRegistry


def desired_replicas(dep: Deployment, lam_accum: float, tau: float,
                     n_probe: int = 64) -> int:
    """Smallest N with g_mi(lam_accum, N) <= tau  (PM-HPA custom metric).

    Evaluates the fixed-traffic latency function g_mi(N) (Eq. 17) for
    N = 1, 2, ... and returns the first feasible count (capped at n_max;
    at least 1). This is the paper's 'replica count computed in line 15
    of Algorithm 1' generalised to jump straight to the needed N instead
    of stepping one replica at a time.

    Hot path: this runs on EVERY telemetry export (per arrival in the
    simulator), so instead of evaluating a dense 1..n_probe batch through
    ``g_fixed_replicas_np`` it scans N upward with an early exit, growing
    the Erlang-B inverse recurrence one step per N. Every float op is
    bit-identical to the batched form (first-True-index semantics match
    ``np.argmax`` on the feasibility mask); test_autoscaler pins the
    equivalence against ``g_fixed_replicas_np``.
    """
    if lam_accum <= 0.0:
        return 1
    m, inst = dep.model, dep.instance
    lam = float(lam_accum)
    mu = inst.speedup / m.l_ref            # service_rate(m, i)
    # Saturated regime: rho(n) = lam/(n mu) is non-increasing in n, so if
    # even n_probe replicas are unstable every probe is infeasible and the
    # scan would return n_probe unchanged — skip it (fleet-scale arrival
    # bursts hit this constantly).
    if lam / (n_probe * mu) >= 1.0:
        return max(1, min(n_probe, dep.n_max))
    a = lam / mu
    base = m.l_ref / inst.speedup
    gamma = np.float64(dep.gamma)
    invb = 1.0                             # 1/B(a, 0)
    n_star = n_probe
    for n in range(1, n_probe + 1):
        invb = 1.0 + (n / a) * invb
        if invb > 1e280:                   # erlang_b_np's cap, inlined
            invb = 1e280
        cmu = n * mu
        rho = lam / cmu
        if rho >= 1.0:
            continue                       # queueing term infinite
        lam_tilde = lam / n
        util = (lam_tilde * m.r_demand + inst.background) / inst.r_max
        proc = base * (1.0 + float(np.power(np.float64(max(util, 0.0)),
                                            gamma)))
        b = 1.0 / invb
        cc = b / max(1.0 - rho * (1.0 - b), 1e-30)
        q = cc / max(cmu - lam, 1e-30)
        # RTT-free comparison: tau budgets processing + queueing (§V-A4)
        if (proc + inst.net_rtt + q) - inst.net_rtt <= tau:
            n_star = n
            break
    return max(1, min(n_star, dep.n_max))


@dataclasses.dataclass
class ScaleEvent:
    t: float
    deployment_key: str
    from_n: int
    to_n: int
    reason: str


class PMHPA:
    """Predictive-Metric Horizontal Pod Autoscaler (paper §V-A3).

    ``export()`` is called by the router/simulator whenever telemetry
    updates (event-driven); ``reconcile()`` runs on the HPA's 5 s loop and
    returns the scale events to enact. Replica-readiness delay (pod
    start-up) is the simulator's job, mirroring k8s semantics where the
    HPA sets ``spec.replicas`` and pods come up asynchronously.
    """

    def __init__(self, cluster: Cluster, metrics: Optional[MetricsRegistry] = None,
                 reconcile_period: float = 5.0, x: float = 2.25,
                 rho_low: float = 0.3, quota: Optional[int] = None):
        self.cluster = cluster
        self.metrics = metrics or MetricsRegistry()
        self.reconcile_period = reconcile_period
        self.x = x
        self.rho_low = rho_low
        self.quota = quota  # cluster-wide replica quota (None = unlimited)
        self.events: list[ScaleEvent] = []
        self._last_reconcile = -float("inf")
        # per-deployment constants, cached off the per-arrival export path
        self._tau: dict[str, float] = {}
        self._metric_key: dict[str, str] = {}
        # desired_replicas memo (event-batched control): the inverse-model
        # scan is pure in (dep, lam_accum) — dep.n_max and the latency-law
        # constants never change — so repeated EWMA values (IEEE fixed
        # points under steady traffic) skip the O(N) Erlang scan entirely.
        # Exact keys: hits return the exact uncached integer.
        self._n_star_cache: dict[tuple[str, float], int] = {}

    _N_STAR_CACHE_CAP = 1 << 16

    # -- custom-metric export (event-driven, §IV-D) --------------------- #
    def export(self, dep: Deployment, lam_accum: float) -> int:
        tau = self._tau.get(dep.key)
        if tau is None:
            tau = self.x * (dep.model.l_ref / dep.instance.speedup)
            self._tau[dep.key] = tau
            self._metric_key[dep.key] = self.metrics.desired_replicas_key(
                dep.model.name, dep.instance.name)
        ckey = (dep.key, lam_accum)
        n_star = self._n_star_cache.get(ckey)
        if n_star is None:
            n_star = desired_replicas(dep, lam_accum, tau)
            if len(self._n_star_cache) >= self._N_STAR_CACHE_CAP:
                self._n_star_cache.clear()
            self._n_star_cache[ckey] = n_star
        # scale-in hysteresis: only shrink when the pool is genuinely idle
        if n_star < dep.n_replicas and dep.rho(lam_accum) >= self.rho_low:
            n_star = dep.n_replicas
        self.metrics.set_gauge(self._metric_key[dep.key], n_star)
        return n_star

    def export_batch(self, pairs: "list[tuple[Deployment, float]]") -> list[int]:
        """Batched custom-metric export for one HPA tick: one call for
        all deployments (paired with ``Router.refresh_telemetry``)
        instead of a per-deployment export interleave. Per-deployment
        arithmetic is exactly :meth:`export`'s, so the batch is
        bit-identical to the scalar loop."""
        return [self.export(dep, lam_accum) for dep, lam_accum in pairs]

    # -- HPA reconciliation loop (every 5 s, §IV-D) --------------------- #
    def due(self, t_now: float) -> bool:
        return t_now - self._last_reconcile >= self.reconcile_period

    def reconcile(self, t_now: float) -> list[ScaleEvent]:
        """Read custom metrics, scale each deployment by the exact diff."""
        self._last_reconcile = t_now
        out: list[ScaleEvent] = []
        total = sum(d.n_replicas for d in self.cluster)
        for dep in self.cluster:
            key = self.metrics.desired_replicas_key(dep.model.name,
                                                    dep.instance.name)
            want = int(self.metrics.get_gauge(key, dep.n_replicas))
            want = max(1, min(want, dep.n_max))
            if self.quota is not None and want > dep.n_replicas:
                head = max(0, self.quota - total)
                want = min(want, dep.n_replicas + head)
            if want != dep.n_replicas:
                ev = ScaleEvent(t_now, dep.key, dep.n_replicas, want,
                                "pmhpa_reconcile")
                out.append(ev)
                self.events.append(ev)
                total += want - dep.n_replicas
        return out


class ReactiveAutoscaler:
    """Baseline: k8s HPA on a *measured* latency metric (Table VI baseline).

    Standard HPA semantics:  desired = ceil(current * metric / target),
    where the metric is the mean latency over the last scrape window (the
    Prometheus-measured latency the paper's baseline uses). The reactive
    lag comes from (i) the scrape/averaging window itself and (ii) the
    up/down stabilisation windows — together the 60-120 s reaction delay
    the paper attributes to lagging-metric autoscaling (§I item 3,
    §IV-D). No prediction: it only ever reacts to latency that has
    already been observed, which is exactly the behaviour LA-IMR is
    designed to beat.
    """

    def __init__(self, cluster: Cluster, slo_multiplier: float = 2.25,
                 scrape_interval: float = 15.0, up_stabilization: float = 60.0,
                 down_stabilization: float = 300.0, tolerance: float = 0.1,
                 window: int = 400, percentile: float = 95.0,
                 target_latency: float | None = None):
        self.cluster = cluster
        self.x = slo_multiplier
        self.scrape_interval = scrape_interval
        self.up_stab = up_stabilization
        self.down_stab = down_stabilization
        self.tolerance = tolerance
        self.percentile = percentile
        self.target_latency = target_latency
        self._lat: dict[str, deque] = {d.key: deque(maxlen=window) for d in cluster}
        self._metric: dict[str, float] = {d.key: 0.0 for d in cluster}
        self._last_scrape: dict[str, float] = {d.key: -float("inf") for d in cluster}
        self._breach_since: dict[str, Optional[float]] = {d.key: None for d in cluster}
        self._low_since: dict[str, Optional[float]] = {d.key: None for d in cluster}
        self.events: list[ScaleEvent] = []

    def observe(self, dep: Deployment, latency: float) -> None:
        self._lat[dep.key].append(latency)

    def _target(self, dep: Deployment) -> float:
        # measured latencies include the tier RTT, so the threshold is
        # tau + RTT (the operator knows the network floor)
        if self.target_latency is not None:
            return self.target_latency + dep.instance.net_rtt
        return self.x * (dep.model.l_ref / dep.instance.speedup) \
            + dep.instance.net_rtt

    def reconcile(self, t_now: float) -> list[ScaleEvent]:
        out: list[ScaleEvent] = []
        for dep in self.cluster:
            key = dep.key
            # scrape: refresh the metric only every scrape_interval (lag #1)
            if t_now - self._last_scrape[key] >= self.scrape_interval:
                lats = self._lat[key]
                if lats:
                    self._metric[key] = float(np.percentile(
                        np.asarray(lats), self.percentile))
                    lats.clear()
                self._last_scrape[key] = t_now
            metric = self._metric[key]
            if metric <= 0.0:
                continue
            target = self._target(dep)
            ratio = metric / target
            if abs(ratio - 1.0) <= self.tolerance:
                self._breach_since[key] = None
                self._low_since[key] = None
                continue
            desired = max(1, min(int(np.ceil(dep.n_replicas * ratio)), dep.n_max))
            if desired > dep.n_replicas:
                self._low_since[key] = None
                if self._breach_since[key] is None:
                    self._breach_since[key] = t_now
                # stabilisation window before scaling up (lag #2)
                if t_now - self._breach_since[key] >= self.up_stab:
                    ev = ScaleEvent(t_now, key, dep.n_replicas, desired,
                                    "reactive_scale_out")
                    out.append(ev)
                    self.events.append(ev)
                    self._breach_since[key] = None
            elif desired < dep.n_replicas:
                self._breach_since[key] = None
                if self._low_since[key] is None:
                    self._low_since[key] = t_now
                if t_now - self._low_since[key] >= self.down_stab:
                    ev = ScaleEvent(t_now, key, dep.n_replicas,
                                    dep.n_replicas - 1, "reactive_scale_in")
                    out.append(ev)
                    self.events.append(ev)
                    self._low_since[key] = None
        return out
