"""Burst-adaptive hybrid routing — guarded steady state, SafeTail bursts.

The hybrid reactive-proactive pattern of arXiv:2512.14290 (PAPERS.md),
folded into the policy registry: under steady load the
paper's Algorithm-1 offload guard is the right call (cheapest, matches
route_best P50, no redundant load), but during a flash crowd its
home-tier binding queues behind the boot lag — exactly when SafeTail's
redundant dispatch buys the most tail. This strategy COMPOSES the two
registered policies instead of reimplementing either:

* a burst detector watches the arrival stream at flush granularity —
  a FAST arrival-rate EWMA (time constant ``burst_memory / 8``, the
  detection signal: single 0.1 s windows are far too noisy — one
  request reads as 10 req/s) against a SLOW long-horizon EWMA
  (``burst_memory``, the adapted baseline), with an enter/exit
  hysteresis band (``AdmissionConfig.burst_enter`` / ``burst_exit``,
  ratios; ``burst_min_rate``, an absolute floor so trickle traffic
  never "bursts"). The fast/slow split plus the band is what stops
  strategy flapping on oscillating traffic (MMPP) — entering costs a
  sustained 2x rate step, leaving requires the smoothed rate dropping
  back inside 1.25x of the adapted mean;
* ``decide()`` delegates verbatim to the active constituent —
  :class:`~repro_torch.control.policies.guarded.GuardedAlgorithm1Policy`
  steady, :class:`~repro_torch.control.policies.safetail.SafeTailRedundantPolicy`
  while bursting — fused kernel paths and all. Delegated decisions are
  ordinary ``WindowDecision`` objects, so the plane's conservation
  ledger (admitted + offloaded + rejected + failed == arrivals, with
  DUPLICATE accounted separately) holds without hybrid-specific cases;
* :meth:`scale_floor` exports a REACTIVE scaling floor while bursting:
  per home deployment, the stability replica count for the observed
  in-burst rate (+1 headroom). ``repro_torch.control.plane.hpa_refresh``
  raises the freshly exported PM-HPA gauges to this floor right before
  reconcile reads them, so scale-out leads the burst instead of
  trailing the PM-HPA EWMA.

The detector uses only flush timestamps (``t_now``) — no wall clock
(sim-time-purity) and no RNG, so runs are deterministic per seed.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.control.policies.base import RoutingPolicyBase, WindowDecision
from repro_torch.control.policies.guarded import GuardedAlgorithm1Policy
from repro_torch.control.policies.safetail import SafeTailRedundantPolicy
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER


class BurstAdaptiveHybridPolicy(RoutingPolicyBase):
    """EWMA burst detector switching ``guarded_alg1`` <-> ``safetail``,
    with a reactive PM-HPA scaling floor while a burst is active."""

    name = "hybrid"

    def __init__(self, cluster, router, config=None):
        super().__init__(cluster, router, config)
        # the constituents are the REGISTERED strategy objects, built on
        # the same (cluster, router, config) triple — same candidate
        # table order, same fused/vmap backend selection.
        self.steady = GuardedAlgorithm1Policy(cluster, router, config)
        self.burst = SafeTailRedundantPolicy(cluster, router, config)
        cfg = self.cfg
        self.memory = float(cfg.burst_memory)
        self.enter = float(cfg.burst_enter)
        self.exit = float(cfg.burst_exit)
        self.min_rate = float(cfg.burst_min_rate)
        if not self.exit < self.enter:
            raise ValueError(
                f"burst hysteresis needs exit < enter, got "
                f"exit={self.exit} >= enter={self.enter}")
        # detector state (flush-granular, simulated time only)
        self.bursting = False
        self.switches = 0          # strategy transitions (flap telemetry)
        self._ewma = 0.0           # SLOW long-horizon rate EWMA (baseline)
        self._fast = 0.0           # FAST rate EWMA (detection signal)
        self._last_flush: float | None = None
        self._last_dt = 0.0        # elapsed time the last window covered
        # per-home-deployment in-window rates of the LAST flush — the
        # scale floor prices the burst each deployment actually sees
        self._short: dict[str, float] = {}

    # ---- burst detector ------------------------------------------------ #
    def observe_window(self, n_reqs: int, t_now: float) -> bool:
        """Fold one flushed window into the detector; returns the
        (possibly switched) bursting state. Exposed for unit tests —
        ``decide`` calls it once per window."""
        if self._last_flush is None:
            # first window: seed both EWMAs, never burst on a cold start
            self._last_flush = t_now
            self._last_dt = max(self.cfg.window, 1e-9)
            self._ewma = self._fast = float(n_reqs) / self._last_dt
            return self.bursting
        dt = max(t_now - self._last_flush, self.cfg.window, 1e-9)
        self._last_flush = t_now
        self._last_dt = dt
        inst = float(n_reqs) / dt
        # the DETECTION SIGNAL is the fast EWMA, not the raw in-window
        # rate: at 0.1 s windows one Poisson arrival reads as 10 req/s,
        # and comparing that noise against the baseline flaps the
        # strategy on every quiet-period blip (pinned by the MMPP
        # no-flap test). memory/8 keeps detection within ~1 s of a real
        # sustained step — an order faster than pod boot lag.
        alpha_f = 1.0 - math.exp(-dt / max(self.memory / 8.0, 1e-9))
        self._fast += alpha_f * (inst - self._fast)
        rate = self._fast
        ewma = self._ewma
        if self.bursting:
            if rate <= self.exit * ewma or rate < self.min_rate:
                self.bursting = False
                self.switches += 1
        elif rate >= self.enter * ewma and rate >= self.min_rate:
            self.bursting = True
            self.switches += 1
        # time-decayed SLOW update AFTER the comparison (the detector
        # compares against the pre-burst mean, not a self-reference)
        alpha = 1.0 - math.exp(-dt / max(self.memory, 1e-9))
        self._ewma = ewma + alpha * (inst - ewma)
        return self.bursting

    # ---- strategy delegation ------------------------------------------- #
    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        if TRACER.on:
            TRACER.stage("admission.rates")
        self.observe_window(len(reqs), t_now)
        if self.bursting:
            # per-deployment in-window rates feed the scale floor
            dt = self._last_dt
            counts: dict[int, int] = {}
            for rq in reqs:
                h = self.home_index(rq)
                counts[h] = counts.get(h, 0) + 1
            deps = self.deps
            self._short = {deps[i].key: c / dt for i, c in counts.items()}
            return self.burst.decide(reqs, t_now)
        self._short = {}
        return self.steady.decide(reqs, t_now)

    # ---- reactive scaling floor (PM-HPA hook) -------------------------- #
    def scale_floor(self, t_now: float) -> dict[str, int]:
        """dep key -> minimum desired replicas while a burst is active
        (empty when steady). The floor is the Eq. 25 stability count for
        the observed in-burst rate plus one headroom replica, clamped to
        ``n_max`` — enough that the PM-HPA's lagging EWMA cannot hold
        the fleet at its pre-burst size while queues build."""
        if not self.bursting or not self._short:
            return {}
        floors: dict[str, int] = {}
        idx = self.table.index
        deps = self.deps
        for key, lam in self._short.items():
            dep = deps[idx[key]]
            n = int(np.floor(lam / dep.mu)) + 2
            floors[key] = max(1, min(n, dep.n_max))
        return floors
