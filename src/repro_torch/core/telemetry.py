"""In-memory telemetry (paper §I, §IV-B, Algorithm 1 lines 1-6, 15).

The LA-IMR router keeps *all* telemetry in process memory — the paper's
point is that routing state must be readable in microseconds, so no
external cache (Redis et al.) is allowed on the hot path. This module is
deliberately plain Python + deque: O(1) amortised per request, no locks,
no serialisation.

Two estimators per model stream:

* :class:`SlidingRate` — the 1-second sliding-window arrival rate
  ``SLIDINGRATE(m, t_now)`` (Algorithm 1, lines 1-6). Drives the
  per-request SLO guard (fast signal).
* EWMA-accumulated rate (Algorithm 1, line 15):
  ``lam_accum <- alpha*lam_accum + (1-alpha)*lam``. Drives replica scaling
  and bulk offload (slow, stable signal).
"""
from __future__ import annotations

import dataclasses
from collections import deque


class SlidingRate:
    """1-second sliding-window arrival-rate estimator (Alg. 1, SLIDINGRATE)."""

    def __init__(self, window: float = 1.0):
        self.window = float(window)
        self._q: deque[float] = deque()

    def observe(self, t_now: float) -> float:
        """Record an arrival at ``t_now`` and return the current rate [req/s].

        Mirrors Algorithm 1 exactly: pop arrivals older than the window,
        push the new one, rate = queue length / window.
        """
        q = self._q
        while q and t_now - q[0] > self.window:
            q.popleft()
        q.append(t_now)
        return len(q) / self.window

    def rate(self, t_now: float) -> float:
        """Read the rate without recording an arrival."""
        q = self._q
        while q and t_now - q[0] > self.window:
            q.popleft()
        return len(q) / self.window

    def __len__(self) -> int:
        return len(self._q)


class Ewma:
    """EWMA-accumulated arrival rate (Alg. 1 line 15).

    Note the paper's convention: ``alpha`` is the weight on the OLD value
    (alpha=0.8 in §V-A4), i.e. value <- alpha*value + (1-alpha)*sample.
    """

    def __init__(self, alpha: float = 0.8, init: float = 0.0):
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"EWMA weight must be in [0,1), got {alpha}")
        self.alpha = float(alpha)
        self.value = float(init)

    def update(self, sample: float) -> float:
        self.value = self.alpha * self.value + (1.0 - self.alpha) * sample
        return self.value


@dataclasses.dataclass
class ModelTelemetry:
    """Per-model in-memory telemetry block held by the router."""

    sliding: SlidingRate
    ewma: Ewma
    # Rolling counters for observability (exported as "custom metrics").
    arrivals: int = 0
    offloaded_fast: int = 0     # per-request SLO-guard offloads (Alg.1 line 11)
    offloaded_bulk: float = 0.0  # fractional bulk offload mass (Alg.1 line 22)
    scale_outs: int = 0
    scale_ins: int = 0

    @classmethod
    def create(cls, ewma_alpha: float = 0.8, window: float = 1.0) -> "ModelTelemetry":
        return cls(sliding=SlidingRate(window), ewma=Ewma(ewma_alpha))

    def on_arrival(self, t_now: float) -> tuple[float, float]:
        """Record an arrival; return (sliding rate, updated EWMA rate)."""
        self.arrivals += 1
        lam = self.sliding.observe(t_now)
        lam_accum = self.ewma.update(lam)
        return lam, lam_accum


class MetricsRegistry:
    """The 'custom metric' export surface (paper §IV-D).

    In the paper this is scraped by Prometheus and surfaced to the k8s HPA
    via the prometheus-adapter. Here it is an in-process dict the simulated
    HPA reconciliation loop reads every 5 s — same interface, no sidecars.
    """

    def __init__(self):
        self._gauges: dict[str, float] = {}

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    def snapshot(self) -> dict[str, float]:
        return dict(self._gauges)

    def desired_replicas_key(self, model: str, instance: str) -> str:
        return f"desired_replicas/{model}/{instance}"
