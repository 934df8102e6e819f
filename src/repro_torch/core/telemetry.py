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

:data:`TRACER` records where the port's own host time goes: spans of
the admission flush's stages and of the serving engine's launches and
read-backs, with the flush's copy counters and the expert layers'
routing counters. It is off unless a caller enables it.
"""
from __future__ import annotations

import dataclasses
import time
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


@dataclasses.dataclass
class SpanRecords:
    """Spans as flat parallel lists: a span's id is its index. Times are
    ``time.perf_counter`` seconds (``end`` is NaN while a span is open);
    ``parent`` is the enclosing span's id, -1 at the top. The integer
    counters start at 0; ``graph`` is 1 on an ``engine.step`` that
    replayed the engine's CUDA graph; ``expert_*`` sum the expert layers
    an ``engine.generate`` (its prefill) or ``engine.step`` ran:
    launches (one a layer), rows routed, experts touched and the most
    rows on one expert; ``parallel_layers``, ``ssm_state_bytes`` and
    ``kv_bytes`` count, from the cache's shapes alone, the layers that
    run attention and a Mamba-2 mixer side by side, and the SSM state's
    and the attention rings' bytes the call streams (a step reads and
    writes every state and reads every ring whole; a prefill writes its
    rows' states and the prompt's keys and values)."""

    name: list = dataclasses.field(default_factory=list)
    start: list = dataclasses.field(default_factory=list)
    end: list = dataclasses.field(default_factory=list)
    parent: list = dataclasses.field(default_factory=list)
    rows: list = dataclasses.field(default_factory=list)
    padded_rows: list = dataclasses.field(default_factory=list)
    h2d_copies: list = dataclasses.field(default_factory=list)
    h2d_bytes: list = dataclasses.field(default_factory=list)
    d2h_copies: list = dataclasses.field(default_factory=list)
    d2h_bytes: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    graph: list = dataclasses.field(default_factory=list)
    expert_launches: list = dataclasses.field(default_factory=list)
    expert_rows: list = dataclasses.field(default_factory=list)
    expert_touched: list = dataclasses.field(default_factory=list)
    expert_max_rows: list = dataclasses.field(default_factory=list)
    parallel_layers: list = dataclasses.field(default_factory=list)
    ssm_state_bytes: list = dataclasses.field(default_factory=list)
    kv_bytes: list = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.name)


class Tracer:
    """In-memory spans and counters of the port's host work.

    A *scope* (``open`` / ``close``) is a call such as one flush or one
    decode step; a *stage* (``stage``) is one contiguous part of the
    innermost open scope: it ends that scope's open stage and starts the
    next, so consecutive stages never overlap and each is a child of the
    scope. A stage named like the open one continues it. Counters add to
    the innermost open scope. With no scope open, stages and counters
    are dropped.

    Every call site tests ``on`` first, so a tracer that is off costs one
    attribute read per site. ``enable`` starts recording from an empty
    stack; ``drain`` returns the records and starts new ones.
    """

    def __init__(self):
        self.on = False
        self.records = SpanRecords()
        self._scopes: list = []     # [scope id, its open stage id or -1]

    def enable(self) -> None:
        self._scopes = []
        self.on = True

    def disable(self) -> None:
        self.on = False

    def drain(self) -> SpanRecords:
        out, self.records = self.records, SpanRecords()
        self._scopes = []
        return out

    def _new(self, name: str, parent: int, t: float, rows: int = 0,
             steps: int = 0) -> int:
        rec = self.records
        sid = len(rec.name)
        rec.name.append(name)
        rec.start.append(t)
        rec.end.append(float("nan"))
        rec.parent.append(parent)
        rec.rows.append(rows)
        rec.padded_rows.append(0)
        rec.h2d_copies.append(0)
        rec.h2d_bytes.append(0)
        rec.d2h_copies.append(0)
        rec.d2h_bytes.append(0)
        rec.steps.append(steps)
        rec.graph.append(0)
        rec.expert_launches.append(0)
        rec.expert_rows.append(0)
        rec.expert_touched.append(0)
        rec.expert_max_rows.append(0)
        rec.parallel_layers.append(0)
        rec.ssm_state_bytes.append(0)
        rec.kv_bytes.append(0)
        return sid

    def open(self, name: str, rows: int = 0, steps: int = 0) -> int:
        """Start a scope inside the innermost open stage or scope;
        returns its id for ``close``."""
        parent = -1
        if self._scopes:
            top = self._scopes[-1]
            parent = top[1] if top[1] >= 0 else top[0]
        sid = self._new(name, parent, time.perf_counter(), rows, steps)
        self._scopes.append([sid, -1])
        return sid

    def close(self, sid: int) -> None:
        """End scope ``sid`` with its open stage, and any scope still
        open inside it."""
        end = self.records.end
        t = time.perf_counter()
        while self._scopes:
            scope, stage = self._scopes.pop()
            if stage >= 0:
                end[stage] = t
            end[scope] = t
            if scope == sid:
                return

    def stage(self, name: str) -> None:
        """End the innermost scope's open stage and start stage
        ``name``."""
        if not self._scopes:
            return
        top = self._scopes[-1]
        rec = self.records
        if top[1] >= 0 and rec.name[top[1]] == name:
            return
        t = time.perf_counter()
        if top[1] >= 0:
            rec.end[top[1]] = t
        top[1] = self._new(name, top[0], t)

    def end_stage(self) -> None:
        """End the innermost scope's open stage; the scope goes on."""
        if self._scopes and self._scopes[-1][1] >= 0:
            top = self._scopes[-1]
            self.records.end[top[1]] = time.perf_counter()
            top[1] = -1

    def pad(self, rows: int) -> None:
        """The innermost scope's rows as padded for a kernel launch."""
        if self._scopes:
            self.records.padded_rows[self._scopes[-1][0]] += rows

    def h2d(self, nbytes: int) -> None:
        """One host-to-device copy of ``nbytes``."""
        if self._scopes:
            rec, sid = self.records, self._scopes[-1][0]
            rec.h2d_copies[sid] += 1
            rec.h2d_bytes[sid] += nbytes

    def replayed(self) -> None:
        """The innermost scope replayed a captured CUDA graph."""
        if self._scopes:
            self.records.graph[self._scopes[-1][0]] += 1

    def experts(self, launches: int, rows: int, touched: int,
                max_rows: int) -> None:
        """The innermost scope's expert layers: ``launches`` of them,
        with their rows, experts touched and most rows on one expert
        summed."""
        if self._scopes:
            rec, sid = self.records, self._scopes[-1][0]
            rec.expert_launches[sid] += launches
            rec.expert_rows[sid] += rows
            rec.expert_touched[sid] += touched
            rec.expert_max_rows[sid] += max_rows

    def streams(self, parallel_layers: int, ssm_state_bytes: int,
                kv_bytes: int) -> None:
        """The innermost scope's parallel layers and the SSM-state and
        KV bytes it streams."""
        if self._scopes:
            rec, sid = self.records, self._scopes[-1][0]
            rec.parallel_layers[sid] += parallel_layers
            rec.ssm_state_bytes[sid] += ssm_state_bytes
            rec.kv_bytes[sid] += kv_bytes

    def d2h(self, nbytes: int) -> None:
        """One device-to-host copy of ``nbytes``."""
        if self._scopes:
            rec, sid = self.records, self._scopes[-1][0]
            rec.d2h_copies[sid] += 1
            rec.d2h_bytes[sid] += nbytes


#: the port's tracer: ``ControlPlane.flush``, the routing policies and
#: ``ServingEngine`` record into it while ``TRACER.on`` is set
TRACER = Tracer()
