"""Admission-window state: pending buffer, outcomes, slot providers.

This module owns the *bookkeeping* half of the shared control plane:
which requests are waiting for a decision, in what order a
closed window is decided, and what the three terminal outcomes of a
decision are. The *scoring* half lives in :mod:`repro_torch.control.policies`;
:class:`repro_torch.control.plane.ControlPlane` composes the two.

Window ordering (quality-class multi-queue, paper §IV-A)
--------------------------------------------------------
A window may mix quality classes. The paper's multi-queue scheduler
gives LOW_LATENCY strict dispatch priority over BALANCED over PRECISE,
so a flushed window is decided in **lane-priority order with per-lane
FIFO** — the exact :class:`~repro_torch.core.scheduler.MultiQueueScheduler`
semantics, which :class:`AdmissionQueue` reuses verbatim as its pending
buffer. Within a single-quality window this reduces to arrival order
(stable), so the single-quality serving behaviour is unchanged.

Conservation contract (property-tested, generalised for redundancy)
-------------------------------------------------------------------
Every submitted request resolves to exactly one *primary* outcome:

* ``ADMITTED``  — bound to a free slot of its target's engine (or to the
  target itself when no engine is registered: pure routing mode);
* ``OFFLOADED`` — sent to the upstream tier, either because no candidate
  was SLO-feasible (``route_best`` semantics), because the policy's
  per-request guard fired (``guarded_alg1``), or because the feasible
  target's engine was full;
* ``REJECTED``  — no feasible engine slot anywhere.

``admitted + offloaded + rejected == arrivals`` and a flush never admits
past the registered engines' free slots. Redundant-dispatch policies
(``safetail``) additionally emit ``DUPLICATE`` decisions — opportunistic
extra copies that occupy real slots but are accounted SEPARATELY: they
never enter the primary triple, and first-completion cancellation
releases their slots (double release is a loud error, never silent
slot-count drift).

Fault injection extends the contract: a request whose settled
copy is destroyed past its retry budget moves from its original bucket
to ``FAILED`` (``ControlPlane.mark_failed``), so the invariant becomes
``admitted + offloaded + rejected + failed == arrivals``; ``RETRIED``
tallies re-dispatches separately, exactly like ``DUPLICATE``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.scheduler import MultiQueueScheduler, Request

ADMITTED = "admitted"
OFFLOADED = "offloaded"
REJECTED = "rejected"
DUPLICATE = "duplicate"
# fault-extended terminal outcomes: a FAILED request was
# admitted/offloaded but never completed (pod crash past the retry
# budget, link drop with on_drop="fail", stranded on a dead fleet);
# RETRIED counts re-dispatches and, like DUPLICATE, never enters the
# primary conservation sum.
FAILED = "failed"
RETRIED = "retried"


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs of the admission-window loop (shared by every adapter).

    ``window`` is the batching horizon in seconds: a pending request is
    held at most this long before its window is flushed (larger window =
    more amortisation, more decision staleness). ``max_batch`` flushes
    early under burst so the decision matrix stays bounded. ``backend``
    selects the scoring path: ``"vmap"`` (the batched torch
    ``score_instances_batch`` with the exact Erlang-C recurrence, the
    default and the semantics reference), ``"cuda"`` (the hand-written
    CUDA decision kernels, one launch per window) or ``"ref"`` (the
    plain torch versions of those kernels, on any device). The fused
    paths take per-request SLO rows and lane masks natively (folded into
    the kernel's (R, I) SLO input). ``device`` is the torch device the
    decision tensors live on: ``"cuda"`` unless the caller asks for the
    CPU. ``backend="cuda"`` on a CPU device raises — there is no hidden
    fallback.

    ``policy`` names the routing strategy in the
    :mod:`repro_torch.control.policies` registry (``route_best`` /
    ``guarded_alg1`` / ``safetail`` / ``reliable``); ``redundancy`` is
    the TOTAL copy count (primary included) a redundant-dispatch policy
    may fan a request out to — single-dispatch policies ignore it.

    Reliability knobs (consumed by the ``reliable`` policy):
    ``latency_sigma`` is the baseline lognormal log-dispersion of
    realised latency around the point estimate; ``link_jitter`` adds
    per-tier dispersion and ``link_loss`` per-tier delivery-loss
    probability (tier name -> value), together feeding the closed-form
    SLO-attainment score; ``headroom_margin`` gates SafeTail-style
    duplication — a duplicate is dispatched only onto candidates with
    ``g <= slo - headroom_margin``, so redundancy is bought only when
    the SLO leaves room to pay for it.

    Placement: ``placement`` selects the pod-placement mode
    shared by :class:`~repro_torch.control.fleet.PodGroup` and the
    simulator's ``_PodFleet`` — ``"first_fit"`` (default, digest-
    pinned) or ``"jsq"`` (join-shortest-queue with cold-pod duplicate
    pinning and finish-time work stealing).

    Burst detection (consumed by the ``hybrid`` policy):
    ``burst_memory`` is the time constant (seconds) of the long-horizon
    EWMA arrival rate the detector compares against; a burst is entered
    when the in-window rate exceeds ``burst_enter`` times the EWMA (and
    at least ``burst_min_rate`` req/s in absolute terms) and exited
    only when it falls below ``burst_exit`` times the EWMA — the
    enter/exit gap is the hysteresis band that stops strategy flapping
    on oscillating traffic (pinned on the MMPP trace).
    """

    window: float = 0.05
    max_batch: int = 256
    backend: str = "vmap"
    device: str = "cuda"
    block_r: int = 256
    erlang_table_size: int = 65
    policy: str = "route_best"
    redundancy: int = 2
    latency_sigma: float = 0.25
    link_loss: dict[str, float] = dataclasses.field(default_factory=dict)
    link_jitter: dict[str, float] = dataclasses.field(default_factory=dict)
    headroom_margin: float = 0.25
    placement: str = "first_fit"
    burst_memory: float = 8.0
    burst_enter: float = 2.0
    burst_exit: float = 1.25
    burst_min_rate: float = 2.0


@dataclasses.dataclass
class AdmissionDecision:
    req: Request
    outcome: str                # ADMITTED | OFFLOADED | REJECTED | DUPLICATE
    target_key: Optional[str]   # deployment the request was bound to
    slot: Optional[int] = None  # engine slot (None in pure routing mode)
    predicted_latency: float = 0.0
    # redundant dispatch: req_id of the primary this decision duplicates
    # (DUPLICATE outcomes only; the primary's own decision has None)
    dup_of: Optional[int] = None


class AdmissionQueue:
    """Pending-window buffer with quality-class priority ordering.

    Requests accumulate in a :class:`MultiQueueScheduler` (strict
    priority, per-lane FIFO). :meth:`push` reports whether the window
    must flush (age > ``window`` or ``max_batch`` pending);
    :meth:`drain` empties the buffer in decision order.
    """

    def __init__(self, window: float, max_batch: int) -> None:
        self.window = float(window)
        self.max_batch = int(max_batch)
        self._sched = MultiQueueScheduler()
        self._opened: Optional[float] = None
        self._n = 0    # pending count, tracked off the submit hot path

    @property
    def opened_at(self) -> Optional[float]:
        """Time the current window opened (None when empty)."""
        return self._opened

    def pending(self) -> int:
        return self._n

    def push(self, req: Request, t_now: float) -> bool:
        """Buffer ``req``; True when the window is due for a flush."""
        if self._opened is None:
            self._opened = t_now
        self._sched.enqueue(req)
        self._n += 1
        return (self._n >= self.max_batch
                or t_now - self._opened >= self.window)

    def drain(self) -> list[Request]:
        """Close the window: all pending requests, LOW_LATENCY lane
        first, FIFO within each lane."""
        self._opened = None
        self._n = 0
        return list(self._sched.drain())


class SlotBank:
    """Minimal slot tracker with ``ServingEngine``'s admission surface.

    The control plane only needs ``free_slots`` / ``admit_next`` /
    ``release``; binding a real :class:`~repro_torch.serving.engine.ServingEngine`
    gives the same interface backed by actual decode slots, while this
    class models replica capacity in simulations and property tests
    without instantiating model parameters.

    Releases are HARDENED for redundant dispatch: first-completion
    cancellation means a slot can have two would-be releasers (the
    completing copy's owner and the cancellation path), and silently
    tolerating the second release would drift the free-slot count one
    admission high forever. Double release raises instead.
    """

    def __init__(self, slots: int) -> None:
        self.slots = slots
        self.active = np.zeros((slots,), bool)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if not self.active[i]]

    def n_free(self) -> int:
        return int((~self.active).sum())

    def admit_next(self, first_token: int = 0,
                   start_pos: int = 0) -> Optional[int]:
        for i in range(self.slots):
            if not self.active[i]:
                self.active[i] = True
                return i
        return None

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise IndexError(f"SlotBank.release({slot}): no such slot "
                             f"(0..{self.slots - 1})")
        if not self.active[slot]:
            raise RuntimeError(
                f"SlotBank.release({slot}): slot already free — double "
                "release (e.g. of a cancelled duplicate) would silently "
                "drift the slot count")
        self.active[slot] = False
