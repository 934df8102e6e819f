"""The unified LA-IMR control plane.

:class:`ControlPlane` composes the shared decision core:

* a :class:`~repro_torch.control.policies.base.RoutingPolicyBase` strategy —
  batched scoring + selection over the (request x candidate) matrix (one
  batched-scorer or kernel call per window). Which *decision rule* runs
  is pluggable (``route_best`` / ``guarded_alg1`` / ``safetail`` /
  ``reliable`` / ``hybrid`` — the
  :mod:`repro_torch.control.policies` registry); the plane owns everything
  strategy-independent;
* :class:`~repro_torch.control.admission.AdmissionQueue` — window
  accumulation with quality-class priority ordering;
* the engine-slot binding cascade (winner -> feasible alternates ->
  upstream tier -> reject) with the generalised conservation contract
  ``admitted + offloaded + rejected + failed == arrivals``
  (``duplicate`` and ``retried`` outcomes from redundant dispatch /
  fault injection are accounted separately — see
  :meth:`check_conservation`, :meth:`mark_failed`);
* first-completion cancellation for redundant dispatch
  (:meth:`first_completion`) — the losers' engine slots are released
  exactly once (double release is a loud error in the slot providers);
* the PM-HPA coupling: :func:`hpa_refresh` pairs one batched telemetry
  decay/export with each reconcile tick.

The live serving engine (``repro_torch.serving.batch_router.BatchRouter``),
the multi-pod :class:`~repro_torch.control.fleet.FleetPlane`, and the
discrete-event simulator (``SimConfig.admission_window > 0``) are thin
adapters over this one object — the paper's "one calibrated model
drives routing AND capacity planning" made literal.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.control.admission import (ADMITTED, DUPLICATE, FAILED, OFFLOADED,
                                     REJECTED, RETRIED, AdmissionConfig,
                                     AdmissionDecision, AdmissionQueue)
from repro_torch.core.autoscaler import PMHPA
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.router import Router, RouterParams
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER


def hpa_refresh(router: Router, pmhpa: PMHPA, t_now: float,
                policy=None) -> list[int]:
    """One event-batched control-plane refresh per HPA tick: decay every
    deployment's EWMA toward its sliding rate and export all PM-HPA
    custom metrics in one batch, immediately before reconcile reads the
    gauges. The per-deployment float ops equal the old interleaved loop,
    so simulator golden digests are unchanged. Returns the exported
    desired-replica counts.

    ``policy``: a routing policy exposing ``scale_floor``
    (``BurstAdaptiveHybridPolicy``) may raise the freshly exported
    desired-replica gauges to a reactive floor so scale-out leads a
    detected burst. Applied HERE — after the batched export, before the
    caller's reconcile — because the export overwrites every gauge, so
    any inter-tick gauge write by a policy would be silently lost.
    ``policy=None`` (plain policies, scalar mode) is the digest-pinned
    no-op path."""
    exported = pmhpa.export_batch(router.refresh_telemetry(t_now))
    floor_of = getattr(policy, "scale_floor", None)
    if floor_of is not None:
        floors = floor_of(t_now)
        if floors:
            for dep in pmhpa.cluster:
                floor = floors.get(dep.key, 0)
                if floor <= 0:
                    continue
                mkey = pmhpa.metrics.desired_replicas_key(
                    dep.model.name, dep.instance.name)
                want = int(min(floor, dep.n_max))
                if want > pmhpa.metrics.get_gauge(mkey, dep.n_replicas):
                    pmhpa.metrics.set_gauge(mkey, want)
    return exported


class ControlPlane:
    """Admission-window batcher over a pluggable LA-IMR routing policy.

    Composes a :class:`Router` (telemetry, SLO budgets, upstream
    topology) and replaces its per-request ``route_best`` dispatch with
    one batched policy decision per window. ``engines`` maps deployment
    keys to slot providers
    (:class:`~repro_torch.control.admission.SlotBank`, a real
    ``ServingEngine``, or a :class:`~repro_torch.control.fleet.PodGroup`
    fronting several pods); deployments without an engine admit without
    slot accounting (pure routing mode — the discrete-event simulator
    runs this way, modelling queueing in its own replica pools).

    ``policy`` picks the strategy: a registry name, a strategy class, an
    instance, or None for ``config.policy`` (default ``route_best``).
    """

    def __init__(self, cluster: Cluster,
                 params: Optional[RouterParams] = None,
                 engines: Optional[dict] = None,
                 config: Optional[AdmissionConfig] = None,
                 router: Optional[Router] = None,
                 policy=None):
        # imported here: repro_torch.control.policies imports admission, and
        # module-level cross-imports would cycle through __init__.
        from repro_torch.control.policies import make_policy
        self.cluster = cluster
        self.router = router or Router(cluster, params or RouterParams())
        self.cfg = config or AdmissionConfig()
        self.engines = engines if engines is not None else {}
        self.policy = make_policy(policy, cluster, self.router, self.cfg)
        self.queue = AdmissionQueue(self.cfg.window, self.cfg.max_batch)
        self.flushes = 0
        self.scored_pairs = 0
        # generalised conservation ledger (see check_conservation)
        self.decided = 0
        self.outcomes = {ADMITTED: 0, OFFLOADED: 0, REJECTED: 0,
                         DUPLICATE: 0, FAILED: 0, RETRIED: 0}
        self.dup_dispatched = 0
        self.dup_cancelled = 0
        # redundant-dispatch groups with live engine slots, keyed by the
        # primary's req_id; _dup_member maps every copy's req_id to it.
        self._dup_groups: dict[int, list[AdmissionDecision]] = {}
        self._dup_member: dict[int, int] = {}

    # ------------------------------------------------------------------ #
    def pending(self) -> int:
        return self.queue.pending()

    def window_opened_at(self) -> Optional[float]:
        return self.queue.opened_at

    def submit(self, req: Request,
               t_now: float) -> Optional[list[AdmissionDecision]]:
        """Queue a request; flush and return decisions when the window
        closes (age > ``window`` or ``max_batch`` pending), else None."""
        if self.queue.push(req, t_now):
            return self.flush(t_now)
        return None

    def check_conservation(self) -> None:
        """Assert the generalised conservation contract over everything
        this plane has decided: every drained request got exactly one
        terminal outcome — ``admitted + offloaded + rejected + failed
        == arrivals`` — with duplicates and retries ledgered
        separately."""
        total = (self.outcomes[ADMITTED] + self.outcomes[OFFLOADED]
                 + self.outcomes[REJECTED] + self.outcomes[FAILED])
        if total != self.decided:
            raise AssertionError(
                f"conservation broken: admitted+offloaded+rejected+failed "
                f"== {total} != {self.decided} decided ({self.outcomes})")
        if self.outcomes[DUPLICATE] != self.dup_dispatched:
            raise AssertionError(
                f"duplicate ledger drifted: {self.outcomes[DUPLICATE]} "
                f"outcomes != {self.dup_dispatched} dispatched")
        # closed vocabulary: every ledger bucket must be one of the
        # declared outcome constants (incl. the auxiliary RETRIED
        # tally) — a bucket added elsewhere without extending this
        # contract is exactly the drift laimr-lint ledger-completeness
        # exists to catch, and this guard is its runtime twin.
        unknown = set(self.outcomes) - {ADMITTED, OFFLOADED, REJECTED,
                                        FAILED, DUPLICATE, RETRIED}
        if unknown:
            raise AssertionError(
                f"unledgered outcome bucket(s) {sorted(unknown)}: "
                "extend check_conservation before counting them")

    def mark_failed(self, *, offloaded: bool) -> None:
        """Fault injection settled a request as lost (crash past its
        retry budget, dropped link, stranded on a dead fleet): move its
        terminal outcome from the bucket it settled into at admission
        time to FAILED, keeping the conservation sum intact."""
        src = OFFLOADED if offloaded else ADMITTED
        if self.outcomes[src] <= 0:
            raise AssertionError(
                f"mark_failed: no {src} outcome to reclassify "
                f"({self.outcomes})")
        self.outcomes[src] -= 1
        self.outcomes[FAILED] += 1

    def mark_retried(self) -> None:
        """Ledger one fault-triggered re-dispatch (accounted separately,
        like DUPLICATE — the request keeps its single primary outcome)."""
        self.outcomes[RETRIED] += 1

    # ------------------------------------------------------------------ #
    def _take_slot(self, dep: Deployment,
                   cold: bool = False) -> tuple[bool, Optional[int]]:
        """(has capacity, slot) at ``dep`` — deployments without a
        registered engine always have capacity (pure routing mode).

        ``cold=True`` (redundant copies under ``placement="jsq"``) asks
        the engine for a slot on its COLDEST pod (``admit_coldest`` on
        :class:`~repro_torch.control.fleet.PodGroup`) instead of the first-fit
        slot: a duplicate racing its primary should land where queueing
        pressure is lowest, not on the same hot leading pod. Engines
        without pod structure fall back to ``admit_next``."""
        eng = self.engines.get(dep.key)
        if eng is None:
            return True, None
        if cold and self.cfg.placement == "jsq":
            admit_cold = getattr(eng, "admit_coldest", None)
            if admit_cold is not None:
                slot = admit_cold()
                return slot is not None, slot
        slot = eng.admit_next()
        return slot is not None, slot

    def _settle(self, req: Request, dep: Deployment, slot: Optional[int],
                t_now: float, predicted: float,
                offload: bool) -> AdmissionDecision:
        tel = self.router.tel(dep.key)
        tel.on_arrival(t_now)
        req.assigned_instance = dep.key
        req.offloaded = offload
        if offload:
            tel.offloaded_fast += 1
        return AdmissionDecision(req, OFFLOADED if offload else ADMITTED,
                                 dep.key, slot=slot,
                                 predicted_latency=predicted)

    def _bind(self, req: Request, dep: Deployment, t_now: float,
              predicted: float, *, offload: bool) -> AdmissionDecision:
        """Try the engine slot at ``dep``; cascade upstream; reject when
        every tier in the chain is saturated."""
        got, slot = self._take_slot(dep)
        if not got:
            up = self.cluster.upstream_of(dep)
            if up is not None and up.key != dep.key:
                return self._bind(req, up, t_now, predicted, offload=True)
            req.assigned_instance = None
            return AdmissionDecision(req, REJECTED, None,
                                     predicted_latency=predicted)
        return self._settle(req, dep, slot, t_now, predicted, offload)

    def flush(self, t_now: float) -> list[AdmissionDecision]:
        """Close the window: one batched policy decision over all
        pending requests — LOW_LATENCY lane first, FIFO within each
        lane — feeding engine slots. Redundant-dispatch policies append
        DUPLICATE decisions directly after their primaries."""
        reqs = self.queue.drain()
        if not reqs:
            return []
        sid = TRACER.open("admission.flush", rows=len(reqs)) \
            if TRACER.on else -1
        try:
            pol = self.policy
            dec = pol.decide(reqs, t_now)
            self.flushes += 1
            self.scored_pairs += dec.lam.shape[0] * dec.lam.shape[1]
            self.decided += len(reqs)

            if sid >= 0:
                TRACER.stage("admission.settle")
            deps = pol.deps
            out: list[AdmissionDecision] = []
            for r, req in enumerate(reqs):
                pred = float(dec.predicted[r])
                if bool(dec.feasible[r]):
                    d = self._place_feasible(req, r, int(dec.primary[r]),
                                             dec.lam, dec.slo, dec.mask,
                                             dec.g, pred, t_now)
                else:
                    d = self._bind(req, deps[int(dec.primary[r])], t_now,
                                   pred, offload=bool(dec.offload[r]))
                out.append(d)
                self.outcomes[d.outcome] += 1
                dups = dec.dup_row(r)
                if dups and d.outcome != REJECTED:
                    placed = self._dispatch_duplicates(req, d, dups,
                                                       dec.g, r, t_now)
                    # ledgered at EMISSION; _dispatch_duplicates counts at
                    # the slot grab — check_conservation compares the two
                    # independent tallies.
                    for d2 in placed:
                        self.outcomes[d2.outcome] += 1
                    out.extend(placed)
            return out
        finally:
            if sid >= 0:
                TRACER.close(sid)

    def _place_feasible(self, req: Request, r: int, primary: int,
                        lam: np.ndarray, slo: np.ndarray, mask: np.ndarray,
                        g: Optional[np.ndarray], pred: float,
                        t_now: float) -> AdmissionDecision:
        """Bind a feasible request: the §IV-B winner first; if its engine
        is full, the next-best FEASIBLE candidates in latency order; then
        the upstream tier; reject only when all of those are saturated.

        The fallback order is computed lazily — only when the primary's
        slot grab fails — so pure-routing windows (no engines) and
        uncontended flushes never pay for it. The Pallas backend returns
        no (R, I) score row; the overflow path re-scores the single row
        through the vmap scorer (rare, and only when engines exist)."""
        deps = self.policy.deps
        got, slot = self._take_slot(deps[primary])
        if got:
            return self._settle(req, deps[primary], slot, t_now,
                                pred, offload=False)
        g_row = g[r] if g is not None else self.policy.score_row(lam[r])
        feas = np.flatnonzero((g_row <= slo[r]) & mask[r])
        feas = feas[np.argsort(g_row[feas], kind="stable")]
        tried = [primary]
        for i in (int(i) for i in feas if int(i) != primary):
            got, slot = self._take_slot(deps[i])
            tried.append(i)
            if got:
                # any candidate here is SLO-feasible, so landing on an
                # alternate is still an admission, not an offload.
                return self._settle(req, deps[i], slot, t_now,
                                    float(g_row[i]), offload=False)
        up = self.cluster.upstream_of(deps[primary])
        if up is not None and up.key not in \
                (deps[i].key for i in tried):
            return self._bind(req, up, t_now, pred, offload=True)
        req.assigned_instance = None
        return AdmissionDecision(req, REJECTED, None,
                                 predicted_latency=pred)

    # ---------------- redundant dispatch (safetail) -------------------- #
    def _dispatch_duplicates(self, req: Request,
                             primary_dec: AdmissionDecision,
                             dup_idx: tuple, g: Optional[np.ndarray],
                             r: int, t_now: float
                             ) -> list[AdmissionDecision]:
        """Opportunistically place redundant copies: a duplicate takes a
        slot only if one is free at its target (no cascade — losing a
        duplicate costs nothing), registers real-slot groups for
        first-completion cancellation, and adds its arrival to the
        target's telemetry (duplicate load is real load). Under
        ``placement="jsq"`` the slot comes from the target's COLDEST
        pod (``_take_slot(cold=True)``) — SafeTail's whole point is a
        copy that avoids the straggling pod."""
        deps = self.policy.deps
        group: list[AdmissionDecision] = []
        for j in dup_idx:
            dep = deps[int(j)]
            if dep.key == primary_dec.target_key:
                continue        # never duplicate onto the primary's pool
            got, slot = self._take_slot(dep, cold=True)
            if not got:
                continue
            clone = Request(model=req.model, quality=req.quality,
                            arrival=req.arrival, slo=req.slo,
                            accuracy_req=req.accuracy_req)
            clone.assigned_instance = dep.key
            self.router.tel(dep.key).on_arrival(t_now)
            pred = float(g[r, int(j)]) if g is not None else 0.0
            group.append(AdmissionDecision(clone, DUPLICATE, dep.key,
                                           slot=slot,
                                           predicted_latency=pred,
                                           dup_of=req.req_id))
        if not group:
            return group
        self.dup_dispatched += len(group)
        members = [primary_dec] + group
        if any(d.slot is not None for d in members):
            self._dup_groups[req.req_id] = members
            for d in members:
                self._dup_member[d.req.req_id] = req.req_id
        return group

    def first_completion(self, req_id: int) -> list[AdmissionDecision]:
        """First-completion cancellation: the copy with ``req_id`` won
        its redundancy group — release every OTHER copy's engine slot
        (exactly once; the winner's slot stays with its caller) and
        return the cancelled decisions. A req_id without a live group is
        a no-op (single-dispatch policies, pure routing mode).

        Serving adapters MUST call this when a request's first copy
        completes (the simulator's event loop does it via duplicate
        groups): under a redundant policy, skipping it leaks the
        losers' engine slots and their group entries for the lifetime
        of the plane. ``examples/serve_cluster.py`` shows the
        completion pass."""
        gid = self._dup_member.get(req_id)
        if gid is None:
            return []
        members = self._dup_groups.pop(gid)
        cancelled: list[AdmissionDecision] = []
        for d in members:
            self._dup_member.pop(d.req.req_id, None)
            if d.req.req_id == req_id:
                continue
            if d.slot is not None:
                eng = self.engines.get(d.target_key)
                if eng is not None:
                    eng.release(d.slot)
            if d.outcome == DUPLICATE:
                self.dup_cancelled += 1
            cancelled.append(d)
        return cancelled
