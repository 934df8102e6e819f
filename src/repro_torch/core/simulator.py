"""Discrete-event cluster simulator (paper §V experiment substrate).

Replaces the paper's shared Kubernetes cluster with a seeded,
reproducible event loop that keeps the k8s semantics that matter:

* replica pools per deployment with a central FIFO queue each
  (the scheduler's lanes bind requests to pools; within a pool, FIFO);
* pod start-up delay (1.8 s on the paper's ARM64 edge, §V-A2) between a
  scale-out decision and the replica accepting work;
* graceful termination: scale-in marks a replica draining — it finishes
  in-flight work and is removed only when idle (§IV-D step iii);
* HPA reconciliation every 5 s reading the custom metric (§IV-D);
* network RTT per tier added to each request's end-to-end latency.

Service-time model: when a replica begins serving, the service time is
drawn from the utilisation law (Eq. 5)

    S = (L_m / S_mi) * (1 + U^gamma_rt) * LogNormal(0, sigma)

with U the instantaneous pool utilisation (Eq. 6) from the pool's 1-s
sliding arrival rate. gamma_rt defaults to the paper's runtime value 0.9
(§V-A4). Queueing delay is NOT sampled — it *emerges* from the event
loop, so the Erlang-C term of the analytic model can be validated
against, rather than baked into, the simulation.

Two controller modes:
* ``laimr``    — Router (Algorithm 1) + PM-HPA custom-metric autoscaling.
* ``baseline`` — static binding (no offload) + reactive latency-threshold
                 autoscaler with its 60-120 s decision lag.

Unified control plane: with
``SimConfig.admission_window > 0`` the laimr mode stops deciding per
arrival and instead accumulates arrivals into admission windows routed
through the SAME vectorised :class:`repro_torch.control.plane.ControlPlane`
the serving engine uses — one batched policy decision per window,
quality-priority ordering. ``SimConfig.policy`` picks the strategy from
the :mod:`repro_torch.control.policies` registry (``route_best`` cross-tier
argmin, ``guarded_alg1`` home tier + Algorithm-1 offload guard,
``safetail`` top-k redundant dispatch whose duplicate copies this event
loop races and cancels on first completion). ``admission_window == 0``
(default) keeps the scalar per-arrival path bit-identical to the golden
digests; ``benchmarks/bench_window_sweep.py`` measures window width,
``benchmarks/bench_policy_matrix.py`` the policy x burst matrix.

Fleet-scale fast path: the event loop is O(log n) per event — O(1)
idle-replica free-list per pool, deque FIFOs, cached per-pool service
constants, memoised home-tier binding, and scalar bit-identical twins of
the control-plane predictors (see ``queueing.mmc_wait_scalar``,
``router.score_instance_scalar``, ``autoscaler.desired_replicas``).
Refactors here must keep the golden digests in
``tests/test_sim_golden.py`` bit-identical per seed;
``benchmarks/bench_sim_throughput.py`` is the speed baseline
(>=1M arrivals end-to-end).

Pod-level fleet physics: ``SimConfig.pods_per_deployment > 1``
partitions each deployment's replicas into whole PODS — the same
``FleetPlane``/``PodGroup`` granularity the serving engine runs
(``repro/control/fleet.py``) — so the simulator finally exercises pod
spillover, pod boot lag and pod-granular scale enactment instead of one
monolithic pool per deployment:

* each pod is its own :class:`_Pool` (replica slots, FIFO queue, 1-s
  sliding arrival rate feeding the Eq. 5 utilisation — per-POD, so a hot
  pod runs slow while its neighbours idle);
* arrivals bind first-fit: the first pod (creation order) with an idle
  replica serves immediately — ``PodGroup.admit_next`` semantics; when
  every pod is busy the request spills to the shortest-queue pod and
  STAYS there (sticky per-pod FIFO — the load-balancer imbalance that
  shapes the tail at pod granularity);
* PM-HPA still plans in replicas, but enactment is pod-granular:
  scale-out boots whole pods of ``slots_per_pod`` replicas after
  ``startup_delay``; a freshly ready pod immediately steals queued work
  from the most backlogged pods. Scale-in drains the EMPTIEST pod
  (fewest busy replicas, then shortest queue, newest on ties): its
  queue respills to the survivors — cancel-aware, so a cancelled
  SafeTail duplicate queued on a draining pod is dropped, never
  resurrected — busy replicas finish in flight, and the pod object is
  removed when idle (releasing into it afterwards is a loud error).

``pods_per_deployment == 1`` (default) keeps the single-``_Pool``
legacy path byte-for-byte — the golden digests above AND the windowed
digests in ``tests/test_control_plane.py`` are pinned against it, and
``tests/test_sim_golden.py`` pins a multi-pod digest so future
spillover-physics changes are loud. ``benchmarks/bench_policy_matrix.py``
sweeps the pods axis.

Fault injection: ``SimConfig.faults`` carries a seeded
:class:`FaultPlan` — scheduled :class:`PodCrash` events (a pod dies
mid-service: in-flight work is re-admitted or failed per policy, queued
work respills cancel-aware, a replacement boots after
``startup_delay``), :class:`Straggler` windows (per-pod service-time
multipliers) and per-tier network-drop probabilities (an offload times
out and is retried at the same target or failed). Every hook is
flag-guarded and drop randomness lives in a separate RNG stream, so the
default empty plan is bit-identical to all pinned digests; failures
extend conservation to ``completed + failed == arrivals`` (mirrored in
the control-plane ledger as ``admitted + offloaded + rejected + failed
== arrivals``), property-tested per policy in ``tests/test_faults.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Literal, Optional

import numpy as np

from repro_torch.core.autoscaler import PMHPA, ReactiveAutoscaler, ScaleEvent
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.router import Action, Router, RouterParams
from repro_torch.core.scheduler import MultiQueueScheduler, Request
from repro_torch.core.telemetry import MetricsRegistry, SlidingRate
from repro_torch.core.workload import Arrival

Mode = Literal["laimr", "baseline"]

# event kinds, ordered for deterministic tie-breaking
_ARRIVAL, _SERVICE_END, _REPLICA_READY, _HPA_TICK, _WINDOW_FLUSH, \
    _FAULT, _RETRY = 0, 1, 2, 3, 4, 5, 6


@dataclasses.dataclass(frozen=True)
class PodCrash:
    """One scheduled hard pod kill.

    At ``t`` the pod dies mid-service: its in-flight requests are
    re-admitted or failed per ``FaultPlan.on_crash``, its queued work
    respills through the cancel-aware drain path, and — when
    ``restart`` — a replacement pod boots after the deployment's
    ``startup_delay`` (k8s rescheduling semantics). ``pod_id`` None
    kills the first active pod at ``t``; in legacy single-pool mode
    the whole replica set of the deployment is the "pod"."""

    t: float
    dep_key: str
    pod_id: Optional[int] = None
    restart: bool = True


@dataclasses.dataclass(frozen=True)
class Straggler:
    """A straggling replica window: every service STARTED on the
    matching pod(s) of ``dep_key`` within [t_start, t_end) runs
    ``factor`` times slower (per-pod service-time multiplier — the
    degraded-node regime, not a crash)."""

    t_start: float
    t_end: float
    dep_key: str
    pod_id: Optional[int] = None   # None -> every pod of the deployment
    factor: float = 4.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule for one simulation run.

    The plan is pure data: crashes and straggler windows fire at fixed
    times; network drops are drawn per offloaded dispatch from a
    SEPARATE ``default_rng((SimConfig.seed, FaultPlan.seed))`` stream,
    so fault randomness never perturbs the service-time stream — an
    empty plan is bit-identical to a fault-free run (the golden-digest
    wall pins this). ``drop_prob`` maps an instance tier ("cloud",
    "edge") to the per-dispatch loss probability of offloads INTO that
    tier; a dropped dispatch times out for ``drop_timeout`` seconds and
    is then retried at the same target (``on_drop="retry"``, up to
    ``max_retries`` total retries per request, shared with crash
    re-admissions) or failed outright. ``on_crash`` decides the fate of
    requests that were mid-service on a crashed pod."""

    crashes: tuple = ()
    stragglers: tuple = ()
    drop_prob: dict = dataclasses.field(default_factory=dict)
    drop_timeout: float = 1.0
    on_crash: str = "retry"        # "retry" | "fail"
    on_drop: str = "retry"         # "retry" | "fail"
    max_retries: int = 2
    seed: int = 0

    def empty(self) -> bool:
        return not (self.crashes or self.stragglers
                    or any(p > 0.0 for p in self.drop_prob.values()))


@dataclasses.dataclass
class _Replica:
    rid: int
    busy: bool = False
    draining: bool = False


class _Pool:
    """Runtime state of one replica pool — a whole deployment in the
    legacy single-pool mode, or ONE POD of a :class:`_PodFleet` when
    ``SimConfig.pods_per_deployment > 1``.

    Fleet-scale fast path: the idle-replica lookup is O(1) amortised via a
    min-heap free-list of idle rids with lazy invalidation (rids are
    assigned in increasing order, so heap-min == first idle replica in
    creation order — the exact replica the seed's linear scan returned),
    the FIFO queue is a deque (list.pop(0) was O(n)), ``n_ready`` is an
    incrementally maintained counter, and the Eq. 5 service-time constants
    are cached once per pool instead of chased through four attribute
    lookups per service start.
    """

    __slots__ = ("dep", "replicas", "_rid", "queue", "rate", "pending_up",
                 "_idle", "_n_ready", "svc_base", "svc_r_demand",
                 "svc_background", "svc_r_max", "net_rtt", "pod_id",
                 "draining")

    def __init__(self, dep: Deployment, n_replicas: Optional[int] = None,
                 pod_id: int = 0):
        n = dep.n_replicas if n_replicas is None else n_replicas
        self.dep = dep
        self.pod_id = pod_id
        self.draining = False     # pod-level drain flag (fleet mode only)
        self.replicas: dict[int, _Replica] = {
            i: _Replica(rid=i) for i in range(n)
        }
        self._rid = itertools.count(n)
        self.queue: deque[Request] = deque()
        self.rate = SlidingRate(window=1.0)
        self.pending_up: int = 0  # replicas booting
        self._idle: list[int] = list(range(n))  # already a heap
        self._n_ready: int = n
        # cached Eq. 5 constants (values identical to the attribute chains)
        self.svc_base = dep.model.l_ref / dep.instance.speedup
        self.svc_r_demand = dep.model.r_demand
        self.svc_background = dep.instance.background
        self.svc_r_max = dep.instance.r_max
        self.net_rtt = dep.instance.net_rtt

    @property
    def n_ready(self) -> int:
        return self._n_ready

    def add_replica(self) -> _Replica:
        rid = next(self._rid)
        rep = _Replica(rid=rid)
        self.replicas[rid] = rep
        heapq.heappush(self._idle, rid)
        self._n_ready += 1
        return rep

    def mark_draining(self, rep: _Replica) -> None:
        """Flag for graceful termination; idle replicas leave immediately
        (their stale free-list entry is discarded lazily).

        Re-marking an already-draining replica is a no-op: scale-in can
        re-select a busy draining replica as a victim on a later
        reconcile, and decrementing the ready-count again would corrupt
        it permanently (the seed's recount property was naturally
        idempotent; the counter must be guarded)."""
        if rep.draining:
            return
        rep.draining = True
        self._n_ready -= 1
        if not rep.busy:
            del self.replicas[rep.rid]

    def release(self, rep: _Replica) -> None:
        """Return a replica to the free-list after a service completes.

        Hardened (mirrors ``SlotBank``/``PodGroup``): releasing a replica
        that is not busy — a double release, e.g. of a cancelled SafeTail
        copy whose slot was already given back, or of a replica on a
        drained/removed pod — would push a second free-list entry and
        silently let the replica serve two requests at once. Loud error
        instead."""
        if not rep.busy:
            raise RuntimeError(
                f"_Pool.release(rid={rep.rid}): replica already free — "
                "double release would corrupt the idle free-list")
        rep.busy = False
        heapq.heappush(self._idle, rep.rid)

    def idle_replica(self) -> Optional[_Replica]:
        """Peek the idle replica the seed's linear scan would return,
        discarding free-list entries invalidated by drain/removal."""
        heap = self._idle
        while heap:
            rep = self.replicas.get(heap[0])
            if rep is not None and not rep.busy and not rep.draining:
                return rep
            heapq.heappop(heap)
        return None

    def pop_idle(self) -> Optional[_Replica]:
        rep = self.idle_replica()
        if rep is not None:
            heapq.heappop(self._idle)
        return rep

    def sync_dep(self) -> None:
        """Keep Deployment.n_replicas (the control-plane view) in sync.

        Reports the TRUE ready count, including 0 when every replica is
        gone (crash fault): the old ``max(1, n)`` floor made the
        router/PM-HPA predictors see one phantom replica and keep
        routing into a dead deployment. The Erlang inputs are
        degenerate-safe at c == 0 (``mmc_wait_scalar`` / ``ErlangMemo``
        return inf, the scorers return BIG), so truth-telling simply
        makes a dead deployment infeasible — pinned by the
        crash-all-pods regression test in tests/test_faults.py. For any
        live pool (n >= 1) this is bit-identical to the old floor."""
        self.dep.n_replicas = self._n_ready

    def n_busy(self) -> int:
        return sum(1 for r in self.replicas.values() if r.busy)

    def lifecycle(self) -> str:
        """Pod lifecycle flag for stats rows (fleet mode). A drained
        pod object is deleted outright, so only active/draining appear
        here; ``PodGroup.stats`` adds "retired" on the serving side."""
        return "draining" if self.draining else "active"

    def stats(self) -> tuple[int, int, int, str]:
        """(busy, ready, queued, lifecycle) — pod occupancy telemetry.
        ``lifecycle`` marks pods whose capacity must not be counted as
        admittable (draining pods finish in-flight work only)."""
        return (self.n_busy(), self._n_ready, len(self.queue),
                self.lifecycle())


class _PodFleet:
    """Per-pod pools behind one deployment — the simulator's twin of
    :class:`repro_torch.control.fleet.PodGroup`.

    ``slots_per_pod`` replicas per pod (ceil(n_replicas / pods) at
    construction), first-fit admission in pod-creation order, sticky
    shortest-queue spillover when saturated, pod-granular scale
    enactment. Pods are :class:`_Pool` objects, so the Eq. 5 service
    physics (per-pod sliding rate -> utilisation) and the O(1) idle
    free-list are reused verbatim; this class owns only the fleet
    topology and the boot/drain lifecycle. The module docstring
    documents the physics contract; ``control/README.md`` the
    serving-side mirror.
    """

    __slots__ = ("dep", "net_rtt", "slots_per_pod", "pods", "_pod_id",
                 "pending_pods", "pods_booted", "pods_drained", "parked",
                 "placement")

    def __init__(self, dep: Deployment, n_pods: int,
                 placement: str = "first_fit"):
        if placement not in ("first_fit", "jsq"):
            raise ValueError(
                f"unknown placement {placement!r} "
                "(expected 'first_fit' or 'jsq')")
        self.dep = dep
        self.placement = placement
        self.net_rtt = dep.instance.net_rtt
        self.slots_per_pod = max(1, -(-dep.n_replicas // max(1, n_pods)))
        self._pod_id = itertools.count()
        # insertion order == pod_id order == first-fit order
        self.pods: dict[int, _Pool] = {}
        remaining = dep.n_replicas
        while remaining > 0:
            take = min(self.slots_per_pod, remaining)
            self._new_pod(take)
            remaining -= take
        self.pending_pods = 0    # whole pods booting
        self.pods_booted = 0
        self.pods_drained = 0
        # requests stranded while NO pod is alive (crash fault): they
        # wait here until a replacement boots, or fail at end of run
        self.parked: deque[Request] = deque()

    def _new_pod(self, n_replicas: int) -> _Pool:
        pid = next(self._pod_id)
        pod = _Pool(self.dep, n_replicas=n_replicas, pod_id=pid)
        self.pods[pid] = pod
        return pod

    # ---- control-plane view ------------------------------------------- #
    @property
    def n_ready(self) -> int:
        return sum(p._n_ready for p in self.pods.values())

    def n_active_pods(self) -> int:
        return sum(1 for p in self.pods.values() if not p.draining)

    def sync_dep(self) -> None:
        """Deployment.n_replicas (what the router/PM-HPA predictors see)
        is the READY aggregate over all pods — draining pods' replicas
        already left the count via ``_Pool.mark_draining``. The TRUE
        count is reported, 0 included: when fault injection kills every
        pod the predictors must see a dead deployment (infeasible,
        Erlang inputs degenerate-safe), not one phantom replica that
        keeps attracting traffic. Bit-identical to the old
        ``max(1, n)`` floor whenever any pod is alive."""
        self.dep.n_replicas = self.n_ready

    def stats(self) -> list[tuple[int, int, int, str]]:
        """Per-pod (busy, ready, queued, lifecycle) — the spillover
        telemetry ``FleetPlane.fleet_stats`` exposes on the serving
        side. Rows flagged "draining" hold no admittable capacity."""
        return [p.stats() for p in self.pods.values()]

    # ---- admission: placement-mode dispatch --------------------------- #
    def submit(self, sim: "ClusterSimulator", req: Request) -> None:
        """Pod placement (``PodGroup.admit_next`` semantics, both modes).

        ``placement="first_fit"`` (default, digest-pinned): the first
        non-draining pod with an idle replica serves immediately; with
        every slot busy the request joins the SHORTEST queue among
        active pods (ties -> fewest busy, then oldest pod) and stays
        there.

        ``placement="jsq"``: join-shortest-queue by ``(queued, busy)``
        occupancy — an idle slot on the COLDEST pod (fewest busy
        replicas) wins over first-fit order, and queueing picks the
        least-occupied pod, so one hot pod can no longer build a queue
        while its neighbours idle (the pods=2 flash-P99 regression the
        first-fit matrix surfaced).

        Either way the chosen pod's sliding rate observes the arrival —
        per-pod load feeds the per-pod Eq. 5 utilisation."""
        self._place(sim, req, observe=True)

    def _respill(self, sim: "ClusterSimulator", req: Request) -> None:
        """Re-home a request off a draining pod: same placement as
        :meth:`submit` but with no second rate observation — its arrival
        was already counted."""
        self._place(sim, req, observe=False)

    def _place(self, sim: "ClusterSimulator", req: Request,
               observe: bool) -> None:
        now = sim._now
        if self.placement == "jsq":
            idle = [p for p in self.pods.values()
                    if not p.draining and p.idle_replica() is not None]
            if idle:
                # coldest pod with a free slot: fewest busy replicas,
                # ties -> oldest pod (deterministic)
                pod = min(idle, key=lambda p: (p.n_busy(), p.pod_id))
                if observe:
                    pod.rate.observe(now)
                sim._start_service(pod, req)
                return
        else:
            for pod in self.pods.values():
                if not pod.draining and pod.idle_replica() is not None:
                    if observe:
                        pod.rate.observe(now)
                    sim._start_service(pod, req)
                    return
        # Every slot busy: join the shortest queue by (queued, busy,
        # pod_id). The busy tie-break is live in BOTH modes — at spill
        # time every active pod's replicas are all busy, so for
        # equal-size pods (every golden fleet scenario) it is a provable
        # no-op vs the old (queued, pod_id) key, while unequal remainder
        # pods now break queue-length ties toward the pod with fewer
        # in-flight requests instead of raw creation order.
        pod = min((p for p in self.pods.values() if not p.draining),
                  key=lambda p: (len(p.queue), p.n_busy(), p.pod_id),
                  default=None)
        if pod is None:
            # fault injection can kill every pod: park the request — a
            # booting replacement (on_ready) or the end-of-run sweep
            # settles it, so conservation never leaks
            self.parked.append(req)
            return
        if observe:
            pod.rate.observe(now)
        pod.queue.append(req)

    # ---- service completion ------------------------------------------- #
    def finish(self, sim: "ClusterSimulator", pod_id: int,
               rid: int) -> None:
        """Release the serving replica and dispatch this pod's next live
        queued request. On a draining pod the replica is removed instead
        (graceful termination); the pod object itself is removed once
        its last replica leaves. HARDENED end to end: every service
        start produces exactly one service end, so a finish targeting a
        removed pod or replica is a double release — loud, never a
        silent return (the drain path would otherwise swallow exactly
        the slot-drift class ``_Pool.release`` guards against)."""
        pod = self.pods.get(pod_id)
        if pod is None:
            raise RuntimeError(
                f"_PodFleet.finish({self.dep.key}, pod={pod_id}, "
                f"rid={rid}): pod was drained and removed — a release "
                "into a scaled-in pod cannot resurrect its slot")
        rep = pod.replicas.get(rid)
        if rep is None:
            raise RuntimeError(
                f"_PodFleet.finish({self.dep.key}, pod={pod_id}, "
                f"rid={rid}): replica already removed — double release "
                "on a draining pod")
        if rep.draining:
            rep.busy = False
            del pod.replicas[rid]
            if not pod.replicas:
                del self.pods[pod_id]
                self.pods_drained += 1
            self.sync_dep()
            return
        pod.release(rep)
        if pod.queue and pod.idle_replica() is not None:
            nxt = sim._pop_queued(pod)
            if nxt is not None:
                sim._start_service(pod, nxt)
        if self.placement == "jsq":
            self._steal_into(sim, pod)

    def _steal_into(self, sim: "ClusterSimulator", pod: _Pool) -> None:
        """Work-stealing (``placement="jsq"`` only): a pod that drained
        its own queue pulls queued work from the most backlogged sibling
        instead of idling — sticky queues are exactly how one hot pod
        held the P99 hostage under first-fit. Cancel-aware like every
        drain path: ``_pop_queued`` returning None means the donor held
        only cancelled SafeTail copies, so rescan (same loop shape as
        the boot-time steal in :meth:`on_ready`)."""
        while not pod.draining and pod.idle_replica() is not None:
            donor = max((p for p in self.pods.values()
                         if p.queue and p.pod_id != pod.pod_id),
                        key=lambda p: (len(p.queue), -p.pod_id),
                        default=None)
            if donor is None:
                break
            nxt = sim._pop_queued(donor)
            if nxt is None:
                continue     # donor held only cancelled copies; rescan
            sim._start_service(pod, nxt)

    # ---- boot / drain lifecycle --------------------------------------- #
    def on_ready(self, sim: "ClusterSimulator") -> None:
        """A whole pod finished booting: materialise ``slots_per_pod``
        fresh replicas and immediately steal queued work from the most
        backlogged pods — scale-out must relieve EXISTING backlog, not
        just future arrivals (sticky queues would otherwise strand it)."""
        self.pending_pods = max(0, self.pending_pods - 1)
        pod = self._new_pod(self._boot_size())
        self.pods_booted += 1
        self.sync_dep()
        while self.parked:
            # work stranded while no pod was alive goes first (fault
            # injection only; cancel-aware like every drain path)
            rq = self.parked.popleft()
            if rq.req_id in sim._cancelled:
                sim._cancelled.discard(rq.req_id)
                sim._dup_resolve(sim._dup_member.get(rq.req_id, -1))
                continue
            self._respill(sim, rq)
        while pod.idle_replica() is not None:
            donor = max((p for p in self.pods.values()
                         if p.queue and p.pod_id != pod.pod_id),
                        key=lambda p: (len(p.queue), -p.pod_id),
                        default=None)
            if donor is None:
                break
            nxt = sim._pop_queued(donor)
            if nxt is None:
                continue     # donor held only cancelled copies; rescan
            sim._start_service(pod, nxt)

    def _boot_size(self) -> int:
        """Replica count of the pod materialising right now.
        ``first_fit`` boots whole ``slots_per_pod`` pods (digest-pinned
        first-fit physics). ``jsq`` is pod-aware about the replica QUOTA too:
        the boot is clamped to the remaining ``n_max`` headroom, so the
        fleet can land on ``n_max`` exactly instead of stranding the
        last partial pod's worth of capacity (the multi-pod tail
        regression's root cause — see :meth:`apply_scale`)."""
        if self.placement == "jsq":
            return max(1, min(self.slots_per_pod,
                              self.dep.n_max - self.n_ready))
        return self.slots_per_pod

    def mark_pod_draining(self, sim: "ClusterSimulator",
                          pod: _Pool) -> None:
        """Graceful pod termination: queued work respills to the
        survivors (cancel-aware — a cancelled SafeTail duplicate queued
        here is dropped for good, it cannot resurrect on another pod),
        idle replicas leave immediately, busy ones finish in flight, and
        the pod object is removed once empty."""
        if pod.draining:
            return
        pod.draining = True
        while pod.queue:
            nxt = sim._pop_queued(pod)
            if nxt is None:
                break
            self._respill(sim, nxt)
        for rep in list(pod.replicas.values()):
            pod.mark_draining(rep)
        if not pod.replicas:
            del self.pods[pod.pod_id]
            self.pods_drained += 1
        self.sync_dep()

    def crash_pod(self, sim: "ClusterSimulator", crash: PodCrash) -> bool:
        """Hard pod kill: the pod vanishes NOW. In-flight
        services die with it — their scheduled service-end events are
        voided, so a later finish into this pod raises (the same
        no-slot-resurrection guard as a drained pod) — and the victims
        are re-admitted or failed per ``FaultPlan.on_crash``. Queued
        work respills through the cancel-aware drain path, exactly like
        a graceful drain. When ``restart``, a replacement pod boots
        after ``startup_delay`` (k8s reschedule). Returns False when
        the fleet had no pod left to kill."""
        pod = None
        if crash.pod_id is not None:
            pod = self.pods.get(crash.pod_id)
        else:
            for p in self.pods.values():
                if not p.draining:
                    pod = p
                    break
        if pod is None:
            return False
        key = self.dep.key
        del self.pods[pod.pod_id]
        victims: list[Request] = []
        for rid, rep in pod.replicas.items():
            if rep.busy:
                slot = (key, pod.pod_id, rid)
                rq = sim._inflight.pop(slot, None)
                sim._void_finish.add(slot)
                if rq is not None:
                    victims.append(rq)
        queued: list[Request] = []
        while pod.queue:
            nxt = sim._pop_queued(pod)
            if nxt is None:
                break
            queued.append(nxt)
        if crash.restart:
            self.pending_pods += 1
            sim._push(sim._now + self.dep.startup_delay,
                      _REPLICA_READY, key)
        self.sync_dep()
        for rq in queued:
            self._respill(sim, rq)
        for rq in victims:
            sim._lost_in_flight(self, rq, sim.cfg.faults.on_crash)
        return True

    def apply_scale(self, sim: "ClusterSimulator", ev: ScaleEvent) -> None:
        """Pod-granular enactment of a replica-granular scale decision:
        PM-HPA (and the reactive baseline) plan in whole replicas, but
        capacity moves in whole pods — ``ceil(to_n / slots_per_pod)``
        pods up, bounded by ``floor(n_max / slots_per_pod)`` so
        materialised replicas NEVER exceed ``n_max``. When ``n_max`` is
        not a multiple of the pod size that floor leaves the last
        partial pod's worth of quota unreachable to BOOT (a remainder
        pod built at t=0 cannot be rebuilt after a drain) — deliberate
        physics: capacity quantisation is exactly the pod-granularity
        cost the pods-axis matrix measures, pinned in
        ``tests/test_sim_pods.py``. Scale-in drains the emptiest
        pod(s), never below one active pod, and ONLY when the event
        asks for fewer replicas than are ready or booting — a
        hold/scale-out event whose pod rounding lands below the current
        pod count (e.g. re-asserting ``n_max`` over a remainder pod)
        must not drain anything.

        ``jsq`` placement swaps the POD-COUNT quota for a
        REPLICA quota: boot however many pods it takes to cover
        ``to_n`` (the last one sized to the remaining headroom by
        :meth:`_boot_size`), bounded by ``n_max`` replicas instead of
        ``floor(n_max / spp)`` pods. This is the multi-pod tail
        regression's actual repair — under first-fit quantisation an
        edge fleet of 2+1-replica pods could only ever materialise 5 of
        its 6-replica quota, and the missing replica (not queue
        placement) is what pushed the pods=2 flash P99 past the
        monolithic cell. First-fit keeps the quantised physics
        bit-identical to the golden digests."""
        spp = self.slots_per_pod
        if self.placement == "jsq":
            to_n = min(ev.to_n, self.dep.n_max)
            have = self.n_ready + self.pending_pods * spp
            if to_n > have:
                for _ in range(-(-(to_n - have) // spp)):
                    self.pending_pods += 1
                    sim._push(sim._now + self.dep.startup_delay,
                              _REPLICA_READY, self.dep.key)
            elif to_n < self.n_ready:
                want_pods = max(1, -(-to_n // spp))
                cur = self.n_active_pods()
                victims = sorted(
                    (p for p in self.pods.values() if not p.draining),
                    key=lambda p: (p.n_busy(), len(p.queue), -p.pod_id))
                for pod in victims[: cur - want_pods]:
                    if self.n_active_pods() <= 1:
                        break
                    self.mark_pod_draining(sim, pod)
            self.sync_dep()
            return
        want_pods = max(1, -(-ev.to_n // spp))
        want_pods = min(want_pods, max(1, self.dep.n_max // spp))
        cur = self.n_active_pods() + self.pending_pods
        if want_pods > cur:
            for _ in range(want_pods - cur):
                self.pending_pods += 1
                sim._push(sim._now + self.dep.startup_delay,
                          _REPLICA_READY, self.dep.key)
        elif want_pods < cur and \
                ev.to_n < self.n_ready + self.pending_pods * spp:
            victims = sorted(
                (p for p in self.pods.values() if not p.draining),
                key=lambda p: (p.n_busy(), len(p.queue), -p.pod_id))
            for pod in victims[: cur - want_pods]:
                if self.n_active_pods() <= 1:
                    break
                self.mark_pod_draining(sim, pod)
        self.sync_dep()


@dataclasses.dataclass
class SimConfig:
    mode: Mode = "laimr"
    seed: int = 0
    # Eq. 5 exponent for realised service times. The paper quotes
    # gamma=0.9 (§V-A4) for the *control* model; for the simulated ground
    # truth we use 2.0, which reproduces the paper's own measured operating
    # points better: at lam_tilde=1 it gives 0.73*(1+0.33^2)=0.81 s — the
    # 'single CPU replica averages ~0.8 s' of §V-A4 — while 0.9 would give
    # 1.0 s and contradict Table IV's low-load rows. Control model vs
    # ground truth being *different* is also the honest setting: the router
    # must work with an imperfect model, as it would in production.
    gamma_runtime: float = 2.0
    jitter_sigma: float = 0.25     # lognormal service-time jitter
    router: RouterParams = dataclasses.field(default_factory=RouterParams)
    hpa_period: float = 5.0        # HPA reconciliation (§IV-D)
    baseline_lag: float = 60.0     # reactive up-stabilisation window (§I)
    util_cap: float = 4.0          # clamp on U to bound pathological service times
    slo: Optional[float] = None    # explicit tau_t (e.g. 1.8 s, §V-A4)
    # Event-batched control: None keeps the memoised
    # control-plane predictors EXACT (bit-identical to the uncached
    # scalar path — the golden digests hold). Setting K quantises the
    # Erlang-C term of Algorithm 1's predictor to rho buckets of width
    # 1/K, raising memo hit rates at the cost of (bounded) physics drift;
    # golden tests only cover the default-off setting.
    control_rho_buckets: Optional[int] = None
    # Unified control plane: admission_window > 0 accumulates
    # laimr arrivals into windows and routes each window through the
    # SAME vectorised ControlPlane the serving engine uses (one batched
    # score+select per window, quality-priority ordering, route_best
    # offload semantics). 0.0 (default) keeps the scalar per-arrival
    # Algorithm-1 path — bit-identical to the golden digests. In window
    # mode the Alg.1 line-19 per-arrival gauge bump disappears; scaling
    # runs entirely off the HPA tick's batched telemetry refresh (which
    # is also what the tick reconcile reads in scalar mode — see the
    # export-policy NOTE in _on_arrival). Ignored in baseline mode.
    admission_window: float = 0.0
    admission_max_batch: int = 256
    admission_backend: str = "vmap"
    # torch device the window decisions run on ("cuda" unless the caller
    # asks for the CPU); see AdmissionConfig.device
    admission_device: str = "cuda"
    # Routing-policy strategy for window mode: a name in the
    # repro_torch.control.policies registry. "route_best" (default) keeps the
    # cross-tier argmin — bit-identical to the windowed golden
    # digests; "guarded_alg1" runs the paper's home-tier offload guard
    # per window; "safetail" adds top-k redundant dispatch, whose
    # duplicate copies the event loop races and cancels on first
    # completion. Ignored when admission_window == 0.
    policy: str = "route_best"
    # Total copies (primary included) a redundant policy may dispatch.
    redundancy: int = 2
    # Pod-level fleet physics: > 1 partitions every
    # deployment's replicas into whole pods of ceil(n_replicas / pods)
    # slots each — first-fit spillover, per-pod Eq. 5 utilisation,
    # pod-granular scale-out (boot lag per POD) and emptiest-pod drain;
    # see the module docstring. 1 (default) keeps the legacy monolithic
    # pool per deployment, bit-identical to every pinned golden digest.
    pods_per_deployment: int = 1
    # Pod placement mode, only meaningful with
    # pods_per_deployment > 1. "first_fit" (default) keeps the first-fit
    # semantics above — bit-identical to every pinned golden digest.
    # "jsq" joins the shortest queue by (queued, busy) occupancy,
    # starts service on the COLDEST pod with a free slot, steals from
    # the most backlogged sibling at finish time, and pins SafeTail/
    # reliable duplicates to the coldest feasible pods — the fix for
    # the pods=2 flash-P99 regression. Mirrored on the serving side by
    # PodGroup(placement=...) so FleetPlane and the event loop share
    # one placement semantics.
    placement: str = "first_fit"
    # Fault injection: seeded schedule of pod crashes,
    # straggler windows and per-tier network-drop probabilities. The
    # default EMPTY plan is bit-identical to every pinned golden digest:
    # all fault hooks are flag-guarded off the hot path, and the drop
    # draws come from a separate RNG stream that is never created for
    # an empty plan. tests/test_faults.py walls the semantics.
    faults: "FaultPlan" = dataclasses.field(default_factory=FaultPlan)
    # Simulation backend. "event" (default) is the discrete event loop —
    # the oracle, bit-identical to every golden digest. "jax" (the
    # reference's spelling) runs the bucketed time-step twin,
    # repro_torch.core.jaxsim: the same physics per fixed-width bucket,
    # distribution-pinned to the event loop within jaxsim.TOLERANCES.
    backend: str = "event"
    # Bucket width (seconds) for backend="jax".
    bucket_width: float = 0.05
    # torch device the bucketed twin runs on ("cuda" unless the caller
    # asks for the CPU; no fallback when there is no card)
    twin_device: str = "cuda"


@dataclasses.dataclass
class SimResult:
    completed: list[Request]
    scale_events: list[ScaleEvent]
    offload_fast: int
    offload_bulk: float
    n_events: int = 0      # heap events processed (throughput accounting)
    # redundant dispatch (safetail policy): copies raced / copies whose
    # result was discarded after another copy completed first
    duplicates: int = 0
    dup_cancelled: int = 0
    # pod-level fleet physics (pods_per_deployment > 1): whole pods
    # booted/drained over the run, and the final per-pod occupancy
    # (dep key -> [(busy, ready, queued, lifecycle), ...], lifecycle
    # "active"/"draining") — empty in legacy mode
    pods_booted: int = 0
    pods_drained: int = 0
    pod_stats: dict = dataclasses.field(default_factory=dict)
    # fault injection: requests that never completed (crash
    # past the retry budget, dropped link with on_drop="fail", stranded
    # on a dead fleet) and the per-fault-type event counts.
    # Conservation: len(completed) + len(failed) == arrivals.
    failed: list[Request] = dataclasses.field(default_factory=list)
    retried: int = 0
    crashes: int = 0
    drops: int = 0
    straggled: int = 0
    # jax backend: per-request latency samples as one dense
    # array instead of Request objects (the bucketed twin does not track
    # request identity). When set, latencies()/percentile()/summary()
    # read it directly; ``completed`` stays empty. n_arrivals records
    # the trace size for conservation checks.
    latency_trace: Optional[np.ndarray] = None
    n_arrivals: int = 0
    backend: str = "event"

    def fault_counts(self) -> dict[str, int]:
        """Per-fault-type accounting of the run."""
        return {"crashes": self.crashes, "drops": self.drops,
                "straggled": self.straggled, "retried": self.retried,
                "failed": len(self.failed)}

    def failed_count(self) -> int:
        """Total requests with NO finite latency — the ``failed`` list
        plus any completion carrying a None/non-finite latency (the same
        rule ``benchmarks.common.split_latencies`` applies). This is the
        denominator-side twin of latencies(): every arrival lands in
        exactly one of the two buckets."""
        n_bad = sum(1 for r in self.completed
                    if r.latency is None or not np.isfinite(r.latency))
        if self.latency_trace is not None:
            lat = np.asarray(self.latency_trace, dtype=np.float64)
            n_bad += int(lat.size - np.count_nonzero(np.isfinite(lat)))
        return len(self.failed) + n_bad

    def slo_attainment(self, slo: Optional[float] = None) -> float:
        """Fraction of ARRIVALS (not completions) that finished within
        their SLO — failed requests count against attainment, which is
        what makes this the right metric under fault injection. Uses
        each request's own ``slo`` when set, else ``slo``; with no
        deadline anywhere, completion itself is attainment. A jax-backend
        result carries latencies as ``latency_trace`` (no Request
        objects, so no per-request SLO override — every sample is held
        to the ``slo`` argument)."""
        if self.latency_trace is not None:
            total = self.n_arrivals
            if total == 0:
                return float("nan")
            finite = self.latency_trace[np.isfinite(self.latency_trace)]
            if slo is None:
                return len(finite) / total
            return float((finite <= slo).sum()) / total
        total = len(self.completed) + len(self.failed)
        if total == 0:
            return float("nan")
        ok = 0
        for r in self.completed:
            tau = r.slo if r.slo is not None else slo
            if tau is None or (r.latency is not None and r.latency <= tau):
                ok += 1
        return ok / total

    def latencies(self) -> np.ndarray:
        """FINITE latencies only. A completion with a None or non-finite
        latency is a failure, never a percentile sample — the same
        split ``benchmarks.common.split_latencies`` applies, so an
        all-failed run reports through the ``failed`` bucket instead of
        silently yielding NaN statistics (see failed_count())."""
        if self.latency_trace is not None:
            lat = np.asarray(self.latency_trace, dtype=np.float64)
            return lat[np.isfinite(lat)]
        lat = np.array([r.latency for r in self.completed
                        if r.latency is not None], dtype=np.float64)
        return lat[np.isfinite(lat)] if lat.size else lat

    def percentile(self, p: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, p)) if lat.size else float("nan")

    def summary(self) -> dict[str, float]:
        lat = self.latencies()
        failed = float(self.failed_count())
        if lat.size == 0:
            out = {k: float("nan") for k in
                   ("mean", "p50", "p95", "p99", "max", "std", "iqr")}
            out["n"] = 0.0
            out["failed"] = failed
            return out
        q1, q3 = np.percentile(lat, [25, 75])
        return {
            "mean": float(lat.mean()), "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
            "max": float(lat.max()), "std": float(lat.std()),
            "iqr": float(q3 - q1), "n": float(lat.size),
            "failed": failed,
        }


class ClusterSimulator:
    """Seeded discrete-event simulation of one experiment run."""

    def __init__(self, cluster: Cluster, config: Optional[SimConfig] = None):
        # NOTE: the config default is constructed per instance. The old
        # signature ``config: SimConfig = SimConfig()`` evaluated the
        # default ONCE at import, so every no-config simulator shared (and
        # could mutate) a single SimConfig — test_simulator pins the fix.
        config = config or SimConfig()
        self.cluster = cluster
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        self.metrics = MetricsRegistry()
        # Pod-level fleet physics: pods_per_deployment > 1
        # swaps every monolithic pool for a _PodFleet; == 1 keeps the
        # legacy _Pool path untouched (bit-identical golden digests).
        self._multi = config.pods_per_deployment > 1
        if config.placement not in ("first_fit", "jsq"):
            raise ValueError(
                f"unknown SimConfig.placement {config.placement!r} "
                "(expected 'first_fit' or 'jsq')")
        if self._multi:
            self.pools: dict[str, _Pool | _PodFleet] = {
                d.key: _PodFleet(d, config.pods_per_deployment,
                                 placement=config.placement)
                for d in cluster}
        else:
            self.pools = {d.key: _Pool(d) for d in cluster}
        self.scheduler = MultiQueueScheduler()
        self.router = Router(cluster, config.router, self.metrics,
                             rho_buckets=config.control_rho_buckets)
        # Unified control plane: in window mode the simulator is a thin
        # adapter over the same ControlPlane the serving engine drives
        # (pure routing mode — queueing lives in the pools, so no
        # engines are registered and no decision can be REJECTED).
        # Imported lazily: repro_torch.control composes objects from
        # repro_torch.core, so a module-level import here would be circular.
        from repro_torch.control.plane import hpa_refresh
        self._hpa_refresh = hpa_refresh
        self.plane = None
        if config.mode == "laimr" and config.admission_window > 0.0:
            from repro_torch.control.admission import AdmissionConfig
            from repro_torch.control.plane import ControlPlane
            self.plane = ControlPlane(
                cluster, router=self.router,
                config=AdmissionConfig(
                    window=config.admission_window,
                    max_batch=config.admission_max_batch,
                    backend=config.admission_backend,
                    device=config.admission_device,
                    policy=config.policy,
                    redundancy=config.redundancy,
                    # the reliable policy prices the SAME faults the
                    # event loop injects (unused by other policies)
                    latency_sigma=config.jitter_sigma,
                    link_loss=dict(config.faults.drop_prob),
                    placement=config.placement))
        self._win_seq = 0
        # redundant-dispatch state (safetail policy): per-group
        # completion race + lazily-cancelled queued copies. Empty dicts
        # for single-dispatch policies, so the hot path pays one
        # truthiness check.
        self._dup_state: dict[int, dict] = {}
        self._dup_member: dict[int, int] = {}
        self._cancelled: set[int] = set()
        self._dup_cancelled = 0
        # fault injection: every hook below is flag-guarded so
        # an empty plan keeps the event loop — and the service-time RNG
        # stream — byte-identical to the golden digests. Drop draws come
        # from a SEPARATE rng keyed on (sim seed, plan seed).
        plan = config.faults
        self._faults_on = not plan.empty()
        self._fault_rng = (np.random.default_rng((config.seed, plan.seed))
                           if self._faults_on else None)
        self._stragglers: dict[str, list] = {}
        for s in plan.stragglers:
            self._stragglers.setdefault(s.dep_key, []).append(s)
        self._drop_prob = {t: float(p) for t, p in plan.drop_prob.items()
                           if p > 0.0}
        self.failed: list[Request] = []
        # (dep_key, pod_id, rid) -> in-service request, maintained only
        # when faults are on (a crash must find its victims), plus the
        # voided service-end slots of crashed replicas — a voided slot's
        # pending event is vacuous; anything ELSE finishing into a
        # crashed pod still raises (no slot resurrection).
        self._inflight: dict[tuple, Request] = {}
        self._void_finish: set[tuple] = set()
        self._retry_count: dict[int, int] = {}
        self.n_crashes = 0
        self.n_drops = 0
        self.n_retried = 0
        self.n_straggled = 0
        self.pmhpa = PMHPA(cluster, self.metrics, reconcile_period=config.hpa_period,
                           x=config.router.x, rho_low=config.router.rho_low)
        self.reactive = ReactiveAutoscaler(cluster, slo_multiplier=config.router.x,
                                           up_stabilization=config.baseline_lag,
                                           target_latency=config.slo)
        self.slo_override = config.slo
        self._events: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.completed: list[Request] = []
        self.all_scale_events: list[ScaleEvent] = []
        # per-arrival caches (hot path): home deployment per model name,
        # desired-replicas gauge key per deployment key
        self._home: dict[str, Deployment] = {}
        self._gauge_key: dict[str, str] = {}

    # ------------------------------------------------------------------ #
    def _push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), payload))

    def _service_time(self, pool: _Pool) -> float:
        lam_pool = pool.rate.rate(self._now)
        n = pool._n_ready
        lam_tilde = lam_pool / n if n > 1 else lam_pool
        util = (lam_tilde * pool.svc_r_demand + pool.svc_background) \
            / pool.svc_r_max
        util = min(max(util, 0.0), self.cfg.util_cap)
        base = pool.svc_base * (1.0 + util ** self.cfg.gamma_runtime)
        jit = float(self.rng.lognormal(mean=0.0, sigma=self.cfg.jitter_sigma))
        if self._stragglers:
            f = self._straggler_factor(pool)
            if f != 1.0:
                self.n_straggled += 1
                return base * jit * f
        return base * jit

    def _straggler_factor(self, pool: _Pool) -> float:
        """Product of every straggler window covering this pod now."""
        f = 1.0
        now = self._now
        for s in self._stragglers.get(pool.dep.key, ()):
            if s.t_start <= now < s.t_end and \
                    (s.pod_id is None or s.pod_id == pool.pod_id):
                f *= s.factor
        return f

    def _start_service(self, pool: _Pool, req: Request) -> None:
        rep = pool.pop_idle()
        assert rep is not None
        rep.busy = True
        req.start_service = self._now
        st = self._service_time(pool)
        if self._faults_on:
            self._inflight[(pool.dep.key, pool.pod_id, rep.rid)] = req
        self._push(self._now + st, _SERVICE_END,
                   (pool.dep.key, pool.pod_id, rep.rid, req))

    def _enqueue(self, pool: "_Pool | _PodFleet", req: Request) -> None:
        if self._drop_prob and req.offloaded:
            p = self._drop_prob.get(pool.dep.instance.tier, 0.0)
            if p > 0.0 and self._fault_rng.random() < p:
                self.n_drops += 1
                self._on_drop(pool, req)
                return
        if self._multi:
            pool.submit(self, req)
            return
        pool.rate.observe(self._now)
        if pool.idle_replica() is not None:
            self._start_service(pool, req)
        else:
            pool.queue.append(req)

    # ------------------------------------------------------------------ #
    def _bind_deployment(self, arr: Arrival) -> Deployment:
        """The deployment a request is nominally bound to (its home tier).

        The edge-first preference over a static catalogue is invariant, so
        the lookup is cached per model name."""
        dep = self._home.get(arr.model)
        if dep is None:
            deps = self.cluster.for_model(arr.model)
            edge = [d for d in deps if d.instance.tier == "edge"]
            dep = (edge or deps)[0]
            self._home[arr.model] = dep
        return dep

    def _on_arrival(self, arr: Arrival) -> None:
        dep = self._bind_deployment(arr)
        req = Request(model=arr.model, quality=dep.quality, arrival=self._now,
                      slo=self.slo_override)
        if self.plane is not None:
            self._submit_windowed(req)
            return
        if self.cfg.mode == "laimr":
            decision = self.router.on_request(req, dep, self._now)
            target = decision.target or dep
            # Fractional bulk offload: divert with probability phi
            if (decision.action is Action.OFFLOAD_FRACTION
                    and self.rng.uniform() > decision.phi):
                target = dep
            # Alg.1 line 19 'scale out one replica NOW': the event-driven
            # export raises desired_replicas immediately; HPA enacts it on
            # its next 5 s reconcile (k8s semantics).
            for d in decision.scale_out:
                key = self._gauge_key.get(d.key)
                if key is None:
                    key = self.metrics.desired_replicas_key(d.model.name,
                                                            d.instance.name)
                    self._gauge_key[d.key] = key
                cur = self.metrics.get_gauge(key, d.n_replicas)
                self.metrics.set_gauge(key, min(max(cur, d.n_replicas + 1),
                                                d.n_max))
            # NOTE on the event-driven export (§IV-D): the paper exports
            # the custom metric on every telemetry update. Here the HPA
            # tick handler re-exports every deployment from its (just
            # decayed) EWMA immediately before reconcile reads the
            # gauges, so NO inter-tick gauge write is ever observable —
            # neither a per-arrival export (dropped from this hot path:
            # bit-identical on every golden trace, ~40% of the laimr
            # event-loop cost) nor the Alg.1 line-19 bump above, which
            # is kept only as the faithful transcription of 'scale out
            # one replica NOW' and costs a dict lookup per scale-out
            # decision. If reconcile ever stops re-exporting first, the
            # bump (and the export policy) become load-bearing again.
        else:
            target = dep  # baseline: static binding, no offload
        req.assigned_instance = target.key
        self._enqueue(self.pools[target.key], req)

    # -- unified-control-plane window mode -------------------- #
    def _submit_windowed(self, req: Request) -> None:
        """Admission-window adapter: buffer the arrival in the shared
        ControlPlane; when the plane closes the window (max_batch), or
        when this arrival opens a fresh window, schedule/handle the
        flush. The flush event carries a window sequence number so a
        window already closed by max_batch cannot be flushed twice."""
        plane = self.plane
        opened = plane.pending() == 0
        decisions = plane.submit(req, self._now)
        if decisions is not None:
            self._enqueue_decisions(decisions)
        elif opened:
            self._win_seq += 1
            self._push(self._now + self.cfg.admission_window,
                       _WINDOW_FLUSH, self._win_seq)

    def _on_window_flush(self, win_id: int) -> None:
        plane = self.plane
        if win_id != self._win_seq or plane.pending() == 0:
            return
        self._enqueue_decisions(plane.flush(self._now))

    def _enqueue_decisions(self, decisions: list) -> None:
        """Hand routed requests to their pools. The plane runs in pure
        routing mode here (no engines), so every decision carries a
        target; queueing, service and RTT then emerge from the event
        loop exactly as in scalar mode.

        Redundant-dispatch policies (safetail) emit DUPLICATE decisions
        (``dup_of`` set) directly after their primaries: each copy races
        through its own pool, the first completion wins the group, the
        losers are cancelled — still queued copies lazily (skipped at
        dequeue), in-service copies by discarding their result."""
        prim_req: dict[int, Request] = {}
        for dec in decisions:
            if dec.dup_of is None:
                prim_req[dec.req.req_id] = dec.req
            else:
                gid = dec.dup_of
                st = self._dup_state.get(gid)
                if st is None:
                    st = {"done": False, "outstanding": 1,
                          "members": {gid}, "primary": prim_req[gid]}
                    self._dup_state[gid] = st
                    self._dup_member[gid] = gid
                st["members"].add(dec.req.req_id)
                st["outstanding"] += 1
                self._dup_member[dec.req.req_id] = gid
            self._enqueue(self.pools[dec.target_key], dec.req)

    # -- redundant-dispatch bookkeeping (safetail policy) ---------------- #
    def _dup_resolve(self, gid: int) -> None:
        """A group member finished or was cancelled-at-dequeue; free the
        group's maps once every copy is accounted for."""
        st = self._dup_state.get(gid)
        if st is None:
            return
        st["outstanding"] -= 1
        if st["outstanding"] <= 0:
            for m in st["members"]:
                self._dup_member.pop(m, None)
            del self._dup_state[gid]

    def _dup_service_end(self, gid: int, req: Request, pool: _Pool) -> None:
        """First completion wins its redundancy group: the PRIMARY
        request records the winner's latency/placement (conservation —
        one completion per arrival), every other copy is cancelled."""
        st = self._dup_state[gid]
        if not st["done"]:
            st["done"] = True
            prim = st["primary"]
            prim.completion = self._now + pool.net_rtt
            prim.assigned_instance = req.assigned_instance
            prim.offloaded = req.offloaded
            prim.start_service = req.start_service
            self.completed.append(prim)
            for m in st["members"]:
                if m != req.req_id:
                    self._cancelled.add(m)
            self._dup_cancelled += len(st["members"]) - 1
        else:
            # a losing copy ran to completion; its result is discarded
            self._cancelled.discard(req.req_id)
        self._dup_resolve(gid)

    def _pop_queued(self, pool: _Pool) -> Optional[Request]:
        """Dequeue the next live request, lazily skipping copies whose
        redundancy group already completed. The no-duplicates fast path
        is one empty-set check on top of the plain popleft."""
        q = pool.queue
        canc = self._cancelled
        if not canc:
            return q.popleft() if q else None
        while q:
            rq = q.popleft()
            if rq.req_id in canc:
                canc.discard(rq.req_id)
                self._dup_resolve(self._dup_member.get(rq.req_id, -1))
                continue
            return rq
        return None

    # -- fault injection --------------------------------------- #
    def _fail(self, req: Request) -> None:
        """Terminal failure: the request will never complete. Mirrors
        the ledger when a control plane is attached (the settled
        outcome moves to FAILED; conservation stays exact)."""
        self.failed.append(req)
        if self.plane is not None:
            self.plane.mark_failed(offloaded=bool(req.offloaded))

    def _lost_group_copy(self, req: Request, gid: int) -> Optional[Request]:
        """A redundancy-group copy was destroyed (pod crash, link drop,
        stranding). Returns the PRIMARY request iff no live copy
        remains — the caller must then retry-or-fail it so the group
        still gets exactly one terminal outcome; returns None while
        other copies keep racing (or the group already won)."""
        st = self._dup_state.get(gid)
        if st is None:
            return req
        if st["done"]:
            # the race was already won elsewhere; this was a cancelled
            # loser — account it exactly like a lazy dequeue-cancel
            self._cancelled.discard(req.req_id)
            self._dup_resolve(gid)
            return None
        st["outstanding"] -= 1
        st["members"].discard(req.req_id)
        self._dup_member.pop(req.req_id, None)
        if st["outstanding"] > 0:
            return None
        prim = st["primary"]
        for m in st["members"]:
            self._dup_member.pop(m, None)
        del self._dup_state[gid]
        return prim

    def _lost_in_flight(self, pool: "_Pool | _PodFleet", req: Request,
                        action: str) -> None:
        """An in-service request died with its pod."""
        if self._dup_member:
            gid = self._dup_member.get(req.req_id)
            if gid is not None:
                req = self._lost_group_copy(req, gid)
                if req is None:
                    return
        self._retry_or_fail(pool, req, action)

    def _retry_or_fail(self, pool: "_Pool | _PodFleet", req: Request,
                       action: str, delay: float = 0.0) -> None:
        """Settle a destroyed dispatch: re-admit (bounded by
        ``max_retries``, ledgered as RETRIED) or fail. Crash victims
        re-enter their deployment immediately; dropped offloads wait
        out ``drop_timeout`` first (the sender-side timeout)."""
        plan = self.cfg.faults
        rc = self._retry_count.get(req.req_id, 0)
        if action == "retry" and rc < plan.max_retries:
            self._retry_count[req.req_id] = rc + 1
            self.n_retried += 1
            if self.plane is not None:
                self.plane.mark_retried()
            key = req.assigned_instance
            if key not in self.pools:
                key = pool.dep.key
            if delay > 0.0:
                self._push(self._now + delay, _RETRY, (key, req))
            else:
                self._enqueue(self.pools[key], req)
        else:
            self._fail(req)

    def _on_drop(self, pool: "_Pool | _PodFleet", req: Request) -> None:
        """The offload link ate this dispatch (per-tier loss draw): the
        sender times out and retries the same target — redrawing the
        drop — or fails. A dropped redundant COPY simply leaves the
        race; only the loss of the last live copy re-dispatches the
        primary."""
        if self._dup_member:
            gid = self._dup_member.get(req.req_id)
            if gid is not None:
                req = self._lost_group_copy(req, gid)
                if req is None:
                    return
        self._retry_or_fail(pool, req, self.cfg.faults.on_drop,
                            delay=self.cfg.faults.drop_timeout)

    def _on_fault(self, crash: PodCrash) -> None:
        pool = self.pools[crash.dep_key]
        if self._multi:
            if pool.crash_pod(self, crash):
                self.n_crashes += 1
            return
        self._crash_pool(pool, crash)

    def _crash_pool(self, pool: _Pool, crash: PodCrash) -> None:
        """Legacy single-pool mode: the deployment's whole replica set
        is the 'pod' — every replica dies (in-flight work per
        ``on_crash``), the FIFO queue survives (it belongs to the
        deployment; replacements and HPA scale-out drain it)."""
        if not pool.replicas:
            return
        self.n_crashes += 1
        key = pool.dep.key
        victims: list[Request] = []
        n_lost = 0
        for rid, rep in list(pool.replicas.items()):
            if rep.busy:
                slot = (key, pool.pod_id, rid)
                rq = self._inflight.pop(slot, None)
                self._void_finish.add(slot)
                if rq is not None:
                    victims.append(rq)
            if not rep.draining:
                n_lost += 1
        pool.replicas.clear()
        pool._idle.clear()
        pool._n_ready = 0
        pool.sync_dep()
        if crash.restart:
            for _ in range(n_lost):
                pool.pending_up += 1
                self._push(self._now + pool.dep.startup_delay,
                           _REPLICA_READY, key)
        for rq in victims:
            self._lost_in_flight(pool, rq, self.cfg.faults.on_crash)

    def _sweep_unserved(self) -> None:
        """Fault plans can strand work (a dead fleet whose replacement
        never boots): once the event heap drains, every still-queued or
        parked request is failed, so ``completed + failed == arrivals``
        holds unconditionally."""
        for pool in self.pools.values():
            if self._multi:
                queues = [pool.parked] + [p.queue
                                          for p in pool.pods.values()]
            else:
                queues = [pool.queue]
            for q in queues:
                while q:
                    rq = q.popleft()
                    if rq.req_id in self._cancelled:
                        self._cancelled.discard(rq.req_id)
                        self._dup_resolve(
                            self._dup_member.get(rq.req_id, -1))
                        continue
                    if self._dup_member:
                        gid = self._dup_member.get(rq.req_id)
                        if gid is not None:
                            rq = self._lost_group_copy(rq, gid)
                            if rq is None:
                                continue
                    self._fail(rq)

    def _on_service_end(self, key: str, pod_id: int, rid: int,
                        req: Request) -> None:
        if self._faults_on:
            slot = (key, pod_id, rid)
            if slot in self._void_finish:
                # this replica died mid-service (pod crash); its
                # scheduled end is vacuous — the request was already
                # re-admitted or failed at crash time
                self._void_finish.discard(slot)
                return
            self._inflight.pop(slot, None)
        pool = self.pools[key]
        gid = self._dup_member.get(req.req_id) if self._dup_member else None
        if gid is None:
            req.completion = self._now + pool.net_rtt
            self.completed.append(req)
            if self.cfg.mode == "baseline":
                self.reactive.observe(pool.dep, req.latency)
        else:
            self._dup_service_end(gid, req, pool)
        if self._multi:
            pool.finish(self, pod_id, rid)
            return
        rep = pool.replicas.get(rid)
        if rep is None:
            return
        if rep.draining:
            rep.busy = False
            del pool.replicas[rid]
            pool.sync_dep()
        else:
            pool.release(rep)
        if pool.queue and pool.idle_replica() is not None:
            nxt = self._pop_queued(pool)
            if nxt is not None:
                self._start_service(pool, nxt)

    def _on_replica_ready(self, key: str) -> None:
        pool = self.pools[key]
        if self._multi:
            pool.on_ready(self)   # one whole pod materialises
            return
        pool.pending_up = max(0, pool.pending_up - 1)
        pool.add_replica()
        pool.sync_dep()
        while pool.queue and pool.idle_replica() is not None:
            nxt = self._pop_queued(pool)
            if nxt is None:
                break
            self._start_service(pool, nxt)

    def _apply_scale(self, ev: ScaleEvent) -> None:
        pool = self.pools[ev.deployment_key]
        if self._multi:
            pool.apply_scale(self, ev)   # pod-granular enactment
            self.all_scale_events.append(ev)
            return
        dep = pool.dep
        current = pool.n_ready + pool.pending_up
        if ev.to_n > current:
            for _ in range(ev.to_n - current):
                pool.pending_up += 1
                self._push(self._now + dep.startup_delay, _REPLICA_READY, dep.key)
        elif ev.to_n < current:
            victims = sorted(pool.replicas.values(),
                             key=lambda r: (r.busy, r.rid), reverse=True)
            for r in victims[: current - ev.to_n]:
                if pool.n_ready <= 1:
                    break
                pool.mark_draining(r)
            pool.sync_dep()
        self.all_scale_events.append(ev)

    def _on_hpa_tick(self) -> None:
        if self.cfg.mode == "laimr":
            # Event-batched control, owned by the unified control plane
            # (repro_torch.control.plane.hpa_refresh): decay every deployment's
            # EWMA toward its sliding rate (so scale-in can trigger
            # without traffic) and export all custom metrics in ONE
            # batched refresh per tick — same per-deployment float ops as
            # the old interleaved loop, so the golden digests are
            # unchanged. This is the PM-HPA half of the shared plane and
            # runs identically in scalar and window mode.
            # The plane's policy may export a reactive scaling floor
            # (BurstAdaptiveHybridPolicy) on top of the batched
            # telemetry refresh; policy=None (scalar mode / plain
            # policies) keeps the refresh bit-identical to the digests.
            self._hpa_refresh(self.router, self.pmhpa, self._now,
                              policy=(self.plane.policy
                                      if self.plane is not None else None))
            events = self.pmhpa.reconcile(self._now)
        else:
            events = self.reactive.reconcile(self._now)
        for ev in events:
            self._apply_scale(ev)
        self._push(self._now + self.cfg.hpa_period, _HPA_TICK, None)

    # ------------------------------------------------------------------ #
    def run(self, arrivals: list[Arrival], horizon: Optional[float] = None) -> SimResult:
        if self.cfg.backend == "jax":
            # The bucketed twin. Pure in (cluster, cfg, arrivals): never
            # mutates this simulator's pools/telemetry, so the same
            # ClusterSimulator could still run the event loop afterwards.
            from repro_torch.core.jaxsim import simulate as _twin_simulate
            return _twin_simulate(self.cluster, self.cfg, arrivals, horizon)
        if self.cfg.backend != "event":
            raise ValueError(
                f"unknown SimConfig.backend {self.cfg.backend!r} "
                "(expected 'event' or 'jax')")
        self._now = 0.0
        for arr in arrivals:
            self._push(arr.t, _ARRIVAL, arr)
        self._push(self.cfg.hpa_period, _HPA_TICK, None)
        if self._faults_on:
            for crash in self.cfg.faults.crashes:
                self._push(crash.t, _FAULT, crash)
        end = horizon if horizon is not None else \
            (arrivals[-1].t + 120.0 if arrivals else 0.0)
        events, heappop = self._events, heapq.heappop
        on_arrival, on_service_end = self._on_arrival, self._on_service_end
        n_events = 0
        while events:
            t, kind, _, payload = heappop(events)
            if t > end and kind == _HPA_TICK:
                continue  # stop rescheduling ticks past the horizon
            self._now = t
            n_events += 1
            if kind == _ARRIVAL:
                on_arrival(payload)
            elif kind == _SERVICE_END:
                on_service_end(*payload)
            elif kind == _REPLICA_READY:
                self._on_replica_ready(payload)
            elif kind == _HPA_TICK:
                self._on_hpa_tick()
            elif kind == _WINDOW_FLUSH:
                self._on_window_flush(payload)
            elif kind == _FAULT:
                self._on_fault(payload)
            elif kind == _RETRY:
                rkey, rq = payload
                self._enqueue(self.pools[rkey], rq)
        if self._faults_on:
            self._sweep_unserved()
        tel = self.router.telemetry
        return SimResult(
            completed=self.completed,
            scale_events=self.all_scale_events,
            offload_fast=sum(t.offloaded_fast for t in tel.values()),
            offload_bulk=sum(t.offloaded_bulk for t in tel.values()),
            n_events=n_events,
            duplicates=(self.plane.dup_dispatched
                        if self.plane is not None else 0),
            dup_cancelled=self._dup_cancelled,
            pods_booted=(sum(p.pods_booted for p in self.pools.values())
                         if self._multi else 0),
            pods_drained=(sum(p.pods_drained for p in self.pools.values())
                          if self._multi else 0),
            pod_stats=self.fleet_stats() if self._multi else {},
            failed=self.failed,
            retried=self.n_retried,
            crashes=self.n_crashes,
            drops=self.n_drops,
            straggled=self.n_straggled,
        )

    def fleet_stats(self) -> dict[str, list[tuple[int, int, int, str]]]:
        """Per-pod (busy, ready, queued, lifecycle) occupancy per
        deployment — the simulator twin of ``FleetPlane.fleet_stats``.
        In legacy mode the single pool reports as one pod."""
        return {key: p.stats() if self._multi else [p.stats()]
                for key, p in self.pools.items()}
