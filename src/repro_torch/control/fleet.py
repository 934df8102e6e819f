"""Multi-pod fleet plane: one policy object fronting several pods.

The ROADMAP's multi-pod open item: the sharding rules existed but
nothing fronted SEVERAL ``ServingEngine`` pods per deployment with one
admission loop. :class:`PodGroup` aggregates any number of slot
providers (``ServingEngine``, :class:`~repro_torch.control.admission.SlotBank`,
mixed) behind the exact single-engine admission surface
(``free_slots`` / ``n_free`` / ``admit_next`` / ``release``), so
:class:`FleetPlane` is a *thin* :class:`~repro_torch.control.plane.ControlPlane`
subclass — the same :mod:`repro_torch.control.policies` strategy object drives
single-pod serving, multi-pod serving, and the discrete-event simulator
without knowing pods exist.

Spillover is slot-aware and deterministic: ``admit_next`` fills pods in
declaration order, spilling to the next pod only when the current one is
full (first-fit keeps decode batches dense on the leading pods, which is
what continuous batching wants). Slot ids are globalised —
``global = pod_base + local`` with cumulative bases — so the plane's
binding cascade, duplicate cancellation and the hardened double-release
guard all work unchanged across pods.
"""
from __future__ import annotations

import bisect
from typing import Optional, Sequence

from repro_torch.control.plane import ControlPlane


class PodGroup:
    """Several slot providers behind one engine surface (global slots).

    Pod lifecycle (mirroring the simulator's ``_PodFleet``):
    :meth:`mark_draining` takes a pod out of the admission rotation while
    its in-flight slots complete (their releases still route home);
    :meth:`retire` removes a fully drained pod for good — releasing into
    a retired pod afterwards is a loud error, so a cancelled SafeTail
    duplicate whose pod was scaled away can never resurrect its slot.
    Slot-id bases are immutable (retired pods keep their id range), so
    the plane's global slot bookkeeping never shifts under live traffic.
    """

    def __init__(self, pods: Sequence, placement: str = "first_fit"):
        if not pods:
            raise ValueError("PodGroup needs at least one pod")
        if placement not in ("first_fit", "jsq"):
            raise ValueError(
                f"unknown placement {placement!r} "
                "(expected 'first_fit' or 'jsq')")
        self.placement = placement
        self.pods = list(pods)
        self.bases: list[int] = []
        total = 0
        for p in self.pods:
            self.bases.append(total)
            total += int(p.slots)
        self.slots = total      # mirrors the single-engine surface
        self.draining: list[bool] = [False] * len(self.pods)
        self.retired: list[bool] = [False] * len(self.pods)

    # ---- surface shared with ServingEngine / SlotBank ----------------- #
    def n_free(self) -> int:
        """Admittable free slots — draining/retired pods offer none."""
        return sum(p.n_free() for i, p in enumerate(self.pods)
                   if not self.draining[i] and not self.retired[i])

    def free_slots(self) -> list[int]:
        return [base + s
                for i, (p, base) in enumerate(zip(self.pods, self.bases))
                if not self.draining[i] and not self.retired[i]
                for s in p.free_slots()]

    def admit_next(self, first_token: int = 0,
                   start_pos: int = 0) -> Optional[int]:
        """Placement-mode admission (the simulator's ``_PodFleet._place``
        mirror). ``first_fit`` (default): the first ACTIVE pod with a
        free slot wins (draining/retired pods take no new work) — keeps
        decode batches dense on the leading pods. ``jsq``: the ACTIVE
        pod with the fewest slots in use wins (ties -> declaration
        order), spreading occupancy instead of concentrating it."""
        if self.placement == "jsq":
            return self.admit_coldest(first_token, start_pos)
        for i, (p, base) in enumerate(zip(self.pods, self.bases)):
            if self.draining[i] or self.retired[i]:
                continue
            slot = p.admit_next(first_token, start_pos)
            if slot is not None:
                return base + slot
        return None

    def admit_coldest(self, first_token: int = 0,
                      start_pos: int = 0) -> Optional[int]:
        """Admit on the COLDEST active pod — fewest slots in use, ties
        to declaration order. This is both the ``jsq`` admission rule
        and the slot source for redundant copies
        (``ControlPlane._take_slot(cold=True)``): a SafeTail duplicate
        pinned to the coldest pod races a genuinely different queue
        instead of the primary's first-fit neighbour."""
        order = sorted(
            (i for i, p in enumerate(self.pods)
             if not self.draining[i] and not self.retired[i]
             and p.n_free() > 0),
            key=lambda i: (self.pods[i].slots - self.pods[i].n_free(), i))
        for i in order:
            slot = self.pods[i].admit_next(first_token, start_pos)
            if slot is not None:
                return self.bases[i] + slot
        return None

    def release(self, slot: int) -> None:
        """Release a slot back to its owning pod. In-flight work on a
        DRAINING pod completes normally; a RETIRED pod's slots are gone
        — releasing one (e.g. a stale cancellation of a SafeTail
        duplicate) raises instead of resurrecting capacity."""
        pod_i, local = self.locate(slot)
        if self.retired[pod_i]:
            raise RuntimeError(
                f"PodGroup.release({slot}): pod {pod_i} was retired — a "
                "release into a removed pod cannot resurrect its slot")
        self.pods[pod_i].release(local)

    # ---- pod boot/drain lifecycle ------------------------------------- #
    def mark_draining(self, pod_i: int) -> None:
        """Take pod ``pod_i`` out of the admission rotation (graceful
        termination): no new admissions, in-flight slots release home."""
        if not 0 <= pod_i < len(self.pods):
            raise IndexError(f"PodGroup.mark_draining({pod_i}): no such "
                             f"pod (0..{len(self.pods) - 1})")
        self.draining[pod_i] = True

    def retire(self, pod_i: int) -> None:
        """Remove a DRAINED pod for good. Requires every slot free (the
        graceful-termination contract: drain first, retire when idle);
        retiring a busy pod would orphan its in-flight slots."""
        if not 0 <= pod_i < len(self.pods):
            raise IndexError(f"PodGroup.retire({pod_i}): no such pod "
                             f"(0..{len(self.pods) - 1})")
        pod = self.pods[pod_i]
        if pod.n_free() != pod.slots:
            raise RuntimeError(
                f"PodGroup.retire({pod_i}): {pod.slots - pod.n_free()} "
                "slot(s) still in flight — drain before retiring")
        self.draining[pod_i] = True
        self.retired[pod_i] = True

    def crash(self, pod_i: int) -> None:
        """Hard-kill pod ``pod_i`` (fault injection): unlike
        :meth:`retire` it does NOT require the pod to be drained — the
        pod is gone NOW, and any in-flight slot it held is orphaned.
        Subsequent releases into it raise (same guard as a retired
        pod), so a completion racing the crash is loud, never a silent
        slot resurrection; the caller owns re-admitting or failing the
        orphaned requests."""
        if not 0 <= pod_i < len(self.pods):
            raise IndexError(f"PodGroup.crash({pod_i}): no such pod "
                             f"(0..{len(self.pods) - 1})")
        self.draining[pod_i] = True
        self.retired[pod_i] = True

    # ---- pod-aware helpers -------------------------------------------- #
    def locate(self, slot: int) -> tuple[int, int]:
        """Global slot id -> (pod index, local slot id)."""
        if not 0 <= slot < self.slots:
            raise IndexError(f"PodGroup slot {slot} out of range "
                             f"(0..{self.slots - 1})")
        pod_i = bisect.bisect_right(self.bases, slot) - 1
        return pod_i, slot - self.bases[pod_i]

    def lifecycle(self, pod_i: int) -> str:
        """Pod lifecycle flag: "active" / "draining" / "retired"."""
        if self.retired[pod_i]:
            return "retired"
        return "draining" if self.draining[pod_i] else "active"

    def stats(self) -> list[tuple[int, int, str]]:
        """Per-pod (slots in use, slots total, lifecycle) — spillover
        telemetry. The lifecycle flag marks rows whose ``total`` is NOT
        admittable capacity: draining pods only finish in-flight work
        and retired pods are gone — the old 2-tuple rows silently
        counted both as live, overstating free capacity to every
        placement consumer. Use :meth:`capacity` for
        the admittable-slot sums."""
        return [(p.slots - p.n_free(), p.slots, self.lifecycle(i))
                for i, p in enumerate(self.pods)]

    def capacity(self) -> tuple[int, int]:
        """(slots in use, slots total) over ACTIVE pods only — the
        admittable-capacity aggregate placement consumers should read
        (dead pods' slots excluded, unlike the raw ``self.slots``)."""
        used = total = 0
        for i, p in enumerate(self.pods):
            if self.draining[i] or self.retired[i]:
                continue
            used += p.slots - p.n_free()
            total += p.slots
        return used, total


class FleetPlane(ControlPlane):
    """A :class:`ControlPlane` whose deployments are backed by pod
    FLEETS: ``pods`` maps deployment keys to lists of slot providers,
    each list wrapped in a :class:`PodGroup`. Everything else — policy,
    admission windows, conservation, duplicates — is the shared plane.
    """

    def __init__(self, cluster, pods: dict[str, Sequence], **kwargs):
        if "engines" in kwargs:
            raise TypeError("FleetPlane takes `pods`, not `engines`")
        cfg = kwargs.get("config")
        placement = getattr(cfg, "placement", "first_fit") \
            if cfg is not None else "first_fit"
        groups = {key: PodGroup(pod_list, placement=placement)
                  for key, pod_list in pods.items()}
        super().__init__(cluster, engines=groups, **kwargs)

    def pod_group(self, dep_key: str) -> PodGroup:
        return self.engines[dep_key]

    def fleet_stats(self) -> dict[str, list[tuple[int, int, str]]]:
        """deployment key -> per-pod (in use, total, lifecycle) rows;
        see :meth:`PodGroup.stats` (dead pods are flagged, and
        :meth:`PodGroup.capacity` sums admittable slots only)."""
        return {key: grp.stats() for key, grp in self.engines.items()}
