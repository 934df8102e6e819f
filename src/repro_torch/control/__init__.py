"""Unified LA-IMR control plane: one routing/admission core driving the
live serving router, the multi-pod fleet plane, and the discrete-event
simulator.

Layers:

* :mod:`repro_torch.control.policies`  — the strategy registry
  (``route_best`` / ``guarded_alg1``) over a shared base: batched
  scoring/selection on the candidate table (torch scorer, CUDA kernels
  or their plain versions), f32-pinned decision boundaries, the float64
  scalar reference loop;
* :mod:`repro_torch.control.admission` — window accumulation with
  quality-class priority ordering, outcomes, hardened slot providers;
* :mod:`repro_torch.control.plane`     — :class:`ControlPlane`, the
  engine-slot binding cascade, the conservation contract and the PM-HPA
  tick refresh;
* :mod:`repro_torch.control.fleet`     — :class:`FleetPlane` /
  :class:`PodGroup`: several pods per deployment behind the same plane.
"""
from repro_torch.control.admission import (ADMITTED, DUPLICATE, OFFLOADED,
                                           REJECTED, AdmissionConfig,
                                           AdmissionDecision, AdmissionQueue,
                                           SlotBank)
from repro_torch.control.fleet import FleetPlane, PodGroup
from repro_torch.control.plane import ControlPlane, hpa_refresh
from repro_torch.control.policies import (POLICIES, GuardedAlgorithm1Policy,
                                          RouteBestPolicy, RoutingPolicyBase,
                                          WindowDecision, get_policy,
                                          make_policy)
from repro_torch.control.policies.base import CandidateTable

__all__ = [
    "ADMITTED", "DUPLICATE", "OFFLOADED", "REJECTED", "AdmissionConfig",
    "AdmissionDecision", "AdmissionQueue", "SlotBank", "ControlPlane",
    "FleetPlane", "PodGroup", "hpa_refresh", "CandidateTable",
    "POLICIES", "GuardedAlgorithm1Policy", "RouteBestPolicy",
    "RoutingPolicyBase", "WindowDecision", "get_policy", "make_policy",
]
