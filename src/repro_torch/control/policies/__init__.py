"""Routing-policy strategy registry.

Every strategy subclasses
:class:`~repro_torch.control.policies.base.RoutingPolicyBase` (shared
candidate table, batched scoring, f32-pinned selection semantics, the
float64 scalar reference) and implements ``decide(reqs, t_now) ->
WindowDecision``. The registry maps stable string names — usable from
``AdmissionConfig.policy`` and ``SimConfig.policy`` — to classes:

* ``route_best``   — cross-tier argmin (the default);
* ``guarded_alg1`` — home-tier binding + the paper's per-request offload
  guard (Algorithm 1 lines 8-11), one vectorised comparison per window;
* ``safetail``     — top-k feasible redundant dispatch with
  first-completion cancellation (SafeTail, arXiv:2408.17171);
* ``reliable``     — SLO-attainment-probability routing with
  headroom-gated duplication (FogROS2-PLR, arXiv:2410.05562);
* ``hybrid``       — burst-adaptive composite: an EWMA burst detector
  on the arrival stream delegates to ``guarded_alg1`` under steady
  load and ``safetail`` during bursts, and exports a reactive scaling
  floor through the PM-HPA hook (arXiv:2512.14290).

Under ``backend="cuda"`` each strategy decides a window in one kernel
launch: ``routing_score``, ``routing_guard``, ``routing_topk`` and
``routing_attain`` respectively (``hybrid`` launches its active
constituent's).
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.control.admission import AdmissionConfig
from repro_torch.control.policies.base import (BIG, CandidateTable,
                                               RoutingPolicyBase,
                                               WindowDecision)
from repro_torch.core.catalogue import Cluster
from repro_torch.core.router import Router

POLICIES: dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: add a strategy to the registry by its ``name``."""
    if not issubclass(cls, RoutingPolicyBase) or cls.name == "base":
        raise TypeError(f"{cls!r} is not a named RoutingPolicyBase subclass")
    POLICIES[cls.name] = cls
    return cls


def get_policy(name: str) -> type:
    """Resolve a registry name to its strategy class (KeyError lists
    the registered names)."""
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown routing policy {name!r}; registered: "
                       f"{sorted(POLICIES)}") from None


PolicySpec = Union[None, str, type, RoutingPolicyBase]


def make_policy(spec: PolicySpec, cluster: Cluster, router: Router,
                config: Optional[AdmissionConfig] = None
                ) -> RoutingPolicyBase:
    """Build the plane's policy from a flexible spec: None -> the
    config's ``policy`` name (default ``route_best``), a registry name,
    a strategy class, or an already-constructed instance (returned
    as-is — multi-plane setups can share one policy object)."""
    if isinstance(spec, RoutingPolicyBase):
        return spec
    if spec is None:
        spec = (config.policy if config is not None else None) \
            or "route_best"
    if isinstance(spec, str):
        spec = get_policy(spec)
    return spec(cluster, router, config)


from repro_torch.control.policies.guarded import GuardedAlgorithm1Policy  # noqa: E402
from repro_torch.control.policies.hybrid import BurstAdaptiveHybridPolicy  # noqa: E402
from repro_torch.control.policies.reliable import ReliableSloPolicy  # noqa: E402
from repro_torch.control.policies.route_best import RouteBestPolicy  # noqa: E402
from repro_torch.control.policies.safetail import SafeTailRedundantPolicy  # noqa: E402

register(RouteBestPolicy)
register(GuardedAlgorithm1Policy)
register(SafeTailRedundantPolicy)
register(ReliableSloPolicy)
register(BurstAdaptiveHybridPolicy)

#: back-compat alias: the single strategy of the first control plane was
#: the route_best window mode
RoutingPolicy = RouteBestPolicy

__all__ = [
    "BIG", "BurstAdaptiveHybridPolicy", "CandidateTable",
    "GuardedAlgorithm1Policy", "POLICIES", "PolicySpec",
    "ReliableSloPolicy", "RouteBestPolicy", "RoutingPolicy",
    "RoutingPolicyBase", "SafeTailRedundantPolicy", "WindowDecision",
    "get_policy", "make_policy", "register",
]
