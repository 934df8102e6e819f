"""Back-compat shim: the policy layer lives in
``repro_torch.control.policies``.

The first control plane exposed ONE strategy here (``RoutingPolicy``:
the batched cross-tier argmin). The strategy split factored its
machinery into :mod:`repro_torch.control.policies.base` (shared
candidate table + batched score/select + scalar reference) and its
decision rule into
:class:`repro_torch.control.policies.route_best.RouteBestPolicy`; the
other strategies live beside it in the registry. Import from
:mod:`repro_torch.control.policies` in new code — this module keeps the
old names importable.
"""
from __future__ import annotations

from repro_torch.control.policies import (POLICIES, GuardedAlgorithm1Policy,
                                          RouteBestPolicy, RoutingPolicy,
                                          SafeTailRedundantPolicy,
                                          get_policy, make_policy)
from repro_torch.control.policies.base import (BIG, CandidateTable,
                                               RoutingPolicyBase,
                                               WindowDecision)

__all__ = [
    "BIG", "CandidateTable", "GuardedAlgorithm1Policy", "POLICIES",
    "RouteBestPolicy", "RoutingPolicy", "RoutingPolicyBase",
    "SafeTailRedundantPolicy", "WindowDecision", "get_policy",
    "make_policy",
]
