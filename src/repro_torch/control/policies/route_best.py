"""Cross-tier argmin routing — the original windowed strategy.

§IV-B steps i-v over the whole window: one batched score+select, each
request goes to the SLO-feasible candidate with the lowest predicted
latency (cost tie-break); when nothing in the request's lane is
feasible, ``route_best`` semantics offload to the upstream of the
cheapest lane candidate (or that candidate itself at the top tier — in
which case the request never left its tier and is NOT an offload).

This is the strategy the golden digests pin: routed through the
refactored plane it must stay bit-identical to the pre-split
``ControlPlane.flush`` (tests/test_control_plane.py, windowed digests
included).
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.policies.base import RoutingPolicyBase, WindowDecision
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER


class RouteBestPolicy(RoutingPolicyBase):
    """The cross-tier argmin window strategy (the default)."""

    name = "route_best"

    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        lam, slo, mask = self.decision_rows(reqs, t_now)
        idx, ok, g_best, g = self.score_select(lam, slo, mask)
        if TRACER.on:
            TRACER.stage("admission.settle")
        r_n = len(reqs)
        primary = np.zeros(r_n, np.int64)
        offload = np.zeros(r_n, bool)
        predicted = np.zeros(r_n, np.float64)
        feasible = np.asarray(ok, bool).copy()
        for r in range(r_n):
            pred = float(g_best[r]) if g_best is not None \
                else float(g[r, int(idx[r])])
            if feasible[r]:
                primary[r] = int(idx[r])
            else:
                primary[r], offload[r] = self.cheapest_lane_upstream(mask[r])
                if g is not None:
                    pred = float(np.min(g[r]))
            predicted[r] = pred
        return WindowDecision(primary=primary, feasible=feasible,
                              offload=offload, predicted=predicted,
                              lam=lam, slo=slo, mask=mask, g=g)
