"""SafeTail-style redundant dispatch — top-k feasible + cancellation.

SafeTail (arXiv:2408.17171) shows that dispatching a request to a SMALL
number of replicas/tiers simultaneously and keeping the first completion
is the strongest known tail-cutter at the edge: the duplicate absorbs
service-time jitter and transient queueing at the primary. The price is
extra load — every duplicate occupies a slot (or a replica) until the
first copy completes and the rest are cancelled.

Strategy per window (one batched score+select, then vectorised top-k;
one ``routing_topk`` kernel launch under ``backend="cuda"``):

* primary = the route_best winner (SLO filter + latency argmin + cost
  tie-break — identical selection semantics to
  :class:`~repro_torch.control.policies.route_best.RouteBestPolicy`);
* duplicates = the next ``redundancy - 1`` FEASIBLE candidates in
  predicted-latency order (stable sort, primary excluded). Infeasible
  windows degrade to exactly route_best's upstream-of-cheapest offload
  with no duplicates — redundancy never widens the feasible set;
* the plane dispatches duplicates opportunistically: a duplicate takes
  an engine slot only if one is free (no cascade, no rejection — losing
  a duplicate costs nothing), and first-completion cancellation
  (``ControlPlane.first_completion`` / the simulator's duplicate groups)
  releases the losers' slots.

Conservation is generalised, not broken: ``admitted + offloaded +
rejected == arrivals`` still holds over primaries, with ``duplicate``
outcomes accounted separately in slots and telemetry.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.policies.base import RoutingPolicyBase, WindowDecision
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER


class SafeTailRedundantPolicy(RoutingPolicyBase):
    """Top-k feasible redundant dispatch with first-completion
    cancellation (``AdmissionConfig.redundancy`` copies total)."""

    name = "safetail"

    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        lam, slo, mask = self.decision_rows(reqs, t_now)
        k_extra = max(int(self.cfg.redundancy) - 1, 0)
        r_n = len(reqs)

        if self.fused:
            # primary + every duplicate column in ONE routing_topk
            # call: the (R, I) matrix never reaches the host, only the
            # (R, k) winners do (route_best's fallback on infeasible
            # rows, no duplicates, as the vmap loop)
            return self.settle_topk(*self._fused(
                "routing_topk", self._lane_rows(lam, slo, mask), "cost",
                k=k_extra + 1), lam, slo, mask)

        # vmap fallback: full (R, I) matrix, then the per-row top-k scan
        if TRACER.on:
            TRACER.stage("admission.kernel")
        g_t = self.score_tensor(lam)
        idx, ok = self.select_batch(g_t, slo, mask)
        if TRACER.on:
            TRACER.stage("admission.download")
        g = self._download(g_t)
        if TRACER.on:
            TRACER.stage("admission.settle")

        primary = np.zeros(r_n, np.int64)
        offload = np.zeros(r_n, bool)
        predicted = np.zeros(r_n, np.float64)
        feasible = np.asarray(ok, bool).copy()
        dups: list[tuple] = []
        for r in range(r_n):
            if feasible[r]:
                p = int(idx[r])
                primary[r] = p
                predicted[r] = float(g[r, p])
                if k_extra:
                    feas = np.flatnonzero((g[r] <= slo[r]) & mask[r])
                    feas = feas[np.argsort(g[r][feas], kind="stable")]
                    dups.append(tuple(
                        int(j) for j in feas if int(j) != p)[:k_extra])
                else:
                    dups.append(())
            else:
                # route_best's infeasible fallback, no duplicates
                primary[r], offload[r] = self.cheapest_lane_upstream(mask[r])
                predicted[r] = float(np.min(g[r]))
                dups.append(())
        return WindowDecision(primary=primary, feasible=feasible,
                              offload=offload, predicted=predicted,
                              lam=lam, slo=slo, mask=mask, g=g,
                              duplicates=tuple(dups))
