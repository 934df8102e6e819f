"""SLO-attainment-probability routing with headroom-gated redundancy.

FogROS2-PLR (arXiv:2410.05562) routes on latency *distributions*: the
best target is not the one with the lowest point estimate g but the one
with the highest probability of actually meeting the deadline once
dispersion and link loss are priced in,

    P(meet SLO) = (1 - loss_tier) * P(latency <= slo | delivered),

with the conditional attainment in closed form from the lognormal
dispersion around g (:func:`repro_torch.core.latency_model.slo_attain_prob`).
A far tier with a slightly worse median but a tighter distribution (or
a lossless link) can therefore out-score a jittery/lossy near tier —
exactly the regime the fault-injection benches exercise.

Strategy per window (one batched score, then a vectorised per-row scan;
one ``routing_attain`` kernel launch under ``backend="cuda"``):

* among SLO-feasible candidates (``g <= slo`` in the request's lane —
  the same feasibility set every other strategy uses, so the plane's
  alternate/upstream cascade is unchanged), the primary is the argmax
  of the attainment probability, not the argmin of g;
* duplication is HEADROOM-GATED (the SafeTail economics the `paper3`
  bench rows measured): an extra copy goes only to candidates with
  ``g <= slo - headroom_margin`` — when the second-best candidate has
  no slack past the deadline a duplicate cannot rescue the tail and is
  pure added load, so none is sent. Up to ``redundancy - 1`` copies in
  ascending-g order (closest to the primary's latency first);
* infeasible windows degrade to exactly ``route_best``'s
  upstream-of-cheapest offload with no duplicates.

The per-tier loss/jitter tables live on
:class:`~repro_torch.control.admission.AdmissionConfig` (``link_loss`` /
``link_jitter`` / ``latency_sigma`` / ``headroom_margin``); the
simulator wires its ``FaultPlan.drop_prob`` straight into ``link_loss``
so the policy prices the same faults the event loop injects.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.policies.base import RoutingPolicyBase, WindowDecision
from repro_torch.core.latency_model import slo_attain_prob
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER


class ReliableSloPolicy(RoutingPolicyBase):
    """Route on P(meet SLO); duplicate only into SLO headroom."""

    name = "reliable"

    def __init__(self, cluster, router, config=None):
        super().__init__(cluster, router, config)
        cfg = self.cfg
        tiers = self.table.tiers
        # static per-candidate distribution parameters: baseline
        # dispersion plus the per-tier link jitter, and the link
        # delivery probability
        self._sigma = np.array(
            [cfg.latency_sigma + cfg.link_jitter.get(t, 0.0)
             for t in tiers], np.float64)
        self._avail = np.array(
            [1.0 - cfg.link_loss.get(t, 0.0) for t in tiers], np.float64)
        # fused-path device residency of the distribution columns
        # (float32, uploaded on the first fused flush)
        self._dist_cols = None

    def _fused_attain(self, lam: np.ndarray, slo: np.ndarray,
                      mask: np.ndarray, k: int, margin: float):
        """Whole-window attainment-argmax decision in one
        ``routing_attain`` call: primary = argmax of the
        delivery-weighted attainment probability, duplicate columns
        headroom-gated, the (R, I) matrix device-only. Returns host
        (idx (R, k), g (R, k), ok (R,))."""
        from repro_torch.kernels import ops
        if TRACER.on:
            TRACER.stage("admission.upload")
        if self._dist_cols is None:
            self._dist_cols = (self._upload(self._sigma),
                               self._upload(self._avail))
        sigma, avail = self._dist_cols
        cols = self._device_static()
        lam_d, slo_d, r = self._fused_rows(lam, slo, mask)
        erlang = self._erlang()
        if TRACER.on:
            TRACER.stage("admission.kernel")
        idx, g, ok = ops.routing_attain(
            lam_d, cols["alpha"], cols["beta"], cols["gamma"], cols["mu"],
            cols["n"], cols["rtt"], slo_d, sigma, avail, erlang,
            k=k, margin=float(margin), impl=self.cfg.backend)
        if TRACER.on:
            TRACER.stage("admission.download")
        return (self._download(idx[:r]), self._download(g[:r]),
                self._download(ok[:r]))

    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        lam, slo, mask = self.decision_rows(reqs, t_now)
        k_extra = max(int(self.cfg.redundancy) - 1, 0)
        margin = float(self.cfg.headroom_margin)
        r_n = len(reqs)

        if self.fused:
            idx_k, g_k, ok = self._fused_attain(lam, slo, mask,
                                                k=k_extra + 1, margin=margin)
            if TRACER.on:
                TRACER.stage("admission.settle")
            feasible = np.asarray(ok, bool).copy()
            primary = idx_k[:, 0].astype(np.int64)
            offload = np.zeros(r_n, bool)
            predicted = g_k[:, 0].astype(np.float64)
            for r in np.flatnonzero(~feasible):
                primary[r], offload[r] = self.cheapest_lane_upstream(mask[r])
            duplicates = tuple(
                tuple(int(j) for j in row if j >= 0)
                for row in idx_k[:, 1:])
            return WindowDecision(primary=primary, feasible=feasible,
                                  offload=offload, predicted=predicted,
                                  lam=lam, slo=slo, mask=mask, g=None,
                                  duplicates=duplicates)

        # vmap fallback: attainment over the full (R, I) matrix
        if TRACER.on:
            TRACER.stage("admission.kernel")
        g_t = self.score_tensor(lam)
        if TRACER.on:
            TRACER.stage("admission.download")
        g = self._download(g_t)
        if TRACER.on:
            TRACER.stage("admission.settle")
        p = self._avail[None, :] * slo_attain_prob(
            g, self._sigma[None, :], slo)
        primary = np.zeros(r_n, np.int64)
        offload = np.zeros(r_n, bool)
        feasible = np.zeros(r_n, bool)
        predicted = np.zeros(r_n, np.float64)
        duplicates: list[tuple] = []
        for r in range(r_n):
            feas = np.flatnonzero((g[r] <= slo[r]) & mask[r])
            if feas.size:
                # sort by g first, then stably by -p: attainment wins,
                # but ties (e.g. every candidate saturating at p=1.0
                # under a generous deadline) break toward the lower
                # point latency — exactly route_best's pick, so the
                # uniform-distribution case degrades to argmin g
                feas_g = feas[np.argsort(g[r, feas], kind="stable")]
                order = feas_g[np.argsort(-p[r, feas_g], kind="stable")]
                win = int(order[0])
                primary[r] = win
                feasible[r] = True
                predicted[r] = float(g[r, win])
                dups: tuple = ()
                if k_extra and feas.size > 1:
                    rest = feas[feas != win]
                    rest = rest[np.argsort(g[r, rest], kind="stable")]
                    dups = tuple(
                        int(j) for j in rest
                        if g[r, j] <= slo[r, j] - margin)[:k_extra]
                duplicates.append(dups)
            else:
                primary[r], offload[r] = self.cheapest_lane_upstream(mask[r])
                predicted[r] = float(np.min(g[r]))
                duplicates.append(())
        return WindowDecision(primary=primary, feasible=feasible,
                              offload=offload, predicted=predicted,
                              lam=lam, slo=slo, mask=mask, g=g,
                              duplicates=tuple(duplicates))
