"""Guard-faithful windowed Algorithm 1 — home tier + per-request guard.

The ROADMAP's "guard-faithful window policy" open item: windowed mode
previously routed route_best style (cross-tier argmin), which offloads
far more aggressively under saturation than the paper's Algorithm 1.
This strategy reproduces lines 8-11 of Algorithm 1 per window, as one
vectorised comparison:

* every request is bound to its HOME deployment (edge-first for its
  model — the simulator's ``_bind_deployment`` semantics);
* the guard compares the home tier's *controllable* predicted latency
  (processing + queueing, NO network RTT — the paper's tau = x * L_m
  budgets headroom for networking on top, see ``Router.predict``
  ``with_rtt=False``) against the request's tau;
* ``g_inst > tau -> upstream``: the at-risk request offloads one hop up
  (Alg. 1 line 11); everything else stays home. No cross-tier argmin,
  no alternate scan — slot pressure still cascades upstream through the
  plane's binding, exactly like a full home pool would.

The guard itself is ``(g[r, home] - rtt[home]) > tau[r, home]`` over the
whole window — one batched scoring call plus one vectorised comparison
(:func:`~repro_torch.kernels.routing_decide.apply_guard`), no
per-request predictor loop; the ``cuda`` backend runs the whole
decision as one ``routing_guard`` kernel launch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.control.policies.base import (RoutingPolicyBase,
                                               WindowDecision)
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER
from repro_torch.kernels.routing_decide import apply_guard


class GuardedAlgorithm1Policy(RoutingPolicyBase):
    """Home-tier window strategy with the paper's per-request offload
    guard (Algorithm 1 lines 8-11), vectorised per window."""

    name = "guarded_alg1"

    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        lam, slo, mask = self.decision_rows(reqs, t_now)

        tbl = self.table
        rows = np.arange(len(reqs))
        home = np.array([tbl.home_index(rq) for rq in reqs], np.int64)
        up = tbl.upstream[home]                       # -1 at the top tier
        tau = slo[rows, home]
        if self.fused:
            # score + guard + pick in one launch, no (R, I) matrix on the
            # host (the plane re-scores lazily through score_row on the
            # rare engine-overflow path); padded rows carry up = -1 so
            # the guard holds them home
            primary, g_sel, offload = self._fused(
                "routing_guard", ((lam, np.float32, 0), (tau, np.float32, 0),
                                  (home, np.int32, 0), (up, np.int32, -1)))
            if TRACER.on:
                TRACER.stage("admission.settle")
            primary = primary.astype(np.int64)
            g = None
            predicted = g_sel.astype(np.float64)
        else:
            # vmap path: full score matrix on the device, then the shared
            # guard (Alg. 1 line 10) over the home column
            if TRACER.on:
                TRACER.stage("admission.kernel")
            g_t = self.score_tensor(lam)
            home_t = self.resident.upload(home, np.int64)
            up_t = self.resident.upload(up, np.int64)
            g_home = g_t[torch.arange(len(reqs), device=g_t.device), home_t]
            target, off = apply_guard(
                g_home, self.resident.columns()["rtt"][home_t],
                self.resident.upload(tau), up_t, up_t >= 0, home_t)
            if TRACER.on:
                TRACER.stage("admission.download")
            g = self._download(g_t)
            offload = self._download(off)
            primary = self._download(target)
            if TRACER.on:
                TRACER.stage("admission.settle")
            predicted = g[rows, primary].astype(np.float64)
        # Alg. 1 line 7: the request ARRIVES at its home instance before
        # the guard protects it, so the home tier's telemetry must see
        # the arrival even when the request then offloads — otherwise
        # the home EWMA starves, PM-HPA scales the pool in, and every
        # later window offloads forever (the scalar path records this
        # arrival in Router.on_request; the plane's settle only records
        # the TARGET, which for guarded offloads is the upstream).
        deps = self.deps
        for r in np.flatnonzero(offload):
            self.router.tel(deps[int(home[r])].key).on_arrival(t_now)
        # feasible=False everywhere: guarded requests bind straight
        # through the upstream cascade (home or one hop up) — Algorithm 1
        # has no feasible-alternates argmin to fall back on.
        feasible = np.zeros(len(reqs), bool)
        return WindowDecision(primary=primary, feasible=feasible,
                              offload=offload, predicted=predicted,
                              lam=lam, slo=slo, mask=mask, g=g)
