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
from repro_torch.kernels.routing_decide import apply_guard


class GuardedAlgorithm1Policy(RoutingPolicyBase):
    """Home-tier window strategy with the paper's per-request offload
    guard (Algorithm 1 lines 8-11), vectorised per window."""

    name = "guarded_alg1"

    def _fused_guard(self, lam: np.ndarray, tau: np.ndarray,
                     home: np.ndarray, up: np.ndarray):
        """Score + guard + pick in ONE ``routing_guard`` call — no (R, I)
        matrix ever reaches the host. Padded rows carry up = -1 so the
        guard holds them home; they are sliced off. Returns host
        (primary (R,) int64, g_sel (R,), offload (R,))."""
        from repro_torch.kernels import ops
        cols = self._device_static()
        r = lam.shape[0]
        _, padded = self._pad_block(r)
        lam32 = lam.astype(np.float32)
        tau32 = tau.astype(np.float32)
        home32 = home.astype(np.int32)
        up32 = up.astype(np.int32)
        if padded > r:
            pad = padded - r
            lam32 = np.concatenate(
                [lam32, np.zeros((pad, lam.shape[1]), np.float32)])
            tau32 = np.concatenate([tau32, np.zeros(pad, np.float32)])
            home32 = np.concatenate([home32, np.zeros(pad, np.int32)])
            up32 = np.concatenate([up32, np.full(pad, -1, np.int32)])
        idx, g_sel, off = ops.routing_guard(
            self._upload(lam32), cols["alpha"], cols["beta"], cols["gamma"],
            cols["mu"], cols["n"], cols["rtt"], self._upload(tau32),
            self._upload(home32, np.int32), self._upload(up32, np.int32),
            self._erlang(), impl=self.cfg.backend)
        return (idx[:r].cpu().numpy().astype(np.int64),
                g_sel[:r].cpu().numpy(), off[:r].cpu().numpy())

    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        lam = self.lam_matrix(reqs, t_now)
        slo = self.slo_rows(reqs)
        mask = self.mask_rows(reqs)

        tbl = self.table
        rows = np.arange(len(reqs))
        home = np.array([self.home_index(rq) for rq in reqs], np.int64)
        up = tbl.upstream[home]                       # -1 at the top tier
        tau = slo[rows, home]
        if self.fused:
            # whole decision in one kernel launch; the plane re-scores
            # lazily through score_row on the rare engine-overflow path
            primary, g_sel, offload = self._fused_guard(lam, tau, home, up)
            g = None
            predicted = g_sel.astype(np.float64)
        else:
            # vmap path: full score matrix on the device, then the shared
            # guard (Alg. 1 line 10) over the home column
            g_t = self.score_tensor(lam)
            home_t = self._upload(home, np.int64)
            up_t = self._upload(up, np.int64)
            g_home = g_t[torch.arange(len(reqs), device=g_t.device), home_t]
            target, off = apply_guard(
                g_home, self._device_static()["rtt"][home_t],
                self._upload(tau), up_t, up_t >= 0, home_t)
            g = g_t.cpu().numpy()
            offload = off.cpu().numpy()
            primary = target.cpu().numpy()
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
