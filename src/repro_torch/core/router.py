"""SLO-aware adaptive router — the paper's Algorithm 1 plus §IV-B selection.

Two layers:

* :func:`score_instances` / :func:`select_instance` — the batched torch
  per-request scoring hot path (§IV-B steps ii-iv): predict g_mi(lambda)
  for every candidate deployment from the in-memory table, mask
  infeasible ones (SLO or stability), argmin with cost tie-break. A
  hand-written CUDA kernel with the same decision semantics lives in
  ``repro_torch.kernels.routing_score``.

* :class:`Router` — the event-driven controller (Algorithm 1): per
  *service instance* in-memory telemetry (sliding rate + EWMA), x-scaled
  SLO, per-request offload guard, EWMA-predicted breach -> scale-out or
  fractional offload phi, idle -> scale-in.

One reading note on Algorithm 1: line 11 offloads the at-risk request and
returns. The offloaded request then *arrives at the upstream instance*,
whose own event-driven controller runs the same loop (every instance runs
LA-IMR — that is what makes the cloud tier scale under offloaded load).
We implement that one-hop arrival explicitly in :meth:`Router.on_request`;
without it the local tier would offload forever and no tier would ever
scale, which is visibly not the behaviour in the paper's Fig. 7.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import MetricsRegistry, ModelTelemetry

BIG = 1e9  # sentinel latency for infeasible candidates


def score_instances(lam: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor, gamma: torch.Tensor,
                    mu: torch.Tensor, n: torch.Tensor,
                    rtt: torch.Tensor) -> torch.Tensor:
    """Predicted end-to-end latency g_mi(lam) per deployment (Eq. 15).

    All inputs are (I,) float32 tensors over candidate deployments (or
    anything broadcasting against them); ``lam`` is the aggregate
    arrival rate each pool would see. Processing uses the calibrated
    affine power law on the per-replica rate, queueing uses Erlang-C,
    network adds the tier RTT. Unstable pools score BIG.
    """
    lam = lam.to(torch.float32)
    lam_tilde = lam / torch.clamp_min(n, 1.0)
    proc = alpha + beta * torch.pow(torch.clamp_min(lam_tilde, 0.0), gamma)
    q = queueing.mmc_wait(lam, n.to(torch.int32), mu, unstable_value=BIG)
    g = proc + rtt + q
    rho = lam / torch.clamp_min(n * mu, 1e-12)
    return torch.where(rho < 1.0, g, torch.full_like(g, BIG))


# the f32 constants of the pinned near band (jnp weak typing rounds
# ``1.0 + 1e-5`` and ``1e-9`` to float32 before the multiply-add)
_NEAR = float(np.float32(1.0 + 1e-5))
_EPS = float(np.float32(1e-9))


def select_instance(g: torch.Tensor, slo: torch.Tensor, cost: torch.Tensor,
                    candidate_mask: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """§IV-B steps iii-iv: filter feasible (g <= slo), argmin latency,
    tie-break by lower cost. Returns (index, feasible_any).

    Tie-break ('breaking ties by the lower cost to avoid unnecessary
    over-provisioning') is a two-stage argmin: find the feasible latency
    minimum, then the cheapest candidate within a relative epsilon of it.
    """
    idx, ok = select_instance_batch(g[None, :], slo, cost, candidate_mask)
    return idx[0], ok[0]


def score_instances_np(lam: float, alpha, beta, gamma, mu, n, rtt) -> np.ndarray:
    """numpy twin of :func:`score_instances` (control-plane call sites)."""
    alpha = np.asarray(alpha, np.float64)
    n = np.asarray(n, np.float64)
    lam_tilde = lam / np.maximum(n, 1.0)
    proc = alpha + np.asarray(beta) * np.power(np.maximum(lam_tilde, 0.0),
                                               np.asarray(gamma))
    q = np.array([queueing.mmc_wait_np(lam, np.array([int(nn)]), float(m))[0]
                  for nn, m in zip(np.atleast_1d(n), np.atleast_1d(mu))])
    q = np.where(np.isfinite(q), q, BIG)
    g = proc + np.asarray(rtt) + q
    rho = lam / np.maximum(n * np.asarray(mu), 1e-12)
    return np.where(rho < 1.0, np.minimum(g, BIG), BIG)


def score_instances_batch(lam: torch.Tensor, alpha: torch.Tensor,
                          beta: torch.Tensor, gamma: torch.Tensor,
                          mu: torch.Tensor, n: torch.Tensor,
                          rtt: torch.Tensor) -> torch.Tensor:
    """Batched scoring: ``lam`` is either (R,) per-request aggregate-rate
    estimates (each broadcast over every candidate) or an (R, I) matrix of
    per-request, per-candidate rates (the admission-window form: each pool
    is scored at its own arrival rate). Deployment params are (I,).
    Returns the (R, I) predicted latency matrix — the reference's
    ``vmap`` over :func:`score_instances` written as an explicit leading
    batch dimension, so each row equals the single-request path. The
    CUDA kernel in ``repro_torch.kernels.routing_score`` computes the
    same decision with a table-interpolated Erlang-C term.
    """
    lam = lam.to(torch.float32)
    if lam.ndim == 1:
        lam = lam[:, None].expand(lam.shape[0], alpha.shape[0])
    return score_instances(lam, alpha[None, :], beta[None, :],
                           gamma[None, :], mu[None, :], n[None, :],
                           rtt[None, :])


def select_instance_batch(g: torch.Tensor, slo, cost: torch.Tensor,
                          candidate_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise :func:`select_instance` over a (R, I) score matrix.

    ``slo`` and ``candidate_mask`` are either (I,) — shared across rows —
    or (R, I) — per-request SLO budgets / candidate lanes (the admission-
    window form). Returns (idx (R,) int64, feasible_any (R,) bool); a
    row with nothing feasible reports idx 0 (argmin over all-inf keys).
    """
    slo = queueing.as_f32(slo, g.device).expand(g.shape)
    mask = torch.as_tensor(candidate_mask, device=g.device).to(
        torch.bool).expand(g.shape)
    cost = queueing.as_f32(cost, g.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=g.device)
    feasible = (g <= slo) & mask
    g_masked = torch.where(feasible, g, inf)
    gmin = g_masked.amin(dim=1, keepdim=True)
    near = feasible & (g_masked <= gmin * _NEAR + _EPS)
    idx = torch.argmin(torch.where(near, cost[None, :].expand(g.shape), inf),
                       dim=1)
    return idx, feasible.any(dim=1)


def select_instance_scalar(g, slo, cost, candidate_mask) -> tuple[int, bool]:
    """Scalar/numpy twin of :func:`select_instance` for the per-request
    fallback loop — the PINNED decision-boundary semantics.

    The jit path computes scores and comparisons in float32 while the
    simulator's scalar predictor (:func:`score_instance_scalar`) runs
    float64, so a request sitting exactly on the SLO cutoff (or two
    candidates tied in latency) could route differently between the two
    paths. The contract is: *selection happens in float32*, with the same
    two-stage cost tie-break and the same ``near`` tolerance as
    :func:`select_instance`. Callers feeding float64 scores must accept
    the float32 rounding here — test_batch_router pins the equivalence on
    boundary cases (exact SLO hit, exact ties, near-ties at the 1e-5
    relative tolerance).
    """
    one = np.float32(1.0 + 1e-5)
    eps = np.float32(1e-9)
    g32 = np.asarray(g, np.float32)
    slo32 = np.broadcast_to(np.asarray(slo, np.float32), g32.shape)
    cost32 = np.asarray(cost, np.float32)
    mask = np.broadcast_to(np.asarray(candidate_mask, bool), g32.shape)
    feasible = (g32 <= slo32) & mask
    g_masked = np.where(feasible, g32, np.float32(np.inf))
    gmin = np.float32(g_masked.min()) if g_masked.size else np.float32(np.inf)
    near = feasible & (g_masked <= gmin * one + eps)
    idx = int(np.argmin(np.where(near, cost32, np.float32(np.inf))))
    return idx, bool(feasible.any())


def score_instance_scalar(lam: float, alpha: float, beta: float, gamma: float,
                          mu: float, n: float, rtt: float,
                          q: Optional[float] = None) -> float:
    """Scalar fast path of :func:`score_instances_np` for ONE deployment.

    The discrete-event simulator calls the predictor twice per arrival;
    the array version costs ~120 us in wrappers alone. This twin is
    BIT-IDENTICAL (``np.power`` on float64 scalars matches the array
    ufunc; Python ``**`` does not) and runs in ~1 us — test_router pins
    the equivalence over a parameter sweep.

    ``q`` optionally supplies a precomputed M/M/c wait (e.g. from a
    :class:`queueing.ErlangMemo`); every other float op stays shared, so
    alternate queue models cannot drift from the pinned proc/stability
    arithmetic. Default (None) evaluates ``mmc_wait_scalar`` inline.
    """
    nf = float(n)
    lam_tilde = lam / max(nf, 1.0)
    proc = alpha + beta * float(np.power(np.float64(max(lam_tilde, 0.0)),
                                         np.float64(gamma)))
    if q is None:
        q = queueing.mmc_wait_scalar(lam, int(n), mu)
    if not q < float("inf"):
        q = BIG
    g = proc + rtt + q
    rho = lam / max(nf * mu, 1e-12)
    return min(g, BIG) if rho < 1.0 else BIG


class Action(enum.Enum):
    LOCAL = "local"                    # routed to a local replica (line 28)
    OFFLOAD_FAST = "offload_fast"      # per-request SLO guard (line 11)
    OFFLOAD_FRACTION = "offload_frac"  # bulk offload fraction phi (line 22)


@dataclasses.dataclass
class Decision:
    action: Action
    target: Optional[Deployment]        # where the request goes
    scale_out: list = dataclasses.field(default_factory=list)
    scale_in: list = dataclasses.field(default_factory=list)
    phi: float = 0.0                    # bulk offload fraction (line 21)
    predicted_latency: float = 0.0
    lam: float = 0.0
    lam_accum: float = 0.0              # EWMA at the *target* deployment


@dataclasses.dataclass(frozen=True)
class RouterParams:
    """Algorithm 1 parameters (paper §V-A4 calibrated values)."""

    x: float = 2.25          # latency-budget multiplier (tau_m = x * L_m)
    ewma_alpha: float = 0.8  # EWMA weight on the old value
    rho_low: float = 0.3     # utilisation floor for scale-in
    window: float = 1.0      # sliding-window width [s]
    slo_includes_rtt: bool = True  # paper's tau=1.8s budgets the ~1s RTT in


_PREDICT_CACHE_CAP = 1 << 16  # wholesale-clear bound on the predict memo


class Router:
    """Event-driven LA-IMR controller (Algorithm 1), one loop per instance."""

    def __init__(self, cluster: Cluster,
                 params: Optional[RouterParams] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 rho_buckets: Optional[int] = None,
                 device: str = "cuda"):
        self.cluster = cluster
        # torch device of route_best's batched scorer (the card unless
        # the caller asks for the CPU); the scalar predictor is numpy
        self.device = torch.device(device)
        # a RouterParams() default would be ONE instance shared by every
        # Router built without explicit params (shared-SimConfig-default bug
        # class, now enforced by laimr-lint mutable-default)
        self.params = params if params is not None else RouterParams()
        self.metrics = metrics or MetricsRegistry()
        # per-deployment in-memory telemetry (the paper's in-process state)
        self.telemetry: dict[str, ModelTelemetry] = {}
        # Event-batched control: the scalar predictor is
        # called twice per arrival with heavily repeating (n, lam) keys —
        # sliding rates are quantised to 1/window and EWMAs hit IEEE
        # fixed points — so g_mi is memoised per (dep, n, lam, rtt).
        # Exact keys (default) return exactly score_instance_scalar's
        # values; ``rho_buckets`` enables the approximate bucketed
        # Erlang-C term (SimConfig.control_rho_buckets, default off).
        self._rho_buckets = rho_buckets
        self._pcache: dict[tuple, float] = {}
        self._erlang: dict[str, queueing.ErlangMemo] = {}

    def tel(self, dep_key: str) -> ModelTelemetry:
        t = self.telemetry.get(dep_key)
        if t is None:
            t = ModelTelemetry.create(self.params.ewma_alpha, self.params.window)
            self.telemetry[dep_key] = t
        return t

    # ------------------------------------------------------------------ #
    def slo_budget(self, dep: Deployment, req: Request) -> float:
        """tau_m = x * L_m^infer (Alg. 1 line 8), or the request's own tau_t.

        With ``slo_includes_rtt`` the budget also covers the tier RTT the
        way the paper's tau = 1.8 s 'budgets headroom for networking and
        queueing' on top of L ~= 0.8 s.
        """
        if req.slo is not None:
            return req.slo
        base = dep.model.l_ref / dep.instance.speedup
        tau = self.params.x * base
        if self.params.slo_includes_rtt:
            tau += dep.instance.net_rtt
        return tau

    def predict(self, dep: Deployment, lam: float,
                with_rtt: bool = True) -> float:
        """g_mi(lam) — scalar numpy evaluation of the in-memory table.

        ``with_rtt=False`` drops the network term: the paper's SLO
        tau = x * L_m budgets processing + queueing only — its own
        experiment has tau = 1.8 s while every request pays ~1 s of robot
        RTT on top (§V-A4), so the Algorithm-1 guard must compare the
        *controllable* latency against tau, not the RTT-inflated total.
        Tier selection (route_best) keeps the RTT so cross-tier
        comparisons stay honest.

        Memoised on (dep, n_replicas, lam, with_rtt): cache hits return
        the exact float produced by the uncached path, so simulated
        physics are bit-identical (golden digests pin this). The cache is
        cleared wholesale at a size cap — deterministic, no LRU churn."""
        key = (dep.key, dep.n_replicas, lam, with_rtt)
        cache = self._pcache
        g = cache.get(key)
        if g is None:
            rtt = dep.instance.net_rtt if with_rtt else 0.0
            if self._rho_buckets is None:
                g = score_instance_scalar(lam, dep.alpha, dep.beta,
                                          dep.gamma, dep.mu,
                                          dep.n_replicas, rtt)
            else:
                g = self._score_bucketed(dep, lam, rtt)
            if len(cache) >= _PREDICT_CACHE_CAP:
                cache.clear()
            cache[key] = g
        return g

    def _score_bucketed(self, dep: Deployment, lam: float,
                        rtt: float) -> float:
        """score_instance_scalar with the Erlang-C term read from the
        rho-bucketed :class:`queueing.ErlangMemo` — the approximate
        event-batched control mode (gated, default off). The proc /
        stability arithmetic is score_instance_scalar's own body (shared
        via its ``q`` parameter); only the queueing term comes from the
        bucket-representative rho."""
        memo = self._erlang.get(dep.key)
        if memo is None:
            memo = queueing.ErlangMemo(dep.mu, rho_buckets=self._rho_buckets)
            self._erlang[dep.key] = memo
        return score_instance_scalar(
            lam, dep.alpha, dep.beta, dep.gamma, dep.mu, dep.n_replicas,
            rtt, q=memo.wait(lam, int(dep.n_replicas)))

    def refresh_telemetry(self, t_now: float) -> list[tuple[Deployment, float]]:
        """Event-batched control-plane refresh (one call per HPA tick):
        decay every deployment's EWMA toward its current sliding rate and
        return the (deployment, lam_accum) pairs for a batched custom-
        metric export (:meth:`autoscaler.PMHPA.export_batch`). Replaces
        the per-deployment update/export interleave in the simulator's
        tick handler; the per-deployment float ops are unchanged, so the
        refresh is bit-identical to the scalar loop it batches."""
        out = []
        for dep in self.cluster:
            tel = self.tel(dep.key)
            out.append((dep, tel.ewma.update(tel.sliding.rate(t_now))))
        return out

    # ------------------------------------------------------------------ #
    def _control_pass(self, dep: Deployment, req: Request, t_now: float,
                      decision: Decision) -> None:
        """Algorithm 1 lines 14-27 at deployment ``dep``: EWMA update,
        predicted-breach scaling / bulk offload, idle scale-in."""
        p = self.params
        tel = self.tel(dep.key)
        lam_accum = tel.ewma.value                        # updated on arrival
        tau = self.slo_budget(dep, req)
        g_hat = self.predict(dep, lam_accum, with_rtt=False)   # line 16
        decision.lam_accum = lam_accum
        decision.predicted_latency = g_hat
        if g_hat > tau:                                   # line 17
            if dep.n_replicas < dep.n_max:                # line 18
                decision.scale_out.append(dep)            # line 19
                tel.scale_outs += 1
            else:                                         # line 20
                phi = min(1.0, (g_hat - tau) / max(g_hat, 1e-12))  # line 21
                upstream = self.cluster.upstream_of(dep)
                if upstream is not None and decision.action is Action.LOCAL:
                    decision.action = Action.OFFLOAD_FRACTION      # line 22
                    decision.target = upstream
                    decision.phi = phi
                    tel.offloaded_bulk += phi
        else:
            rho = dep.rho(lam_accum)
            if rho < p.rho_low and dep.n_replicas > 1:    # line 25
                decision.scale_in.append(dep)             # line 26
                tel.scale_ins += 1

    def on_request(self, req: Request, dep: Deployment, t_now: float) -> Decision:
        """Algorithm 1 for request r arriving at service instance (m, i)."""
        tel = self.tel(dep.key)
        lam, _ = tel.on_arrival(t_now)                    # lines 7, 15
        tau = self.slo_budget(dep, req)                   # line 8
        g_inst = self.predict(dep, lam, with_rtt=False)   # line 9

        upstream = self.cluster.upstream_of(dep)
        if g_inst > tau and upstream is not None:         # line 10
            # line 11: protect this request — it now ARRIVES at the
            # upstream instance, whose own controller loop runs.
            tel.offloaded_fast += 1
            req.offloaded = True
            decision = Decision(Action.OFFLOAD_FAST, upstream, lam=lam)
            up_tel = self.tel(upstream.key)
            up_tel.on_arrival(t_now)
            self._control_pass(upstream, req, t_now, decision)
            # keep the fast-offload action even if upstream is congested
            decision.action = Action.OFFLOAD_FAST
            decision.target = upstream
            return decision

        decision = Decision(Action.LOCAL, dep, lam=lam)
        self._control_pass(dep, req, t_now, decision)     # lines 14-27
        req.offloaded = decision.action is not Action.LOCAL
        return decision                                   # line 28

    # ------------------------------------------------------------------ #
    def route_best(self, req: Request, t_now: float,
                   candidates: Optional[list[Deployment]] = None) -> Decision:
        """§IV-B steps i-v: full selection across candidate deployments.

        Used when a request is not pre-bound to a deployment (the general
        routing problem, Eq. 18): score every candidate, filter by SLO,
        pick argmin latency with cost tie-break; if none feasible, offload
        upstream of the cheapest candidate.
        """
        cands = candidates if candidates is not None else \
            self.cluster.for_quality(req.quality) or list(self.cluster)
        lam_by_cand = []
        for d in cands:
            t = self.tel(d.key)
            lam_by_cand.append(t.sliding.rate(t_now))
        # the request would add itself to whichever pool it lands in
        lam_arr = np.asarray(lam_by_cand, np.float32) + 1.0 / self.params.window

        dev = self.device

        def col(vals) -> torch.Tensor:
            return torch.as_tensor(np.asarray(vals, np.float32), device=dev)

        g = score_instances(
            col(lam_arr), col([d.alpha for d in cands]),
            col([d.beta for d in cands]), col([d.gamma for d in cands]),
            col([d.mu for d in cands]), col([d.n_replicas for d in cands]),
            col([d.instance.net_rtt for d in cands]))
        slo = col([self.slo_budget(d, req) for d in cands])
        cost = col([d.instance.cost for d in cands])
        idx, ok = select_instance(g, slo, cost,
                                  torch.ones(len(cands), dtype=torch.bool,
                                             device=dev))
        g_host = g.cpu().numpy()
        if bool(ok):
            d = cands[int(idx)]
            self.tel(d.key).on_arrival(t_now)
            return Decision(Action.LOCAL, d,
                            predicted_latency=float(g_host[int(idx)]))
        cheapest = min(cands, key=lambda d: d.instance.cost)
        upstream = self.cluster.upstream_of(cheapest) or cheapest
        self.tel(upstream.key).on_arrival(t_now)
        self.tel(upstream.key).offloaded_fast += 1
        req.offloaded = upstream is not cheapest
        return Decision(Action.OFFLOAD_FAST, upstream,
                        predicted_latency=float(np.min(g_host)))
