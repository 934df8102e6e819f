"""Shared routing-policy machinery: ONE calibrated latency model, every
strategy.

The paper's central claim is that a single in-memory latency model
drives both millisecond-scale routing and proactive capacity planning.
This module is that model's *decision substrate*: every routing
strategy — cross-tier argmin
(:class:`~repro_torch.control.policies.route_best.RouteBestPolicy`), the
paper's guarded home-tier Algorithm 1
(:class:`~repro_torch.control.policies.guarded.GuardedAlgorithm1Policy`),
SafeTail redundant dispatch, SLO-attainment routing and the
burst-adaptive hybrid — shares literally the same candidate table, batched scorer and
decision-boundary contract:

* :class:`CandidateTable` — the static per-deployment parameter arrays
  (alpha/beta/gamma/mu/rtt/cost, SLO budgets tau_m, quality-lane masks,
  key -> column index) plus the per-flush ``n_replicas`` refresh;
* :class:`RoutingPolicyBase` — batched scoring + selection over an
  (R, I) decision matrix: one ``score_instances_batch`` (or one CUDA
  ``routing_score`` kernel launch) per window, vectorised SLO filter +
  f32-pinned two-stage cost tie-break, the float64 scalar reference
  loop used by parity tests and benchmarks, and the
  :meth:`RoutingPolicyBase.decide` strategy hook the
  :class:`~repro_torch.control.plane.ControlPlane` drives;
* :class:`WindowDecision` — the strategy output: per-request primary
  target, feasibility/offload flags, predicted latency, redundant
  dispatch targets, plus the (R, I) context arrays the plane needs for
  the lazy engine-overflow fallback.

Admission-window semantics
--------------------------
Within a window of R requests the pool arrival rates are read ONCE at
flush time; request r (0-based position in decision order) is scored at

    lam[r, i] = rate_i(t_flush) + (r + 1) / window_width

i.e. each request sees the window's earlier arrivals as additional load,
uniformly smeared over all candidates (their destinations are unknown at
scoring time). For R == 1 this reduces exactly to ``route_best``'s
``rate + 1/window`` self-contribution.

Scalar/batched decision-boundary contract
-----------------------------------------
The scalar control-plane predictor (``score_instance_scalar``) runs
float64 while the batched torch / CUDA paths run float32, so a request
sitting exactly on the SLO cutoff — or two candidates tied in latency —
could route differently between paths. The pinned semantics: *selection
happens in float32* with the two-stage cost tie-break and the 1e-5
relative ``near`` tolerance of ``select_instance``. The scalar reference
loop (:meth:`RoutingPolicyBase.route_window_scalar`) therefore casts its
float64 scores to float32 before filtering/tie-breaking (via
``select_instance_scalar``); tests/test_batch_router.py pins the
boundary cases.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from repro_torch.control.admission import AdmissionConfig
from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.router import (BIG, Router, score_instance_scalar,
                               score_instances_batch, select_instance_batch,
                               select_instance_scalar)
from repro_torch.core.scheduler import Request
from repro_torch.core.telemetry import TRACER

#: admission backends: the batched torch scorer with the exact Erlang-C
#: recurrence (the semantics reference), the CUDA decision kernels, and
#: their plain torch versions (any device)
BACKENDS = ("vmap", "cuda", "ref")


class CandidateTable:
    """Static candidate-deployment arrays (the in-memory table, §IV-B).

    Built once per (cluster, router params); only ``n_replicas`` moves at
    run time and is re-read per flush via :meth:`n`. Lane masks implement
    ``route_best``'s ``for_quality(q) or list(cluster)`` fallback: an
    empty lane sees every candidate.
    """

    def __init__(self, cluster: Cluster, router: Router):
        self.deps: list[Deployment] = list(cluster)
        self.index: dict[str, int] = {d.key: i
                                      for i, d in enumerate(self.deps)}
        self.alpha = np.array([d.alpha for d in self.deps], np.float32)
        self.beta = np.array([d.beta for d in self.deps], np.float32)
        self.gamma = np.array([d.gamma for d in self.deps], np.float32)
        self.mu = np.array([d.mu for d in self.deps], np.float32)
        self.rtt = np.array([d.instance.net_rtt for d in self.deps],
                            np.float32)
        self.cost = np.array([d.instance.cost for d in self.deps],
                             np.float32)
        # per-candidate network tier ("edge" / "cloud") — reliability
        # policies key per-link loss/jitter tables off it
        self.tiers: list[str] = [d.instance.tier for d in self.deps]
        # dep-derived SLO budgets tau_m (x * L_m [+ rtt]) — fixed per
        # cluster+params; per-request slo overrides patch rows at flush.
        _probe = Request(model="", quality=self.deps[0].quality, arrival=0.0)
        self.tau = np.array(
            [router.slo_budget(d, _probe) for d in self.deps], np.float32)
        # upstream topology as a column map: upstream[i] = index of the
        # tier candidate i offloads to, -1 at the top tier (static, like
        # Cluster._upstream, so guard policies vectorise over it).
        self.upstream = np.full(len(self.deps), -1, np.int64)
        for i, d in enumerate(self.deps):
            up = cluster.upstream_of(d)
            if up is not None and up.key != d.key:
                self.upstream[i] = self.index[up.key]
        self.lane_mask: dict = {}
        for d in self.deps:
            q = d.quality
            if q not in self.lane_mask:
                m = np.array([dd.quality == q for dd in self.deps])
                self.lane_mask[q] = m if m.any() else \
                    np.ones(len(self.deps), bool)
        self.all_mask = np.ones(len(self.deps), bool)

    def __len__(self) -> int:
        return len(self.deps)

    def n(self) -> np.ndarray:
        return np.array([d.n_replicas for d in self.deps], np.float32)


@dataclasses.dataclass
class WindowDecision:
    """One strategy's verdict over a flushed window of R requests.

    The plane interprets each row r uniformly:

    * ``feasible[r]`` True  -> bind ``primary[r]`` through the
      feasible-alternates slot cascade (winner -> next-best feasible ->
      upstream -> reject);
    * ``feasible[r]`` False -> bind ``primary[r]`` directly through the
      upstream cascade, labelling the settle OFFLOADED iff
      ``offload[r]`` (the strategy already moved the request off its
      home/lane tier before any slot pressure).

    ``duplicates[r]`` lists extra candidate indices to dispatch
    redundant copies to (SafeTail-style); empty tuples everywhere for
    single-dispatch strategies. ``lam``/``slo``/``mask`` are the (R, I)
    context arrays; ``g`` is the full score matrix when the backend
    produced one (None on the fused kernel paths) — the plane uses these
    for the lazy engine-overflow re-score, exactly as before the
    strategy split.
    """

    primary: np.ndarray                 # (R,) int candidate index
    feasible: np.ndarray                # (R,) bool
    offload: np.ndarray                 # (R,) bool
    predicted: np.ndarray               # (R,) float predicted latency
    lam: np.ndarray                     # (R, I)
    slo: np.ndarray                     # (R, I)
    mask: np.ndarray                    # (R, I)
    g: Optional[np.ndarray] = None      # (R, I) scores, None when fused
    duplicates: tuple = ()              # per-request extra target tuples

    def dup_row(self, r: int) -> tuple:
        return self.duplicates[r] if self.duplicates else ()


class RoutingPolicyBase:
    """The swappable LA-IMR decision object (simulator == serving engine).

    Stateless apart from the candidate table and the device-resident
    column / Erlang-table caches; telemetry reads go through the composed :class:`Router` so the
    policy sees whatever arrival history its adapter maintains.
    Subclasses implement :meth:`decide` — everything else (decision-
    matrix construction, batched score+select, the scalar reference) is
    shared, so strategies cannot drift on scoring semantics.
    """

    #: registry key; subclasses override (see policies/__init__.py)
    name: ClassVar[str] = "base"

    def __init__(self, cluster: Cluster, router: Router,
                 config: Optional[AdmissionConfig] = None):
        self.cluster = cluster
        self.router = router
        self.cfg = config or AdmissionConfig()
        if self.cfg.backend not in BACKENDS:
            raise ValueError(f"unknown admission backend "
                             f"{self.cfg.backend!r}; expected one of "
                             f"{BACKENDS}")
        self.device = torch.device(self.cfg.device)
        if self.cfg.backend == "cuda" and self.device.type != "cuda":
            # no hidden fallback: the kernel backend never quietly runs
            # the plain version on another device
            raise ValueError(f"backend='cuda' runs the CUDA kernels and "
                             f"needs a CUDA device, got device="
                             f"{self.cfg.device!r} (use backend='ref' for "
                             "the plain versions)")
        self.table = CandidateTable(cluster, router)
        # fused-path Erlang table, rebuilt only when replica counts move
        self._erlang_table: Optional[torch.Tensor] = None
        self._erlang_key: Optional[tuple] = None
        # device-resident candidate columns: the six static columns
        # upload ONCE per policy, n re-uploads only when a replica count
        # moves (the flush span's h2d counters show it)
        self._dev_cols: Optional[dict] = None
        self._n_key: Optional[tuple] = None

    @property
    def deps(self) -> list[Deployment]:
        return self.table.deps

    # ---------------- fused-backend plumbing --------------------------- #
    @property
    def fused(self) -> bool:
        """True when the whole window decision runs as one fused routing
        call (the CUDA kernel or its plain version) rather than
        score-matrix + Python."""
        return self.cfg.backend in ("cuda", "ref")

    def _upload(self, arr: np.ndarray, dtype=np.float32) -> torch.Tensor:
        """A host array as a contiguous tensor on this policy's device."""
        host = np.ascontiguousarray(arr, dtype)
        if TRACER.on:
            TRACER.h2d(host.nbytes)
        return torch.as_tensor(host, device=self.device)

    @staticmethod
    def _download(t: torch.Tensor) -> np.ndarray:
        """A decision tensor read back to the host (blocking)."""
        host = t.cpu().numpy()
        if TRACER.on:
            TRACER.d2h(host.nbytes)
        return host

    def _device_static(self) -> dict:
        """The candidate table's device residency (see __init__)."""
        tbl = self.table
        if self._dev_cols is None:
            self._dev_cols = {
                "alpha": self._upload(tbl.alpha),
                "beta": self._upload(tbl.beta),
                "gamma": self._upload(tbl.gamma),
                "mu": self._upload(tbl.mu),
                "rtt": self._upload(tbl.rtt),
                "cost": self._upload(tbl.cost),
            }
        n = tbl.n()
        key = tuple(int(x) for x in n)
        if self._n_key != key:
            self._dev_cols["n"] = self._upload(n)
            self._n_key = key
        return self._dev_cols

    def _erlang(self) -> torch.Tensor:
        """(I, T) Erlang-C wait table on the device, keyed like the n
        column."""
        tbl = self.table
        n = tbl.n()
        key = tuple(int(x) for x in n)
        if self._erlang_key != key:
            from repro_torch.kernels.routing_score import build_erlang_table
            self._erlang_table = self._upload(build_erlang_table(
                tbl.mu, n.astype(np.int64), t=self.cfg.erlang_table_size))
            self._erlang_key = key
        return self._erlang_table

    def _pad_block(self, r: int) -> tuple[int, int]:
        """(block_r, padded rows) for a window of r requests: rows pad to
        the next power of two (>= 8) capped at ``cfg.block_r``, so the
        fused launches see a handful of bucketed shapes across arbitrary
        flush sizes."""
        p2 = 1 << max(3, (r - 1).bit_length())
        block = min(self.cfg.block_r, p2)
        padded = ((r + block - 1) // block) * block
        if TRACER.on:
            TRACER.pad(padded)
        return block, padded

    def _fused_rows(self, lam: np.ndarray, slo: np.ndarray,
                    mask: np.ndarray):
        """Per-flush device inputs for the fused kernels: lane masks fold
        into the SLO rows (excluded candidate -> slo = -1, infeasible
        since g >= 0), rows pad to the shape bucket. Returns
        (lam (P, I) device, slo (P, I) device, r)."""
        slo_eff = np.where(mask, slo, np.float32(-1.0)).astype(np.float32)
        r = lam.shape[0]
        _, padded = self._pad_block(r)
        lam = lam.astype(np.float32)
        if padded > r:
            zrow = np.zeros((padded - r, lam.shape[1]), np.float32)
            lam = np.concatenate([lam, zrow], axis=0)
            slo_eff = np.concatenate([slo_eff, zrow], axis=0)
        return self._upload(lam), self._upload(slo_eff), r

    def _fused_topk(self, lam: np.ndarray, slo: np.ndarray,
                    mask: np.ndarray, k: int, margin: float = 0.0):
        """Whole-window top-k decision in one ``routing_topk`` call:
        route_best primary in column 0, the next k-1 feasible candidates
        ascending by g (headroom-gated by ``margin``) after it, -1
        padding. Returns host (idx (R, k), g (R, k), ok (R,))."""
        from repro_torch.kernels import ops
        if TRACER.on:
            TRACER.stage("admission.upload")
        cols = self._device_static()
        lam_d, slo_d, r = self._fused_rows(lam, slo, mask)
        erlang = self._erlang()
        if TRACER.on:
            TRACER.stage("admission.kernel")
        idx, g, ok = ops.routing_topk(
            lam_d, cols["alpha"], cols["beta"], cols["gamma"], cols["mu"],
            cols["n"], cols["rtt"], slo_d, cols["cost"], erlang,
            k=k, margin=float(margin), impl=self.cfg.backend)
        if TRACER.on:
            TRACER.stage("admission.download")
        return (self._download(idx[:r]), self._download(g[:r]),
                self._download(ok[:r]))

    # ---------------- strategy hook ----------------------------------- #
    def decide(self, reqs: list[Request], t_now: float) -> WindowDecision:
        """Route one flushed window (decision order). Subclass hook."""
        raise NotImplementedError

    # ---------------- decision-matrix construction -------------------- #
    def decision_rows(self, reqs: list[Request], t_now: float):
        """The window's (lam, slo, mask) rows, the flush's rates
        stage."""
        if TRACER.on:
            TRACER.stage("admission.rates")
        return (self.lam_matrix(reqs, t_now), self.slo_rows(reqs),
                self.mask_rows(reqs))

    def lam_matrix(self, reqs: list[Request], t_now: float) -> np.ndarray:
        """(R, I) per-request, per-candidate rate estimates (module doc)."""
        tbl = self.table
        rates = np.array(
            [self.router.tel(d.key).sliding.rate(t_now) for d in tbl.deps],
            np.float32)
        r = len(reqs)
        self_load = (np.arange(1, r + 1, dtype=np.float32)
                     / np.float32(self.router.params.window))
        return rates[None, :] + self_load[:, None]

    def mask_rows(self, reqs: list[Request]) -> np.ndarray:
        tbl = self.table
        masks = [tbl.lane_mask.get(rq.quality, tbl.all_mask) for rq in reqs]
        return np.stack(masks, axis=0)

    def slo_rows(self, reqs: list[Request]) -> np.ndarray:
        tbl = self.table
        slo = np.broadcast_to(tbl.tau, (len(reqs), len(tbl.deps))).copy()
        for r, rq in enumerate(reqs):
            if rq.slo is not None:
                slo[r, :] = np.float32(rq.slo)
        return slo

    # ---------------- batched score + select -------------------------- #
    def score_select(self, lam: np.ndarray, slo: np.ndarray,
                     mask: np.ndarray):
        """One batched score+select over the (R, I) decision matrix.
        Returns (idx (R,), ok (R,), g_best (R,) or None, g (R, I) or
        None) — exactly one of g_best/g is provided, depending on the
        backend."""
        if self.fused:
            idx, g_best, ok = self._fused_select(lam, slo, mask)
            return idx, ok, g_best, None
        # the scores stay on the device between score and select (whose
        # reads fall in the kernel stage)
        if TRACER.on:
            TRACER.stage("admission.kernel")
        g = self.score_tensor(lam)
        idx, ok = self.select_batch(g, slo, mask)
        if TRACER.on:
            TRACER.stage("admission.download")
        return idx, ok, None, self._download(g)

    def select_batch(self, g, slo: np.ndarray,
                     mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Row-wise f32 SLO filter + latency argmin + cost tie-break
        over a score matrix (device tensor or host array). The ONE
        selection semantics every strategy shares. Returns (idx (R,),
        ok (R,))."""
        g_t = g if isinstance(g, torch.Tensor) else self._upload(g)
        idx, ok = select_instance_batch(
            g_t, self._upload(slo), self._device_static()["cost"],
            self._upload(mask, bool))
        return self._download(idx), self._download(ok)

    def cheapest_lane_upstream(self, mask_row: np.ndarray
                               ) -> tuple[int, bool]:
        """``route_best``'s infeasible fallback, shared so strategies
        cannot drift on it: the upstream of the cheapest candidate in
        the request's lane — or that candidate itself at the top tier,
        in which case the request never left its tier (not an offload).
        Returns (primary column, offload flag)."""
        tbl = self.table
        lane = np.flatnonzero(mask_row)
        ci = int(lane[np.argmin(tbl.cost[lane])])
        up = int(tbl.upstream[ci])
        return (up, True) if up >= 0 else (ci, False)

    def score_tensor(self, lam: np.ndarray) -> torch.Tensor:
        """(R, I) predicted-latency matrix through the batched scorer,
        left on the device."""
        cols = self._device_static()
        return score_instances_batch(
            self._upload(lam), cols["alpha"], cols["beta"], cols["gamma"],
            cols["mu"], cols["n"], cols["rtt"])

    def score_matrix(self, lam: np.ndarray) -> np.ndarray:
        """(R, I) predicted-latency matrix through the batched scorer —
        the semantics reference every strategy shares, and the path for
        strategies running without a fused backend."""
        return self._download(self.score_tensor(lam))

    def score_row(self, lam_row: np.ndarray) -> np.ndarray:
        """(I,) scores for one request — the engine-overflow re-score
        path (rare: only when the winner's engine is full and the
        backend returned no (R, I) score matrix)."""
        return self.score_matrix(lam_row[None, :])[0]

    def _fused_select(self, lam: np.ndarray, slo: np.ndarray,
                      mask: np.ndarray):
        """Kernel-backed score+select: one ``routing_score`` call with
        the per-request SLO rows (lane restrictions folded in as slo =
        -1). Returns host (idx (R,), g_best (R,), ok (R,))."""
        from repro_torch.kernels import ops
        if TRACER.on:
            TRACER.stage("admission.upload")
        cols = self._device_static()
        lam_d, slo_d, r = self._fused_rows(lam, slo, mask)
        erlang = self._erlang()
        if TRACER.on:
            TRACER.stage("admission.kernel")
        idx, g_best, ok = ops.routing_score(
            lam_d, cols["alpha"], cols["beta"], cols["gamma"], cols["mu"],
            cols["n"], cols["rtt"], slo_d, cols["cost"], erlang,
            impl=self.cfg.backend)
        if TRACER.on:
            TRACER.stage("admission.download")
        return (self._download(idx[:r]), self._download(g_best[:r]),
                self._download(ok[:r]))

    # ---------------- home-tier binding (guard strategies) ------------ #
    def home_index(self, req: Request) -> int:
        """Column index of the request's home deployment — the simulator's
        edge-first binding (``_bind_deployment``) over the candidate
        table, memoised per (model, quality). Falls back to the first
        candidate in the request's lane when no deployment serves the
        model (synthetic workloads)."""
        cache = getattr(self, "_home_idx", None)
        if cache is None:
            cache = self._home_idx = {}
        key = (req.model, req.quality)
        h = cache.get(key)
        if h is None:
            tbl = self.table
            same = [i for i, d in enumerate(tbl.deps)
                    if d.model.name == req.model]
            if same:
                edge = [i for i in same
                        if tbl.deps[i].instance.tier == "edge"]
                h = (edge or same)[0]
            else:
                lane = np.flatnonzero(
                    tbl.lane_mask.get(req.quality, tbl.all_mask))
                h = int(lane[0])
            cache[key] = h
        return h

    # ---------------- float64 scalar reference ------------------------ #
    def route_window_scalar(self, reqs: list[Request],
                            t_now: float) -> tuple[np.ndarray, np.ndarray]:
        """Scalar per-request reference for one admission window.

        Scores each (request, candidate) pair with the float64
        control-plane predictor (``score_instance_scalar``) and selects
        with the pinned float32 two-stage tie-break
        (``select_instance_scalar``) — the decision-boundary contract in
        the module docstring. Reads telemetry without mutating it.
        Returns (idx (R,), ok (R,)).
        """
        lam = self.lam_matrix(reqs, t_now)
        slo = self.slo_rows(reqs)
        mask = self.mask_rows(reqs)
        deps = self.deps
        cost = self.table.cost
        idxs = np.zeros(len(reqs), np.int64)
        oks = np.zeros(len(reqs), bool)
        for r in range(len(reqs)):
            g64 = [score_instance_scalar(float(lam[r, i]), d.alpha, d.beta,
                                         d.gamma, d.mu, d.n_replicas,
                                         d.instance.net_rtt)
                   for i, d in enumerate(deps)]
            idxs[r], oks[r] = select_instance_scalar(
                np.asarray(g64, np.float32), slo[r], cost, mask[r])
        return idxs, oks


# re-exported so strategy modules share one sentinel with the scorer
__all__ = ["BACKENDS", "BIG", "CandidateTable", "RoutingPolicyBase",
           "WindowDecision"]
