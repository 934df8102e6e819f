"""Bucketed twin of the discrete-event fleet simulator, in PyTorch.

The counterpart of the reference package's ``core/jaxsim.py`` (whose
name it keeps, as ``SimConfig.backend="jax"`` keeps its spelling).
``simulate`` runs the physics the event loop integrates: the Eq. 5
utilisation-dependent service law, the Algorithm-1 offload guard and
fractional bulk offload, the PM-HPA inverse-model feasibility scan with
scale-in hysteresis, boot-lagged scale enactment and placement-aware
pod admission (first-fit declaration order, or the jsq coldest-pod
waterfill with replica-quota scale-out). It steps fixed-width time
buckets instead of a heap of events: deployments and pods are dense
``(I, P)`` float32 tensors, arrivals are pre-binned ``(B, S)`` counts
(one column per model stream), and each bucket routes in one batched
pass through the control plane's float32 score/select semantics
(``router.select_instance_batch``, ``routing_decide.apply_guard``).

One step function (:func:`_step`) advances one bucket. On the CPU it
runs eagerly, bucket after bucket. On the card the carry lives in static
device buffers and the bucket counter on the device; ``graph_buckets``
buckets are captured into one CUDA graph (the stand-in for
``lax.scan``), a one-bucket graph takes the remainder of a run, and a
third graph holds a bucket with the HPA tick. The host picks among them
from the precomputed tick mask, replays them with no sync in between,
and reads the per-bucket outputs back once at the end.

Equivalence contract: the event loop stays the oracle. This twin is
distribution-pinned against it: P50/P99 and the offload rate within
:data:`TOLERANCES`, arrival conservation exact (every arrival produces
exactly one latency sample). Its deliberate approximations are the
reference's: telemetry advances per bucket; the fractional bulk offload
rounds ``m * phi`` with a per-deployment carry; service jitter enters
capacity as its lognormal mean and per-request draws from the seeded
generator are applied in the latency post-pass; queueing delay is
reconstructed from the served-work ledger; scale-in drains pods
instead of respilling their queues.

Scope: ``mode="laimr"``, the scalar Algorithm-1 path
(``admission_window == 0``) and the ``route_best`` / ``guarded_alg1``
windowed policies, empty ``FaultPlan``. Anything else raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.catalogue import Cluster
from repro_torch.core.router import BIG, RouterParams, select_instance_batch
from repro_torch.core.workload import Arrival
from repro_torch.kernels.routing_decide import apply_guard

__all__ = ["simulate", "TOLERANCES", "GRAPH_BUCKETS"]

# Declared distribution-equivalence tolerances against the event-loop
# oracle (the reference's values). Percentiles are relative, the
# offload rate absolute.
TOLERANCES = {"p50_rel": 0.25, "p99_rel": 0.35, "offload_abs": 0.12}

#: buckets captured into one CUDA graph on the card
GRAPH_BUCKETS = 16

F32 = torch.float32


# --------------------------------------------------------------------- #
# static scan configuration
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class _Static:
    mode: str            # "scalar" | "route_best" | "guarded_alg1"
    multi: bool          # pods_per_deployment > 1
    placement: str       # "first_fit" | "jsq" (pod admission + quota)
    dt: float
    window: float        # router sliding-window width [s]
    erl_n: int           # Erlang scan length (>= every n_max)
    n_probe: int         # PM-HPA feasibility grid size
    ewma_alpha: float
    rho_low: float
    util_cap: float
    gamma_runtime: float
    e_jitter: float      # E[lognormal(0, sigma)] = exp(sigma^2 / 2)


def _erlang_wait(lam: torch.Tensor, c: torch.Tensor, mu: torch.Tensor,
                 ks: torch.Tensor) -> torch.Tensor:
    """Expected M/M/c wait: the inverse-Erlang-B recurrence
    ``invb_k = 1 + (k / a) invb_{k-1}`` over ``k = 1 .. len(ks)`` in
    float32, gathered at ``c`` (``ks`` holds 1 .. n as float32). Each
    step is one multiply and one add over the whole array."""
    a = lam / mu
    ka = ks.view((-1,) + (1,) * a.dim()) / a          # (n, *a.shape)
    invbs = torch.empty_like(ka)
    one = torch.ones_like(a)
    prev = one
    for ka_k, invb in zip(ka.unbind(0), invbs.unbind(0)):
        torch.mul(ka_k, prev, out=invb)
        prev = invb.add_(one)
    idx = torch.clamp(c.to(torch.int64) - 1, 0, ks.shape[0] - 1)
    invb_c = invbs.gather(0, idx.expand(a.shape).unsqueeze(0)).squeeze(0)
    b = 1.0 / invb_c
    c_f = c.to(F32)
    rho = lam / (c_f * mu)
    cc = b / torch.clamp_min(1.0 - rho * (1.0 - b), 1e-30)
    cc = torch.clamp(cc, 0.0, 1.0)
    q = cc / torch.clamp_min(c_f * mu - lam, 1e-12)
    return torch.where(rho < 1.0, q, BIG)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with tensor or
    number bounds."""
    x = torch.clamp_min(x, lo) if not isinstance(lo, torch.Tensor) \
        else torch.maximum(x, lo)
    return torch.clamp_max(x, hi) if not isinstance(hi, torch.Tensor) \
        else torch.minimum(x, hi)


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Each entry's position in its row's stable ascending order (ties,
    such as the ``inf`` of every inactive pod, keep column order)."""
    order = torch.argsort(key, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def _one_hot(idx: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``jax.nn.one_hot`` as float32: ``idx[..., None] == cols``."""
    return (idx.unsqueeze(-1) == cols).to(F32)


# --------------------------------------------------------------------- #
# one bucket
# --------------------------------------------------------------------- #
def _score(c: dict, lam, n, rtt, st: _Static) -> torch.Tensor:
    """router.score_instances semantics (float32): affine power law +
    Erlang-C, BIG when unstable."""
    lam_tilde = lam / torch.clamp_min(n, 1.0)
    proc = c["alpha_k"] + c["beta_k"] * torch.pow(
        torch.clamp_min(lam_tilde, 0.0), c["gamma_k"])
    q = _erlang_wait(lam, n.to(torch.int32), c["mu_k"], c["ks"])
    g = proc + rtt + q
    rho = lam / torch.clamp_min(n * c["mu_k"], 1e-12)
    return torch.where(rho < 1.0, g, BIG)


def _hpa_tick(c: dict, st: _Static, nr, bl, drn, ring, pend, droll, ewma,
              b):
    """Router.refresh_telemetry (decay the EWMA toward the sliding rate),
    then PMHPA.export (inverse-model n*, hysteresis) and reconcile.
    Returns the new state and the scale events and pods drained."""
    I = nr.shape[0]  # noqa: E741 - candidate count, the paper's I
    rate_now = droll / c["window"]
    ewma = st.ewma_alpha * ewma + (1.0 - st.ewma_alpha) * rate_now
    n_cur = torch.clamp_min(((~drn) * nr).sum(dim=1), 1.0)
    lam = ewma[:, None]                                   # (I, 1)
    ngrid = c["ngrid"]                                    # (1, n_probe)
    rho_n = lam / (ngrid * c["mu"][:, None])
    q = _erlang_wait(lam.expand(I, st.n_probe),
                     ngrid.expand(I, st.n_probe).to(torch.int32),
                     c["mu"][:, None].expand(I, st.n_probe), c["ks"])
    # desired_replicas: util WITHOUT the sim's util_cap clamp, and the
    # CALIBRATION gamma (dep.gamma), not gamma_runtime
    util = torch.clamp_min(
        (lam / ngrid * c["r_demand"][:, None]
         + c["background"][:, None]) / c["r_max"][:, None], 0.0)
    proc = c["svc_base"][:, None] * (
        1.0 + torch.pow(util, c["gamma_cal"][:, None]))
    feas = (rho_n < 1.0) & (proc + q <= c["tau_hpa"][:, None])
    any_f = feas.any(dim=1)
    n_star = torch.where(any_f, torch.argmax(feas.to(F32), dim=1) + 1.0,
                         float(st.n_probe))
    n_star = torch.where(ewma <= 0.0, 1.0, n_star)
    rho_cur = ewma / torch.clamp_min(n_cur * c["mu"], 1e-12)
    n_star = torch.where((n_star < n_cur) & (rho_cur >= st.rho_low),
                         n_cur, n_star)
    want = _clip(n_star, 1.0, c["n_max"])
    fire = want != n_cur
    boot_col = torch.remainder(b + c["k_boot"], ring.shape[1])
    onehot = _one_hot(boot_col, c["ring_cols"])
    if st.multi:
        spp = c["spp"]
        active = (nr > 0.0) & (~drn)
        n_act = active.sum(dim=1, dtype=F32)
        cur_pods = n_act + pend
        ready_tot = nr.sum(dim=1)
        if st.placement == "jsq":
            # replica-quota enactment: boot whatever pod count covers
            # `want` replicas; the n_max clamp happens at boot maturation
            have = ready_tot + pend * spp
            boot = torch.ceil(torch.clamp_min(want - have, 0.0) / spp) * fire
            want_pods = torch.clamp_min(torch.ceil(want / spp), 1.0)
            do_drain = fire & (want < ready_tot)
        else:
            want_pods = _clip(torch.ceil(want / spp), 1.0, c["max_pods"])
            boot = torch.clamp_min(want_pods - cur_pods, 0.0) * fire
            do_drain = fire & (want_pods < cur_pods) & \
                (want < ready_tot + pend * spp)
        ring = ring + boot[:, None] * onehot
        pend = pend + boot
        k = torch.where(do_drain,
                        torch.minimum(cur_pods - want_pods, n_act - 1.0), 0.0)
        key = torch.where(active, bl, math.inf)
        sel = active & (_rank(key).to(F32) < k[:, None])
        drn = drn | sel
        drained = sel.sum(dtype=F32)
    else:
        current = nr.sum(dim=1) + pend
        diff = torch.where(fire, want - current, 0.0)
        boot = torch.clamp_min(diff, 0.0)
        ring = ring + boot[:, None] * onehot
        pend = pend + boot
        down = torch.clamp_min(-diff, 0.0)
        nr0 = nr[:, 0]
        nr = torch.where(down > 0.0, torch.clamp_min(nr0 - down, 1.0),
                         nr0)[:, None]                    # P == 1
        drained = c["zero"]
    return nr, drn, ring, pend, ewma, fire.sum(dtype=F32), drained


def _step(c: dict, st: _Static, carry: tuple, a_row: torch.Tensor,
          b: torch.Tensor, tick: bool):
    """Advance one bucket. ``a_row`` is the bucket's (S,) float32 arrival
    counts, ``b`` its index (a 0-d int64 tensor), ``tick`` whether the
    HPA reconciles in it. Returns the new carry and the bucket's outputs
    ``(backlog at start, admitted, service time, ready replicas,
    served)``, each (I, P)."""
    (nr, bl, drn, ring, pend, pring, proll, dring, droll,
     ewma, bcarry, ctr) = carry
    I = nr.shape[0]  # noqa: E741
    # per-bucket counter increments: offloaded, bulk-offloaded, pods
    # booted, pods drained, scale events
    inc = [c["zero"]] * 5

    # -- 1. boots mature (replica-granular single / pod-granular) --
    rslot = torch.remainder(b, ring.shape[1])
    hit = c["ring_cols"] == rslot
    mature = (ring * hit).sum(dim=1)
    ring = torch.where(hit, 0.0, ring)
    pend = pend - mature
    if st.multi:
        inactive = (nr <= 0.0) & (~drn)
        crank = torch.cumsum(inactive.to(F32), dim=1)
        act = inactive & (crank <= mature[:, None])
        nr = torch.where(act, c["spp"][:, None], nr)
        if st.placement == "jsq":
            # _PodFleet._boot_size: the booting pod is clamped to the
            # remaining n_max headroom (cumulative trim, pod order)
            csum = torch.cumsum(nr, dim=1)
            over = torch.clamp_min(csum - c["n_max"][:, None], 0.0)
            nr = torch.clamp_min(nr - over, 0.0)
        inc[2] = act.sum(dtype=F32)                       # pods booted
    else:
        nr = nr + mature[:, None]                         # P == 1

    # -- 2. HPA tick (refresh EWMA -> export n* -> reconcile) ------
    if tick:
        nr, drn, ring, pend, ewma, inc[4], inc[3] = _hpa_tick(
            c, st, nr, bl, drn, ring, pend, droll, ewma, b)

    # -- 3. routing (one batched score/select per bucket) ----------
    wslot = torch.remainder(b, dring.shape[1])
    whit = c["win_cols"] == wslot
    droll_d = droll - (dring * whit).sum(dim=1)   # drop the oldest bucket
    m_home = (a_row[:, None] * c["H"]).sum(dim=0)             # (I,)
    n_route = torch.clamp_min(((~drn) * nr).sum(dim=1), 1.0)

    if st.mode == "scalar":
        # Algorithm 1 per bucket: the guard's sliding rate includes the
        # bucket's own home arrivals, the bulk pass reads the EWMA
        lam_guard = (droll_d + m_home) / c["window"]
        lam2 = torch.cat([lam_guard, ewma])
        g2 = _score(c, lam2, torch.cat([n_route, n_route]), 0.0, st)
        g_inst, g_hat = g2[:I], g2[I:]
        has_up = c["has_up"]
        off = (g_inst > c["tau_req"]) & has_up & (m_home > 0.0)
        m_off = torch.where(off, m_home, 0.0)
        m_stay = m_home - m_off
        at_cap = n_route >= c["n_max"] - 0.5
        elig = (~off) & has_up & at_cap & \
            (g_hat > c["tau_req"]) & (m_stay > 0.0)
        phi = _clip((g_hat - c["tau_req"])
                    / torch.clamp_min(g_hat, 1e-12), 0.0, 1.0)
        frac = m_stay * phi + bcarry
        m_bulk = torch.where(elig, torch.minimum(torch.floor(frac), m_stay),
                             0.0)
        bcarry = torch.where(elig, frac - m_bulk, bcarry)
        moved = m_off + m_bulk
        arrivals_dep = m_stay - m_bulk + (moved[:, None] * c["U"]).sum(0)
        obs = m_home + (m_off[:, None] * c["U"]).sum(0)
        inc[0] = m_off.sum()
        inc[1] = torch.where(elig, m_stay * phi, 0.0).sum()
    else:
        # Windowed plane: arrivals are bucketed by FLUSH time, so this
        # bucket's count is the flush batch and the lam_matrix smear's
        # batch mean is (m_tot + 1) / (2 * window)
        m_tot = a_row.sum()
        smear = (m_tot + 1.0) / c["window2"]
        lam_c = droll_d / c["window"] + smear
        g = _score(c, lam_c, n_route, c["rtt"], st)
        if st.mode == "guarded_alg1":
            # one guard surface with the routing_guard kernel and
            # guarded.decide (routing_decide.apply_guard)
            hidx = c["home_s"]
            target, off_s = apply_guard(
                g[hidx], c["rtt"][hidx], c["tau_s"], c["up_s"],
                c["has_up_s"], hidx)
        else:                                  # route_best
            S = c["home_s"].shape[0]
            gm = g[None, :].expand(S, I)
            idx, ok = select_instance_batch(gm, c["slo_rows"], c["cost"],
                                            c["lane_rows"])
            target = torch.where(ok, idx, c["fb_col"])
            off_s = (~ok) & c["fb_off"]
        th = _one_hot(target, c["dep_cols"])                  # (S, I)
        arrivals_dep = (a_row[:, None] * th).sum(dim=0)
        obs = arrivals_dep
        if st.mode == "guarded_alg1":
            # the guard observes the HOME tier for offloaded rows on top
            # of the plane's target settle (guarded.decide)
            obs = obs + ((a_row * off_s)[:, None] * c["H"]).sum(dim=0)
        inc[0] = (a_row * off_s).sum()

    # Per-arrival EWMA decay, closed form for m observations (every
    # mode's telemetry advances the EWMA once per observed arrival)
    lam_end = (droll_d + obs) / c["window"]
    a_m = torch.pow(c["ewma_alpha"], obs)
    ewma = a_m * ewma + (1.0 - a_m) * lam_end

    # -- 4. pod admission: first-fit idle slots, then equalise -----
    # (jsq skips the declaration-order pre-take: every admission goes
    # through the backlog-ranked waterfill, coldest pods first)
    m = arrivals_dep
    active = (nr > 0.0) & (~drn)
    if st.placement == "jsq":
        take = torch.zeros_like(nr)
    else:
        idle = torch.clamp_min(torch.floor(nr - bl), 0.0) * active
        cum_excl = torch.cumsum(idle, dim=1) - idle
        take = torch.floor(_clip(m[:, None] - cum_excl, 0.0, idle))
    rem = m - take.sum(dim=1)
    n_act = torch.clamp_min(active.sum(dim=1, dtype=F32), 1.0)
    base = torch.floor(rem / n_act)
    extra = rem - base * n_act
    key = torch.where(active, bl + take, math.inf)
    xasg = take + active * (base[:, None] + (_rank(key) < extra[:, None]))

    # -- 5. Eq. 5 service physics per pod --------------------------
    bl_start = bl
    proll_d = proll - (pring * whit).sum(dim=2)
    lam_pool = (proll_d + xasg) / c["window"]
    n_eff = torch.clamp_min(nr, 1e-9)
    lam_til = torch.where(nr > 1.0, lam_pool / n_eff, lam_pool)
    util = _clip(
        (lam_til * c["r_demand"][:, None]
         + c["background"][:, None]) / c["r_max"][:, None],
        0.0, st.util_cap)
    s_det = c["svc_base"][:, None] * (
        1.0 + torch.pow(util, st.gamma_runtime))
    cap = nr * st.dt / (s_det * st.e_jitter)
    load = bl + xasg
    served = torch.minimum(load, cap)
    bl = load - served
    emptied = drn & (bl <= 1e-6)
    nr = torch.where(emptied, 0.0, nr)
    drn = drn & ~emptied

    # -- 6. telemetry rings ----------------------------------------
    pring = torch.where(whit, xasg[:, :, None], pring)
    proll = proll_d + xasg
    dring = torch.where(whit, obs[:, None], dring)
    droll = droll_d + obs
    ctr = ctr + torch.stack(inc)

    carry = (nr, bl, drn, ring, pend, pring, proll, dring, droll,
             ewma, bcarry, ctr)
    return carry, (bl_start, xasg, s_det, nr, served)


# --------------------------------------------------------------------- #
# the scan: eager on the CPU, CUDA graphs on the card
# --------------------------------------------------------------------- #
def _scan_eager(c, st, carry, A, tick_mask):
    """Every bucket in order, one eager step each. Returns the final
    carry and the stacked outputs (B, 5, I, P)."""
    ys = []
    bs = torch.arange(A.shape[0], device=A.device)
    for b in range(A.shape[0]):
        carry, y = _step(c, st, carry, A[b], bs[b], bool(tick_mask[b]))
        ys.append(torch.stack(y))
    return carry, torch.stack(ys)


def _replay_plan(tick_mask: np.ndarray, k: int) -> list:
    """The graphs to replay in order: ``k`` (k buckets), ``1`` (one
    bucket) or ``"tick"`` (one bucket with the HPA tick)."""
    plan = []
    start = 0
    ticks = np.flatnonzero(tick_mask).tolist()
    for t in ticks + [tick_mask.size]:
        run = t - start
        plan += [k] * (run // k) + [1] * (run % k)
        if t < tick_mask.size:
            plan.append("tick")
        start = t + 1
    return plan


def _scan_static(c, st, carry0, A, tick_mask, k: int, capture: bool,
                 stats=None):
    """The same steps over static buffers: the carry, a bucket counter
    on the device that each advance moves on, and a preallocated
    (B, 5, I, P) output buffer each bucket's outputs go to with
    ``index_copy_``. With ``capture`` (the card) every advance of the
    replay plan is captured once into a CUDA graph and the plan replays
    the graphs with nothing synced until the read-back; without it (a
    check of the same bookkeeping on the CPU) each advance runs eagerly.
    Returns the final carry and the outputs."""
    dev = A.device
    state = [t.clone() for t in carry0]
    bdev = torch.zeros((), dtype=torch.int64, device=dev)
    ys = torch.zeros((A.shape[0], 5) + tuple(carry0[0].shape), dtype=F32,
                     device=dev)
    plan = _replay_plan(tick_mask, k)
    kinds = sorted(set(plan), key=str)

    def advance(kind):
        n, tick = (1, True) if kind == "tick" else (kind, False)
        carry = tuple(state)
        for j in range(n):
            b = bdev + j
            a_row = A.index_select(0, b.view(1))[0]
            carry, y = _step(c, st, carry, a_row, b, tick)
            ys.index_copy_(0, b.view(1), torch.stack(y)[None])
        for s, v in zip(state, carry):
            s.copy_(v)
        bdev.add_(n)

    if capture:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for kind in kinds:          # warm-up: lazy loads, allocator
                advance(kind)
            for s, v in zip(state, carry0):
                s.copy_(v)
            bdev.zero_()
        torch.cuda.current_stream(dev).wait_stream(side)
        run = {}
        for kind in kinds:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                advance(kind)
            run[kind] = g.replay
    else:
        run = {kind: functools.partial(advance, kind) for kind in kinds}
    span = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if capture and stats is not None else None
    if span:
        span[0].record()
    for kind in plan:
        run[kind]()
    if span:
        span[1].record()
    if stats is not None:
        stats.update(graph_buckets=k, graphs=len(run), replays=len(plan),
                     replay_events=span)
    return tuple(state), ys


# --------------------------------------------------------------------- #
def _validate(cluster: Cluster, cfg) -> str:
    """Reject configurations the twin does not model. Returns the scan
    mode string."""
    if cfg.mode != "laimr":
        raise ValueError(
            "backend='jax' models mode='laimr' only (the reactive "
            "baseline autoscaler is event-loop only)")
    if not cfg.faults.empty():
        raise ValueError("backend='jax' does not model fault injection; "
                         "use backend='event' for FaultPlan runs")
    if cfg.control_rho_buckets is not None:
        raise ValueError("backend='jax' does not model rho-bucketed "
                         "control (control_rho_buckets)")
    if cfg.admission_window <= 0.0:
        return "scalar"
    if cfg.policy not in ("route_best", "guarded_alg1"):
        raise ValueError(
            f"backend='jax' supports policies route_best/guarded_alg1 in "
            f"window mode, not {cfg.policy!r} (redundant-dispatch racing "
            "and the hybrid burst detector are event-loop only)")
    return cfg.policy


def simulate(cluster: Cluster, cfg, arrivals: list[Arrival],
             horizon: Optional[float] = None, *,
             graph_buckets: int = GRAPH_BUCKETS,
             stats: Optional[dict] = None):
    """Run the bucketed twin on ``cfg.twin_device``. Pure in (cluster,
    cfg, arrivals): the cluster's ``n_replicas`` and telemetry are never
    mutated. On the card ``graph_buckets`` buckets make one CUDA graph
    (0 steps eagerly, as on the CPU); ``stats``, when given, receives
    the bucket count and, on the card, the graph counts, the replays and
    a pair of CUDA events around them (``replay_events``)."""
    from repro_torch.core.simulator import SimResult  # imports us lazily

    mode = _validate(cluster, cfg)
    dev = torch.device(cfg.twin_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SimConfig.twin_device is 'cuda' but no CUDA "
                           "device is available; pass twin_device='cpu'")
    if not arrivals:
        return SimResult(completed=[], scale_events=[], offload_fast=0,
                         offload_bulk=0.0, n_events=0,
                         latency_trace=np.zeros(0), n_arrivals=0,
                         backend="jax")

    params: RouterParams = cfg.router
    dt = float(cfg.bucket_width)
    if dt <= 0.0:
        raise ValueError("bucket_width must be > 0")
    window = float(params.window)
    deps = list(cluster)
    I = len(deps)  # noqa: E741
    keys = [d.key for d in deps]
    dindex = {k: i for i, k in enumerate(keys)}

    # ---- static per-deployment constants (f32 like the score path) ----
    alpha = np.array([d.alpha for d in deps], np.float32)
    beta = np.array([d.beta for d in deps], np.float32)
    gamma_cal = np.array([d.gamma for d in deps], np.float32)
    mu = np.array([d.mu for d in deps], np.float32)
    rtt = np.array([d.instance.net_rtt for d in deps], np.float32)
    cost = np.array([d.instance.cost for d in deps], np.float32)
    n0 = np.array([d.n_replicas for d in deps], np.float32)
    n_max = np.array([d.n_max for d in deps], np.float32)
    svc_base = np.array([d.model.l_ref / d.instance.speedup for d in deps],
                        np.float32)
    r_demand = np.array([d.model.r_demand for d in deps], np.float32)
    background = np.array([d.instance.background for d in deps], np.float32)
    r_max = np.array([d.instance.r_max for d in deps], np.float32)

    up = np.full(I, -1, np.int64)
    for i, d in enumerate(deps):
        u = cluster.upstream_of(d)
        if u is not None and u.key != d.key:
            up[i] = dindex[u.key]
    U = np.zeros((I, I), np.float32)
    for i in range(I):
        if up[i] >= 0:
            U[i, up[i]] = 1.0

    # Request-guard tau (Router.slo_budget) and the PM-HPA export tau
    # (x * L_m, NO rtt and NO cfg.slo override — PMHPA.export's own).
    if cfg.slo is not None:
        tau_req = np.full(I, cfg.slo, np.float32)
    else:
        tau_req = params.x * svc_base + \
            (rtt if params.slo_includes_rtt else 0.0)
        tau_req = tau_req.astype(np.float32)
    tau_hpa = (params.x * svc_base).astype(np.float32)

    # ---- streams: one column per model, home = edge-first binding -----
    model_names: list[str] = []
    sidx_of: dict[str, int] = {}
    midx = np.empty(len(arrivals), np.int64)
    for j, a in enumerate(arrivals):
        s = sidx_of.get(a.model)
        if s is None:
            s = sidx_of[a.model] = len(model_names)
            model_names.append(a.model)
        midx[j] = s
    S = len(model_names)
    home_s = np.empty(S, np.int64)
    for s, mname in enumerate(model_names):
        cands = [i for i, d in enumerate(deps) if d.model.name == mname]
        if not cands:
            raise ValueError(f"no deployment serves model {mname!r}")
        edge = [i for i in cands if deps[i].instance.tier == "edge"]
        home_s[s] = (edge or cands)[0]
    H = np.zeros((S, I), np.float32)
    H[np.arange(S), home_s] = 1.0

    # windowed-policy per-stream tables (lane masks, slo rows, the
    # route_best infeasible fallback = cheapest_lane_upstream, static)
    lane_rows = np.zeros((S, I), bool)
    for s in range(S):
        q = deps[home_s[s]].quality
        lane = np.array([d.quality == q for d in deps])
        lane_rows[s] = lane if lane.any() else True
    slo_rows = np.broadcast_to(tau_req, (S, I)).copy()
    fb_col = np.empty(S, np.int64)
    fb_off = np.zeros(S, bool)
    for s in range(S):
        lane = np.flatnonzero(lane_rows[s])
        ci = int(lane[np.argmin(cost[lane])])
        u = int(up[ci])
        fb_col[s], fb_off[s] = (u, True) if u >= 0 else (ci, False)

    # ---- bucketise arrivals -------------------------------------------
    t_arr = np.fromiter((a.t for a in arrivals), np.float64,
                        count=len(arrivals))
    M = len(arrivals)
    adm_delay = None
    if mode != "scalar":
        # The plane buffers each arrival until its window flushes (open +
        # admission_window, or early when the max_batch-th submit closes
        # the window); routing, settle telemetry and queueing happen at
        # FLUSH time, so bucket by flush time and carry the
        # arrival->flush delay into the final latency.
        w_adm = float(cfg.admission_window)
        mb = max(1, int(cfg.admission_max_batch))
        t_flush = np.empty(M, np.float64)
        j = 0
        while j < M:
            close = t_arr[j] + w_adm
            k = min(int(np.searchsorted(t_arr, close, side="right")),
                    j + mb)
            if k == j + mb and t_arr[k - 1] < close:
                close = float(t_arr[k - 1])   # max_batch early close
            t_flush[j:k] = close
            j = k
        adm_delay = t_flush - t_arr
        t_arr = t_flush
    t_last = float(t_arr[-1])
    tail = int(math.ceil(3.0 * window / dt))
    B = int(t_last / dt) + 1 + tail
    bs_arr = np.minimum((t_arr / dt).astype(np.int64), B - 1)
    A = np.bincount(bs_arr * S + midx, minlength=B * S) \
        .reshape(B, S).astype(np.int32)
    if adm_delay is not None:
        # per-bucket mean flush delay (every request in a bucket shares
        # its window's flush instant, so the in-bucket spread is < w)
        dsum = np.bincount(bs_arr, weights=adm_delay, minlength=B)
        dcnt = np.maximum(np.bincount(bs_arr, minlength=B), 1)
        dmean = dsum / dcnt
    else:
        dmean = np.zeros(B, np.float64)

    end = horizon if horizon is not None else t_last + 120.0
    tick_mask = np.zeros(B, bool)
    k = 1
    while k * cfg.hpa_period <= end:
        bt = int(k * cfg.hpa_period / dt)
        if bt >= B:
            break
        tick_mask[bt] = True
        k += 1

    # ---- pods / boot ring / rate rings --------------------------------
    P = max(1, int(cfg.pods_per_deployment))
    multi = P > 1
    placement = str(getattr(cfg, "placement", "first_fit"))
    spp = np.maximum(1.0, np.ceil(n0 / P)).astype(np.float32)
    # pod quota: first_fit floors (digest-pinned capacity quantisation);
    # jsq ceils (a remainder-sized pod lands the fleet on n_max exactly)
    if not multi:
        max_pods = np.ones(I, np.float32)
    elif placement == "jsq":
        max_pods = np.maximum(1.0, np.ceil(n_max / spp)).astype(np.float32)
    else:
        max_pods = np.maximum(1.0, np.floor(n_max / spp)).astype(np.float32)
    if not multi:
        pmax = 1
    elif placement == "jsq":
        # replica-quota boots aren't pod-count capped: transiently the
        # fleet can hold the initial pods PLUS a full quota of fresh boots
        pmax = int((np.ceil(n0 / spp) + np.ceil(n_max / spp)).max())
    else:
        pmax = int(max(np.ceil(n0 / spp).max(), max_pods.max()))
    nr0 = np.zeros((I, pmax), np.float32)
    for i in range(I):
        if multi:
            rem = n0[i]
            p = 0
            while rem > 0 and p < pmax:
                nr0[i, p] = min(spp[i], rem)
                rem -= nr0[i, p]
                p += 1
        else:
            nr0[i, 0] = n0[i]
    startup = np.array([d.startup_delay for d in deps], np.float64)
    k_boot = np.maximum(1, np.round(startup / dt)).astype(np.int64)
    R = int(k_boot.max()) + 1
    W = max(1, int(round(window / dt)))

    st = _Static(
        mode=mode, multi=multi, placement=placement, dt=dt, window=window,
        erl_n=int(max(64, n_max.max())),
        n_probe=64, ewma_alpha=float(params.ewma_alpha),
        rho_low=float(params.rho_low), util_cap=float(cfg.util_cap),
        gamma_runtime=float(cfg.gamma_runtime),
        e_jitter=float(np.exp(cfg.jitter_sigma ** 2 / 2.0)))

    # scoring constants, tiled x2 for the scalar mode's stacked
    # (guard-rate, EWMA) call
    tile = 2 if mode == "scalar" else 1
    consts = {
        "gamma_cal": gamma_cal, "mu": mu,
        "rtt": rtt, "cost": cost, "n_max": n_max, "svc_base": svc_base,
        "r_demand": r_demand, "background": background, "r_max": r_max,
        "tau_req": tau_req, "tau_hpa": tau_hpa,
        "has_up": up >= 0, "U": U, "H": H,
        "home_s": home_s, "up_s": np.maximum(up[home_s], 0),
        "has_up_s": up[home_s] >= 0, "tau_s": tau_req[home_s],
        "lane_rows": lane_rows, "slo_rows": slo_rows.astype(np.float32),
        "fb_col": fb_col, "fb_off": fb_off,
        "spp": spp, "max_pods": max_pods, "k_boot": k_boot,
        "alpha_k": np.tile(alpha, tile), "beta_k": np.tile(beta, tile),
        "gamma_k": np.tile(gamma_cal, tile), "mu_k": np.tile(mu, tile),
        # Python numbers of the reference as float32 device scalars, so
        # a division by them is an IEEE division on every device
        "window": np.float32(window),
        "window2": np.float32(2.0 * window),
        "ewma_alpha": np.float32(params.ewma_alpha),
        "zero": np.float32(0.0),
        # index columns and grids
        "ks": np.arange(1, st.erl_n + 1, dtype=np.float32),
        "ngrid": np.arange(1, st.n_probe + 1, dtype=np.float32)[None, :],
        "ring_cols": np.arange(R, dtype=np.int64),
        "win_cols": np.arange(W, dtype=np.int64),
        "dep_cols": np.arange(I, dtype=np.int64),
    }

    with torch.inference_mode():
        c = {k2: torch.as_tensor(v).to(dev) for k2, v in consts.items()}
        carry0 = (
            torch.as_tensor(nr0).to(dev),                    # n_ready (I, P)
            torch.zeros((I, pmax), dtype=F32, device=dev),   # backlog
            torch.zeros((I, pmax), dtype=torch.bool, device=dev),  # draining
            torch.zeros((I, R), dtype=F32, device=dev),      # boot ring
            torch.zeros(I, dtype=F32, device=dev),           # pending boots
            torch.zeros((I, pmax, W), dtype=F32, device=dev),  # pod rate ring
            torch.zeros((I, pmax), dtype=F32, device=dev),   # pod rolling sum
            torch.zeros((I, W), dtype=F32, device=dev),      # dep rate ring
            torch.zeros(I, dtype=F32, device=dev),           # dep rolling sum
            torch.zeros(I, dtype=F32, device=dev),           # EWMA
            torch.zeros(I, dtype=F32, device=dev),           # bulk carry
            torch.zeros(5, dtype=F32, device=dev),           # counters
        )
        A_dev = torch.as_tensor(A).to(dev, F32)
        if dev.type == "cuda" and graph_buckets > 0:
            with torch.cuda.device(dev):
                carry_out, ys = _scan_static(c, st, carry0, A_dev,
                                             tick_mask, graph_buckets,
                                             capture=True, stats=stats)
        else:
            carry_out, ys = _scan_eager(c, st, carry0, A_dev, tick_mask)
        ctr = carry_out[-1].cpu().numpy().astype(np.float64)
        ys = ys.cpu().numpy().astype(np.float64)      # (B, 5, I, P)
    if stats is not None:
        stats["buckets"] = B
    bl_start, s_det, nr_b, served = ys[:, 0], ys[:, 2], ys[:, 3], ys[:, 4]
    xasg = np.rint(ys[:, 1]).astype(np.int64)

    routed = int(xasg.sum())
    if routed != M:
        raise RuntimeError(
            f"jaxsim conservation violation: routed {routed} != "
            f"{M} arrivals")

    # ---- latency post-pass: walk the served-work ledger ---------------
    rng = np.random.default_rng(cfg.seed)
    jit_all = rng.lognormal(mean=0.0, sigma=cfg.jitter_sigma, size=M)
    lat = np.empty(M, np.float64)
    cursor = 0
    e_jit = st.e_jitter
    for i in range(I):
        for p in range(pmax):
            xc = xasg[:, i, p]
            tot = int(xc.sum())
            if tot == 0:
                continue
            nz = np.flatnonzero(xc)
            bsc = np.repeat(nz, xc[nz])
            ends = np.cumsum(xc[nz])
            ks = np.arange(tot) - np.repeat(ends - xc[nz], xc[nz])
            n_b = np.maximum(nr_b[bsc, i, p], 1.0)
            need = bl_start[bsc, i, p] + ks - n_b + 1.0
            C = np.concatenate([[0.0], np.cumsum(served[:, i, p])])
            target = C[bsc] + need
            idx = np.searchsorted(C[1:], target, side="left")
            idx_c = np.minimum(idx, B - 1)
            sb = served[idx_c, i, p]
            frac = np.clip((target - C[idx_c]) / np.maximum(sb, 1e-12),
                           0.0, 1.0)
            start = (idx_c + frac) * dt
            over = idx >= B
            if over.any():
                s_l = s_det[B - 1, i, p] * e_jit
                n_l = max(nr_b[B - 1, i, p], 1.0)
                start = np.where(
                    over, B * dt + (target - C[B]) * s_l / n_l, start)
            wait = np.maximum(start - (bsc + 0.5) * dt, 0.0)
            queued = need > 0.0
            wait = np.where(queued, wait, 0.0)
            own_b = np.where(queued, idx_c, bsc)
            own = s_det[own_b, i, p] * jit_all[cursor:cursor + tot]
            lat[cursor:cursor + tot] = (wait + own + float(rtt[i])
                                        + dmean[bsc])
            cursor += tot
    assert cursor == M

    return SimResult(
        completed=[], scale_events=[],
        offload_fast=int(round(ctr[0])),
        offload_bulk=float(ctr[1]),
        # comparable event accounting: one arrival + one service end per
        # request, plus one control step per bucket
        n_events=2 * M + B,
        pods_booted=int(round(ctr[2])) if multi else 0,
        pods_drained=int(round(ctr[3])) if multi else 0,
        pod_stats={}, failed=[],
        latency_trace=lat, n_arrivals=M, backend="jax")
