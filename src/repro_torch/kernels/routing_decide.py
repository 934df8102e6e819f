"""Whole-policy routing decisions in one launch each, and
:func:`apply_guard`, the guard arithmetic every path shares.

Three hand-written CUDA kernels in ``csrc/routing.cu``, each replacing
the TPU kernel of the same name in ``src/repro/kernels/routing_decide.py``:

* :func:`routing_guard` (``routing_guard_kernel``, ``guarded_alg1``):
  each row scores its home and upstream columns, applies the paper's
  guard ``(g_home - rtt_home) > tau -> upstream`` and keeps the column
  it picks; a block stages the candidates in shared memory where it can
  hold them (I <= GUARD_STAGE_MAX);
* :func:`routing_topk` (``routing_topk_kernel``, ``safetail``): the
  route_best primary plus the next ``k - 1`` feasible candidates in
  ascending g, headroom-gated by ``g <= slo - margin``;
* :func:`routing_attain` (``routing_attain_kernel``, ``reliable``): the
  primary maximises the delivery-weighted SLO-attainment probability,
  duplicates as in ``routing_topk``.

``routing_topk`` and ``routing_attain`` share ``routing_score_kernel``'s
body and launch plan (``routing_score.row_plan``): each pair scored
once.

CUDA tensors go to the kernel (or the wrapper raises); CPU tensors go
to the plain versions in ``repro_torch.kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import refuse_grad

UNSTABLE_G = 1e9    # router.BIG: the unstable-pool sentinel
K_MAX = 8           # most columns routing_topk / routing_attain emit
#: most candidates whose table and columns a routing_guard block stages in
#: shared memory (routing.cu kGuardStageMax); wider sets read device memory
GUARD_STAGE_MAX = 32


def apply_guard(g_home: torch.Tensor, rtt_home: torch.Tensor,
                tau: torch.Tensor, up: torch.Tensor, has_up: torch.Tensor,
                home: torch.Tensor):
    """Algorithm-1 offload guard, the ONE shared surface (the plain
    ``routing_guard_ref`` and ``guarded_alg1``'s vmap branch both call
    it; the CUDA kernel inlines the same three lines).

    ``g_home`` is the home pool's predicted latency with the unstable
    sentinel; the guard compares the *controllable* part (RTT stripped,
    except for the sentinel, which must stay above any tau) against the
    budget and routes at-risk requests one hop up. Returns
    ``(target, offloaded)``.
    """
    g_inst = torch.where(g_home < UNSTABLE_G, g_home - rtt_home, g_home)
    off = (g_inst > tau) & has_up
    target = torch.where(off, up, home)
    return target, off


def routing_guard(lam: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                  n: torch.Tensor, rtt: torch.Tensor, tau: torch.Tensor,
                  home: torch.Tensor, up: torch.Tensor,
                  erlang_c_table: torch.Tensor):
    """Fused Algorithm-1 guarded routing.

    lam: (R,) shared or (R, I) per-candidate rates; six (I,) candidate
    columns; tau: (R,) float32 guard budgets; home/up: (R,) int32 home
    column in [0, I) and its upstream column (-1 at the top tier);
    erlang_c_table: (I, T). Returns (chosen (R,) int32, g at the chosen
    column with the 1e9 unstable sentinel (R,) float32, offloaded (R,)
    bool).
    """
    refuse_grad("routing_guard", lam, alpha, beta, gamma, mu, n, rtt, tau,
                erlang_c_table)
    if lam.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.routing_guard_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                     tau, home, up, erlang_c_table)
    if lam.device.type != "cuda":
        raise ValueError(f"routing_guard: no kernel for {lam.device}")
    from repro_torch.kernels._build import library
    from repro_torch.kernels.routing_score import (check_input, row_strides,
                                                   stream_ptr)
    dev = lam.device
    r = lam.shape[0]
    i, t = erlang_c_table.shape
    check_input("lam", lam, ((r,), (r, i)), dev)
    for name, col in (("alpha", alpha), ("beta", beta), ("gamma", gamma),
                      ("mu", mu), ("n", n), ("rtt", rtt)):
        check_input(name, col, ((i,),), dev)
    check_input("tau", tau, ((r,),), dev)
    check_input("home", home, ((r,),), dev, torch.int32)
    check_input("up", up, ((r,),), dev, torch.int32)
    check_input("erlang_c_table", erlang_c_table, ((i, t),), dev)
    if i < 1 or t < 2:
        raise ValueError(f"routing_guard: table shape {(i, t)}")
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    g = torch.empty(r, dtype=torch.float32, device=dev)
    off = torch.empty(r, dtype=torch.uint8, device=dev)
    lib = library()
    lam_rs, lam_cs = row_strides(lam)
    rc = lib.lib.laimr_routing_guard(
        lam.data_ptr(), lam_rs, lam_cs, alpha.data_ptr(), beta.data_ptr(),
        gamma.data_ptr(), mu.data_ptr(), n.data_ptr(), rtt.data_ptr(),
        tau.data_ptr(), home.data_ptr(), up.data_ptr(),
        erlang_c_table.data_ptr(), r, i, t, idx.data_ptr(), g.data_ptr(),
        off.data_ptr(), stream_ptr(dev))
    lib.check(rc, "routing_guard")
    routing_guard.launches += 1
    return idx, g, off.view(torch.bool)


routing_guard.launches = 0


def _check_k(what: str, k: int) -> None:
    """The kernels emit at most K_MAX columns (one cache pass each); the
    wrapper holds CPU and CUDA callers to the same cap."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"{what}: k={k} outside [1, {K_MAX}]")


def _launch_topk(what: str, fn_name: str, lam, cols, slo, extra, table,
                 k: int, margin: float, plan: tuple = ()):
    """Shared launch of the two (R, k) select kernels: checks every
    input, allocates (idx (R, k) int32, g (R, k) f32, ok (R,)) and
    enqueues on the current stream. ``extra`` holds the kernel's (I,)
    columns after ``slo`` (cost, or sigma and avail); ``plan``, the
    launch plan's arguments, after ``margin``."""
    from repro_torch.kernels._build import library
    from repro_torch.kernels.routing_score import (check_input, row_strides,
                                                   stream_ptr)
    dev = lam.device
    r = lam.shape[0]
    i, t = table.shape
    check_input("lam", lam, ((r,), (r, i)), dev)
    for name, col in cols + extra:
        check_input(name, col, ((i,),), dev)
    check_input("slo", slo, ((i,), (r, i)), dev)
    check_input("erlang_c_table", table, ((i, t),), dev)
    if i < 1 or t < 2:
        raise ValueError(f"{what}: table shape {(i, t)}")
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    g = torch.empty((r, k), dtype=torch.float32, device=dev)
    ok = torch.empty(r, dtype=torch.uint8, device=dev)
    lib = library()
    lam_rs, lam_cs = row_strides(lam)
    rc = getattr(lib.lib, fn_name)(
        lam.data_ptr(), lam_rs, lam_cs, *[c.data_ptr() for _, c in cols],
        slo.data_ptr(), 0 if slo.ndim == 1 else i,
        *[c.data_ptr() for _, c in extra], table.data_ptr(), r, i, t, k,
        float(margin), *plan, idx.data_ptr(), g.data_ptr(), ok.data_ptr(),
        stream_ptr(dev))
    lib.check(rc, what)
    return idx, g, ok.view(torch.bool)


def routing_topk(lam: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 gamma: torch.Tensor, mu: torch.Tensor, n: torch.Tensor,
                 rtt: torch.Tensor, slo: torch.Tensor, cost: torch.Tensor,
                 erlang_c_table: torch.Tensor, k: int = 2,
                 margin: float = 0.0):
    """Fused top-k select: the route_best primary in column 0 plus the
    next ``k - 1`` feasible candidates in ascending g (primary excluded,
    headroom-gated by ``g <= slo - margin``), -1 where fewer exist.

    Inputs as :func:`~repro_torch.kernels.routing_score.routing_score`;
    ``1 <= k <= K_MAX`` (ValueError otherwise, on any device). Returns
    (idx (R, k) int32, g (R, k) float32, ok (R,) bool); on a row with
    nothing feasible idx is -1 throughout and g column 0 is the row
    minimum of the sentinel-masked scores.
    """
    _check_k("routing_topk", k)
    refuse_grad("routing_topk", lam, alpha, beta, gamma, mu, n, rtt, slo,
                cost, erlang_c_table)
    if lam.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.routing_topk_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                    slo, cost, erlang_c_table, k=k,
                                    margin=margin)
    if lam.device.type != "cuda":
        raise ValueError(f"routing_topk: no kernel for {lam.device}")
    from repro_torch.kernels.routing_score import plan_args
    out = _launch_topk(
        "routing_topk", "laimr_routing_topk", lam,
        [("alpha", alpha), ("beta", beta), ("gamma", gamma), ("mu", mu),
         ("n", n), ("rtt", rtt)], slo, [("cost", cost)], erlang_c_table,
        k, margin, plan_args(lam.shape[0], erlang_c_table.shape[0],
                             lam.device, "topk"))
    routing_topk.launches += 1
    return out


routing_topk.launches = 0


def routing_attain(lam: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                   n: torch.Tensor, rtt: torch.Tensor, slo: torch.Tensor,
                   sigma: torch.Tensor, avail: torch.Tensor,
                   erlang_c_table: torch.Tensor, k: int = 2,
                   margin: float = 0.0):
    """Fused attainment-argmax select for the ``reliable`` strategy:
    primary = feasible argmax of ``avail * Phi((ln slo - ln g) / (sigma
    * sqrt2))`` (ties within 1e-6 to lower g, then lower index);
    duplicate columns and outputs as :func:`routing_topk`. sigma, avail:
    (I,) float32 dispersion and delivery probability.
    """
    _check_k("routing_attain", k)
    refuse_grad("routing_attain", lam, alpha, beta, gamma, mu, n, rtt, slo,
                sigma, avail, erlang_c_table)
    if lam.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.routing_attain_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                      slo, sigma, avail, erlang_c_table,
                                      k=k, margin=margin)
    if lam.device.type != "cuda":
        raise ValueError(f"routing_attain: no kernel for {lam.device}")
    from repro_torch.kernels.routing_score import plan_args
    out = _launch_topk(
        "routing_attain", "laimr_routing_attain", lam,
        [("alpha", alpha), ("beta", beta), ("gamma", gamma), ("mu", mu),
         ("n", n), ("rtt", rtt)], slo, [("sigma", sigma), ("avail", avail)],
        erlang_c_table, k, margin,
        plan_args(lam.shape[0], erlang_c_table.shape[0], lam.device,
                  "attain"))
    routing_attain.launches += 1
    return out


routing_attain.launches = 0
