"""``routing_guard``: a window of Algorithm-1 guarded decisions in one
launch, and :func:`apply_guard`, the guard arithmetic every path shares.

``routing_guard`` is the hand-written CUDA kernel in ``csrc/routing.cu``
(``routing_guard_kernel``); it replaces the TPU kernel
``src/repro/kernels/routing_decide.py:routing_guard``. Each row scores
its home column, applies the paper's guard ``(g_home - rtt_home) > tau
-> upstream``, and scores the upstream column only when the guard
fires. CUDA tensors go to the kernel (or the wrapper raises); CPU
tensors go to the plain version ``ref.routing_guard_ref``.

The other three TPU decision kernels of the reference module
(``routing_topk``, ``routing_attain``) are not ported yet.
"""
from __future__ import annotations

import torch

UNSTABLE_G = 1e9    # router.BIG: the unstable-pool sentinel


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
        erlang_c_table.data_ptr(), r, t, idx.data_ptr(), g.data_ptr(),
        off.data_ptr(), stream_ptr(dev))
    lib.check(rc, "routing_guard")
    routing_guard.launches += 1
    return idx, g, off.view(torch.bool)


routing_guard.launches = 0
