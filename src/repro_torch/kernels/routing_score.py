"""``routing_score``: a window of route_best decisions in one launch.

The paper's §IV-B hot path: for each request, evaluate the closed-form
latency law g_mi(lambda) over every candidate deployment, filter by SLO
and stability, and take the latency argmin with a cost tie-break. On the
card this is the hand-written CUDA kernel in ``csrc/routing.cu``
(``routing_score_kernel``, one warp per request row); it replaces the
TPU kernel ``src/repro/kernels/routing_score.py:routing_score``.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.routing_score_ref``. There is no
fallback from the card to the plain version.

``build_erlang_table`` is the host-side table builder both paths
consume: numpy over ``queueing.mmc_wait_np``, bit-identical to the
reference package's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.kernels import ref


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_input(name: str, x: torch.Tensor, shapes: tuple,
                   device: torch.device, dtype=torch.float32,
                   align: int = 0) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on ``device``
    whose shape is one of ``shapes`` (and, given ``align``, whose data
    starts on an ``align``-byte boundary)."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) not in shapes:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected one "
                         f"of {shapes}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align and x.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def row_strides(x: torch.Tensor) -> tuple[int, int]:
    """(row stride, column stride) of an (R,) shared or (R, I) row input."""
    return (1, 0) if x.ndim == 1 else (x.shape[1], 1)


def routing_score(lam: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                  n: torch.Tensor, rtt: torch.Tensor, slo: torch.Tensor,
                  cost: torch.Tensor, erlang_c_table: torch.Tensor):
    """Fused score + select for R requests over I candidates.

    lam: (R,) shared rates or (R, I) per-candidate rates; alpha, beta,
    gamma, mu, n, rtt, cost: (I,); slo: (I,) shared budgets or (R, I)
    rows with -1 as a lane exclusion; erlang_c_table: (I, T). All
    float32. Returns (idx (R,) int32, g at idx (R,) float32, feasible
    (R,) bool); a row with nothing feasible reports idx 0.
    """
    if lam.device.type == "cpu":
        return ref.routing_score_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                     slo, cost, erlang_c_table)
    if lam.device.type != "cuda":
        raise ValueError(f"routing_score: no kernel for {lam.device}")
    dev = lam.device
    r = lam.shape[0]
    i, t = erlang_c_table.shape
    check_input("lam", lam, ((r,), (r, i)), dev)
    for name, col in (("alpha", alpha), ("beta", beta), ("gamma", gamma),
                      ("mu", mu), ("n", n), ("rtt", rtt), ("cost", cost)):
        check_input(name, col, ((i,),), dev)
    check_input("slo", slo, ((i,), (r, i)), dev)
    check_input("erlang_c_table", erlang_c_table, ((i, t),), dev)
    if i < 1 or t < 2:
        raise ValueError(f"routing_score: table shape {(i, t)}")
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    g = torch.empty(r, dtype=torch.float32, device=dev)
    ok = torch.empty(r, dtype=torch.uint8, device=dev)
    from repro_torch.kernels._build import library
    lib = library()
    lam_rs, lam_cs = row_strides(lam)
    rc = lib.lib.laimr_routing_score(
        lam.data_ptr(), lam_rs, lam_cs, alpha.data_ptr(), beta.data_ptr(),
        gamma.data_ptr(), mu.data_ptr(), n.data_ptr(), rtt.data_ptr(),
        slo.data_ptr(), 0 if slo.ndim == 1 else i, cost.data_ptr(),
        erlang_c_table.data_ptr(), r, i, t, idx.data_ptr(), g.data_ptr(),
        ok.data_ptr(), stream_ptr(dev))
    lib.check(rc, "routing_score")
    routing_score.launches += 1
    return idx, g, ok.view(torch.bool)


routing_score.launches = 0


def build_erlang_table(mu, n, t: int = 65) -> np.ndarray:
    """Per-deployment M/M/c wait over rho = linspace(0, 1, t) — the
    'in-memory table pre-computed by the analytic model' (§IV-B).
    Returns an (I, t) float32 numpy array (waits capped at 1e6)."""
    mu = np.asarray(mu, np.float64)
    n = np.asarray(n, np.int64)
    rho = np.linspace(0.0, 1.0, t)
    out = np.zeros((len(mu), t), np.float32)
    for ii in range(len(mu)):
        lam = rho * n[ii] * mu[ii]
        for jj in range(t):
            w = queueing.mmc_wait_np(float(lam[jj]), np.array([n[ii]]),
                                     float(mu[ii]))[0]
            out[ii, jj] = min(float(w), 1e6) if np.isfinite(w) else 1e6
    return out
