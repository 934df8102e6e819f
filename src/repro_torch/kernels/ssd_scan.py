"""``ssd_scan``: the Mamba-2 SSD over a whole sequence in one launch.

The state-space-dual scan of a Mamba-2 layer's prefill
(arXiv:2405.21060): per head, ``h = exp(dt a) h + (dt x) b^T`` and
``y = h c + d_skip x`` over the sequence, with the (P, N) state carried
from an optional initial state to a final one. On the card this is the
hand-written CUDA kernel ``ssd_scan_kernel`` in ``csrc/ssd.cu``: one
block per head and batch row, walking chunks of 64 steps; bfloat16
inputs take its tensor-core body, float32 its CUDA-core body. It
replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:ssd_scan``.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.ssd_scan_ref``. There is no fallback
from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.flash_attention import DTYPE_CODE
from repro_torch.kernels.routing_score import check_input, stream_ptr

MAX_HEAD_DIM = 64       # P the kernel's tiles hold
MAX_STATE = 128         # N the kernel's tiles hold


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             initial_state: torch.Tensor | None = None,
             return_final_state: bool = False):
    """x: (B, L, H, P) and b, c: (B, L, G, N), float32 or bfloat16 (one
    type); dt: (B, L, H), a, d_skip: (H,) and initial_state: (B, H, P, N)
    or None, float32. Head h reads group h // (H / G). Returns y (B, L,
    H, P) in x's dtype, and with ``return_final_state`` also the final
    state (B, H, P, N) in float32."""
    refuse_grad("ssd_scan", x, dt, a, b, c, d_skip, initial_state)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a, b, c, d_skip,
                                initial_state=initial_state,
                                return_final_state=return_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    if x.ndim != 4 or b.ndim != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}: expected (B, L, H, P) and "
                         f"(B, L, G, N)")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    bsz, length, heads, hp = x.shape
    groups, n = b.shape[2], b.shape[3]
    if length < 1 or groups < 1 or heads % groups:
        raise ValueError(f"ssd_scan: L {length}, H {heads}, G {groups}")
    if not (1 <= hp <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"ssd_scan: P {hp}, N {n}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM} and N <= {MAX_STATE}")
    dev = x.device
    check_input("x", x, ((bsz, length, heads, hp),), dev, x.dtype)
    check_input("dt", dt, ((bsz, length, heads),), dev)
    check_input("a", a, ((heads,),), dev)
    check_input("b", b, ((bsz, length, groups, n),), dev, x.dtype)
    check_input("c", c, ((bsz, length, groups, n),), dev, x.dtype)
    check_input("d_skip", d_skip, ((heads,),), dev)
    if initial_state is not None:
        check_input("initial_state", initial_state,
                    ((bsz, heads, hp, n),), dev)
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, heads, hp, n), dtype=torch.float32,
                          device=dev)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    rc = lib.lib.laimr_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), DTYPE_CODE[x.dtype], bsz, length,
        heads, hp, groups, n, stream_ptr(dev))
    lib.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return (y, h_final) if return_final_state else y


ssd_scan.launches = 0
