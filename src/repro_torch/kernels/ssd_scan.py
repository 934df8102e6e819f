"""``ssd_scan``: the Mamba-2 SSD over a whole sequence in one launch.

The state-space-dual scan of a Mamba-2 layer's prefill
(arXiv:2405.21060): per head, ``h = exp(dt a) h + (dt x) b^T`` and
``y = h c + d_skip x`` over the sequence, with the (P, N) state carried
from an optional initial state to a final one. On the card this is the
hand-written CUDA kernel ``ssd_scan_kernel`` in ``csrc/ssd.cu``: one
block per head and batch row, walking chunks of 64 steps; bfloat16
inputs take its tensor-core body, float32 its CUDA-core body. It
replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:ssd_scan``.

The wrapper launches the kernel for CUDA tensors (a head wider than the
kernel's tiles in whole tiles, one launch a slice of N) and raises on
anything the kernel does not take; for tensors on the CPU it runs the plain
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
#: the widest P and N the wrapper takes, in whole slices of the tiles'
WIDE_HEAD_DIM = 2 * MAX_HEAD_DIM
WIDE_STATE = 2 * MAX_STATE


def _fits(size: int, tile: int, wide: int) -> bool:
    """Whether a P or N of ``size`` is one tile's, or whole tiles up to
    ``wide``."""
    return 1 <= size <= tile or (size <= wide and size % tile == 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             initial_state: torch.Tensor | None = None,
             return_final_state: bool = False):
    """x: (B, L, H, P) and b, c: (B, L, G, N), float32 or bfloat16 (one
    type); dt: (B, L, H), a, d_skip: (H,) and initial_state: (B, H, P, N)
    or None, float32. Head h reads group h // (H / G). Returns y (B, L,
    H, P) in x's dtype, and with ``return_final_state`` also the final
    state (B, H, P, N) in float32.

    The kernel's tiles hold P <= 64 and N <= 128, one launch. A wider
    head (P 128, N 256: Falcon-H1's) is cut into whole tiles, both
    exactly: state rows are independent in p, so P's slices run as heads
    of 64 (x viewed so, dt, a and d_skip repeated); y sums its terms over
    N, so each half of N is one launch (the skip added by the first), and
    y their float32 sum cast once: in bf16 the first launch leaves its
    unrounded y in a float32 buffer that the second adds before its
    rounding. ``launches`` counts the kernel's launches."""
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
    if not (_fits(hp, MAX_HEAD_DIM, WIDE_HEAD_DIM)
            and _fits(n, MAX_STATE, WIDE_STATE)):
        raise ValueError(f"ssd_scan: P {hp}, N {n}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM} and N <= {MAX_STATE}, or whole "
                         f"tiles of them up to P {WIDE_HEAD_DIM} and N "
                         f"{WIDE_STATE}")
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
    if hp <= MAX_HEAD_DIM and n <= MAX_STATE:
        y, h_final = _launch(x, dt, a, b, c, d_skip, initial_state)
    else:
        y, h_final = _sliced(x, dt, a, b, c, d_skip, initial_state)
    return (y, h_final) if return_final_state else y


def _sliced(x, dt, a, b, c, d_skip, h0):
    """The scan of a head wider than one tile, in whole tiles (see
    ``ssd_scan``)."""
    bsz, length, heads, hp = x.shape
    n = b.shape[3]
    ps = max(1, hp // MAX_HEAD_DIM)
    p = hp // ps
    if ps > 1:
        x = x.view(bsz, length, heads * ps, p)
        dt = dt.repeat_interleave(ps, dim=2)
        a = a.repeat_interleave(ps)
        d_skip = d_skip.repeat_interleave(ps)
        if h0 is not None:
            h0 = h0.view(bsz, heads * ps, p, n)
    ns = max(1, n // MAX_STATE)
    m = n // ns
    y_part = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if ns > 1 and x.dtype == torch.bfloat16 else None
    ys, finals = [], []
    for k in range(ns):
        cols = slice(k * m, (k + 1) * m)
        y, h_final = _launch(
            x, dt, a, b[..., cols].contiguous(), c[..., cols].contiguous(),
            d_skip if k == 0 else torch.zeros_like(d_skip),
            None if h0 is None else h0[..., cols].contiguous(),
            y_part, 0 if y_part is None else 1 + (k == ns - 1))
        ys.append(y)
        finals.append(h_final)
    if ns > 1:
        if y_part is None:       # float32: the slices' y summed as is
            y = torch.stack(ys).sum(0)
        h_final = torch.cat(finals, dim=-1)
    return (y.view(bsz, length, heads, hp),
            h_final.view(bsz, heads, hp, n))


def _launch(x, dt, a, b, c, d_skip, h0, y_part=None, part: int = 0):
    """One launch of the kernel over a head that fits its tiles: (y,
    the final state). ``part`` 1 also leaves y unrounded in ``y_part``
    (float32, x's shape), 2 adds ``y_part`` to y before its rounding
    (bf16 only: ``laimr_ssd_scan_part``)."""
    bsz, length, heads, hp = x.shape
    groups, n = b.shape[2], b.shape[3]
    dev = x.device
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, heads, hp, n), dtype=torch.float32,
                          device=dev)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    head = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr())
    shape = (bsz, length, heads, hp, groups, n, stream_ptr(dev))
    if part:
        rc = lib.lib.laimr_ssd_scan_part(*head, y_part.data_ptr(), part,
                                         *shape)
    else:
        rc = lib.lib.laimr_ssd_scan(*head, DTYPE_CODE[x.dtype], *shape)
    lib.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
