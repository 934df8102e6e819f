"""``ssd_step``: one decode token's Mamba-2 state update in one launch.

Per batch row and head, with the (P, N) state ``h`` in float32 updated in
place: ``h = exp(dt a) h + (dt x) b^T`` and ``y = h c + d_skip x``. On
the card this is the hand-written CUDA kernel ``ssd_step_kernel`` in
``csrc/ssd.cu`` (built into the ``ssd`` library beside ``ssd_scan``): one
block per (row, head) that reads the state once and writes it once. It
replaces no TPU kernel (the reference's decode step is plain jnp); it
replaces the eager passes of ``kernels/ref.py: ssd_step_ref``, which read
the state three times and write it twice a layer. The new state equals
the plain version's bit for bit; y differs by the order of its sum over
N.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.ssd_step_ref``. There is no fallback
from the card to the plain version. It allocates y with ``torch.empty``
and never synchronises, so a CUDA graph may capture it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.routing_score import check_input, stream_ptr

MAX_HEAD_DIM = 64       # P: eight rows a warp at most
MAX_STATE = 128         # N: one float4 a lane at most


def check_inputs(h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 d_skip: torch.Tensor) -> None:
    """Raise on what the kernel does not take: everything on h's device,
    float32; h (B, H, P, N), b and c (B, H, N) contiguous and 16-byte
    aligned (float4 loads); dt (B, H), a and d_skip (H,) contiguous; x
    (B, H, P) at any strides; 1 <= P <= 64, N a multiple of 4 up to 128.
    Device-blind apart from comparing devices, so the CPU tests can hold
    the decode step's own arguments to it."""
    if h.ndim != 4:
        raise ValueError(f"ssd_step: h {tuple(h.shape)}: expected (B, H, "
                         "P, N)")
    bsz, heads, hp, n = h.shape
    if not (1 <= hp <= MAX_HEAD_DIM and 4 <= n <= MAX_STATE and n % 4 == 0):
        raise ValueError(f"ssd_step: P {hp}, N {n}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM} and N a multiple of 4 up to "
                         f"{MAX_STATE}")
    dev = h.device
    check_input("h", h, ((bsz, heads, hp, n),), dev, align=16)
    check_input("dt", dt, ((bsz, heads),), dev)
    check_input("a", a, ((heads,),), dev)
    check_input("b", b, ((bsz, heads, n),), dev, align=16)
    check_input("c", c, ((bsz, heads, n),), dev, align=16)
    check_input("d_skip", d_skip, ((heads,),), dev)
    if x.device != dev:
        raise ValueError(f"x: on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected {torch.float32}")
    if tuple(x.shape) != (bsz, heads, hp):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected "
                         f"{(bsz, heads, hp)}")
    if max(x.stride()) >= 2 ** 31:
        raise ValueError(f"x: strides {x.stride()} past the kernel's int")


def ssd_step(h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             d_skip: torch.Tensor) -> torch.Tensor:
    """h: (B, H, P, N), updated in place; dt: (B, H); a, d_skip: (H,); x:
    (B, H, P) at any strides (the decode step's is a view of its conv
    output, whose layout the einsum that makes it chooses); b, c: (B, H,
    N). All float32, N a multiple of 4 up to 128, P up to 64
    (``check_inputs``). Returns y (B, H, P) float32."""
    refuse_grad("ssd_step", h, dt, a, x, b, c, d_skip)
    if h.device.type == "cpu":
        return ref.ssd_step_ref(h, dt, a, x, b, c, d_skip)
    if h.device.type != "cuda":
        raise ValueError(f"ssd_step: no kernel for {h.device}")
    check_inputs(h, dt, a, x, b, c, d_skip)
    bsz, heads, hp, n = h.shape
    y = torch.empty((bsz, heads, hp), dtype=torch.float32, device=h.device)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    rc = lib.lib.laimr_ssd_step(
        h.data_ptr(), dt.data_ptr(), a.data_ptr(), x.data_ptr(),
        b.data_ptr(), c.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
        *x.stride(), bsz, heads, hp, n, stream_ptr(h.device))
    lib.check(rc, "ssd_step")
    ssd_step.launches += 1
    return y


ssd_step.launches = 0
