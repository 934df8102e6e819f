"""``ssd_step``: one decode token's Mamba-2 state update in one launch.

Per batch row and head, with the (P, N) state ``h`` in float32 updated in
place: ``h = exp(dt a) h + (dt x) b^T`` and ``y = h c + d_skip x``. On
the card this is the hand-written CUDA kernel ``ssd_step_kernel`` in
``csrc/ssd.cu`` (built into the ``ssd`` library beside ``ssd_scan``): one
block per (row, head) and slice of 64 state rows that reads its state
once and writes it once; N up to 128 a float4 a lane, up to 256 two. It
replaces no TPU kernel (the reference's decode step is plain jnp); it
replaces the eager passes of ``kernels/ref.py: ssd_step_ref``, which read
the state three times and write it twice a layer. The new state equals
the plain version's bit for bit; y differs by the order of its sum over
N.

Beside it, the decode mixer of a Mamba-2 layer in three launches, each
with its plain version in ``kernels/ref.py``:

* ``ssd_conv_step`` (``ssd_conv_step_kernel``): the conv's one-token
  step over the in_proj output's x | B | C, read in place, its buffer
  shifted in place, and dt = softplus(dt_raw + dt_bias);
* ``ssd_state_step``: ``ssd_step_kernel`` with B and C read by group from
  the conv output and a = -exp(a_log) inline;
* ``ssd_gated_norm`` (``ssd_gated_norm_kernel``): the gated RMSNorm in
  either gate order, writing out_proj's input in the model dtype.

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version. There is no fallback from the card to the plain version. They
allocate with ``torch.empty`` and never synchronise, so a CUDA graph may
capture them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.routing_score import check_input, stream_ptr

MAX_HEAD_DIM = 128      # P: two slices of 64 rows, eight a warp
MAX_STATE = 256         # N: two float4s a lane at most
MAX_CONV_WIDTH = 8      # W: the conv step's window in registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the model dtype's code


def check_state(h: torch.Tensor) -> None:
    """Raise unless h is a (B, H, P, N) state the kernel takes: 1 <= P
    <= 128, N a multiple of 4 up to 256."""
    if h.ndim != 4:
        raise ValueError(f"ssd_step: h {tuple(h.shape)}: expected (B, H, "
                         "P, N)")
    _, _, hp, n = h.shape
    if not (1 <= hp <= MAX_HEAD_DIM and 4 <= n <= MAX_STATE and n % 4 == 0):
        raise ValueError(f"ssd_step: P {hp}, N {n}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM} and N a multiple of 4 up to "
                         f"{MAX_STATE}")


def check_view(name: str, x: torch.Tensor, shape: tuple, dev: torch.device,
               dtype=torch.float32, align: int = 0) -> None:
    """Raise unless x is a ``dtype`` tensor of ``shape`` on ``dev`` whose
    rows may lie at any stride but whose other dims are packed (a view of
    a wider row, as the decode step slices its in_proj and conv outputs),
    starting on an ``align``-byte boundary."""
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if shape[0] > 1 and not 0 <= x.stride(0) < 2 ** 31:
        raise ValueError(f"{name}: row stride {x.stride(0)} past the "
                         "kernel's int")
    if not x[:1].is_contiguous():
        raise ValueError(f"{name}: must be contiguous within a row")
    if align and (x.data_ptr() % align
                  or shape[0] > 1 and x.stride(0) * x.element_size() % align):
        raise ValueError(f"{name}: rows must be {align}-byte aligned")


def row_stride(x: torch.Tensor) -> int:
    """The row stride the kernels are given: a lone row's is never
    read."""
    return x.stride(0) if x.shape[0] > 1 else 0


def check_x(x: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    """x (B, H, P) float32 at any strides the kernel's int holds."""
    if x.device != dev:
        raise ValueError(f"x: on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected {torch.float32}")
    if tuple(x.shape) != shape:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected {shape}")
    if max(x.stride()) >= 2 ** 31:
        raise ValueError(f"x: strides {x.stride()} past the kernel's int")


def check_inputs(h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 d_skip: torch.Tensor) -> None:
    """Raise on what the kernel does not take: everything on h's device,
    float32; h (B, H, P, N), b and c (B, H, N) contiguous and 16-byte
    aligned (float4 loads); dt (B, H), a and d_skip (H,) contiguous; x
    (B, H, P) at any strides; 1 <= P <= 128, N a multiple of 4 up to
    256.
    Device-blind apart from comparing devices, so the CPU tests can hold
    the decode step's own arguments to it."""
    check_state(h)
    bsz, heads, hp, n = h.shape
    dev = h.device
    check_input("h", h, ((bsz, heads, hp, n),), dev, align=16)
    check_input("dt", dt, ((bsz, heads),), dev)
    check_input("a", a, ((heads,),), dev)
    check_input("b", b, ((bsz, heads, n),), dev, align=16)
    check_input("c", c, ((bsz, heads, n),), dev, align=16)
    check_input("d_skip", d_skip, ((heads,),), dev)
    check_x(x, (bsz, heads, hp), dev)


def check_state_inputs(h: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d_skip: torch.Tensor) -> None:
    """``check_inputs`` for ``ssd_state_step``: b and c (B, G, N) with G
    dividing H, views of one row layout (the same row stride, packed
    within a row, rows 16-byte aligned); a_log in place of a."""
    check_state(h)
    bsz, heads, hp, n = h.shape
    dev = h.device
    check_input("h", h, ((bsz, heads, hp, n),), dev, align=16)
    check_input("dt", dt, ((bsz, heads),), dev)
    check_input("a_log", a_log, ((heads,),), dev)
    check_input("d_skip", d_skip, ((heads,),), dev)
    groups = b.shape[1] if b.ndim == 3 else 0
    if not groups or heads % groups:
        raise ValueError(f"b: shape {tuple(b.shape)}: expected (B, G, N) "
                         f"with G dividing H {heads}")
    check_view("b", b, (bsz, groups, n), dev, align=16)
    check_view("c", c, (bsz, groups, n), dev, align=16)
    if bsz > 1 and b.stride(0) != c.stride(0):
        raise ValueError(f"b, c: row strides {b.stride(0)} and "
                         f"{c.stride(0)} differ")
    check_x(x, (bsz, heads, hp), dev)


def check_conv_inputs(u: torch.Tensor, dt_raw: torch.Tensor,
                      buf: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      dt_bias: torch.Tensor) -> None:
    """Raise on what ``ssd_conv_step_kernel`` does not take: buf (B, W-1,
    C), w (W, C) and bias (C,) contiguous, u (B, C) and dt_raw (B, H)
    packed within a row, all in one model dtype (float32 or bfloat16) on
    buf's device; dt_bias (H,) float32; 2 <= W <= 8."""
    if buf.ndim != 3 or w.ndim != 2:
        raise ValueError(f"conv: buf {tuple(buf.shape)}, w "
                         f"{tuple(w.shape)}: expected (B, W-1, C), (W, C)")
    bsz, w1, ch = buf.shape
    if not 2 <= w1 + 1 <= MAX_CONV_WIDTH:
        raise ValueError(f"conv: W {w1 + 1}: the kernel takes 2 <= W <= "
                         f"{MAX_CONV_WIDTH}")
    if buf.dtype not in DTYPES:
        raise TypeError(f"buf: dtype {buf.dtype}, expected one of "
                        f"{tuple(DTYPES)}")
    dev, dtype = buf.device, buf.dtype
    heads = dt_bias.shape[0] if dt_bias.ndim == 1 else 0
    check_input("buf", buf, ((bsz, w1, ch),), dev, dtype)
    check_input("w", w, ((w1 + 1, ch),), dev, dtype)
    check_input("bias", bias, ((ch,),), dev, dtype)
    check_input("dt_bias", dt_bias, ((heads,),), dev)
    check_view("u", u, (bsz, ch), dev, dtype)
    check_view("dt_raw", dt_raw, (bsz, heads), dev, dtype)


def check_norm_inputs(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      groups: int) -> None:
    """Raise on what ``ssd_gated_norm_kernel`` does not take: y (B, D)
    float32 and scale (D,) float32 contiguous, z (B, D) in the model
    dtype (float32 or bfloat16) packed within a row, on y's device;
    ``groups`` dividing D."""
    if y.ndim != 2:
        raise ValueError(f"y: shape {tuple(y.shape)}: expected (B, D)")
    bsz, d = y.shape
    if groups < 1 or d % groups:
        raise ValueError(f"gated norm: {groups} groups do not divide D {d}")
    if z.dtype not in DTYPES:
        raise TypeError(f"z: dtype {z.dtype}, expected one of "
                        f"{tuple(DTYPES)}")
    dev = y.device
    check_input("y", y, ((bsz, d),), dev)
    check_input("scale", scale, ((d,),), dev)
    check_view("z", z, (bsz, d), dev, z.dtype)


def _launch_step(h, dt, a, x, b, c, d_skip, bc_sb: int, rep: int,
                 a_log: bool) -> torch.Tensor:
    bsz, heads, hp, n = h.shape
    y = torch.empty((bsz, heads, hp), dtype=torch.float32, device=h.device)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    rc = lib.lib.laimr_ssd_step(
        h.data_ptr(), dt.data_ptr(), a.data_ptr(), x.data_ptr(),
        b.data_ptr(), c.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
        *x.stride(), bc_sb, rep, int(a_log), bsz, heads, hp, n,
        stream_ptr(h.device))
    lib.check(rc, "ssd_step")
    return y


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for CPU tensors (the wrappers run the plain version there);
    raises for a device without the kernels."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def ssd_step(h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             d_skip: torch.Tensor) -> torch.Tensor:
    """h: (B, H, P, N), updated in place; dt: (B, H); a, d_skip: (H,); x:
    (B, H, P) at any strides (the decode step's is a view of its conv
    output, whose layout the einsum that makes it chooses); b, c: (B, H,
    N). All float32, N a multiple of 4 up to 128, P up to 64
    (``check_inputs``). Returns y (B, H, P) float32."""
    refuse_grad("ssd_step", h, dt, a, x, b, c, d_skip)
    if not _on_card("ssd_step", h):
        return ref.ssd_step_ref(h, dt, a, x, b, c, d_skip)
    check_inputs(h, dt, a, x, b, c, d_skip)
    y = _launch_step(h, dt, a, x, b, c, d_skip, h.shape[1] * h.shape[3], 1,
                     False)
    ssd_step.launches += 1
    return y


ssd_step.launches = 0


def ssd_state_step(h: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   d_skip: torch.Tensor) -> torch.Tensor:
    """``ssd_step`` as the decode mixer calls it: a = -exp(a_log) read
    inline, and b, c (B, G, N) views of the conv output (one row stride,
    packed within a row, rows 16-byte aligned), head h reading group h /
    (H / G) (``check_state_inputs``). Returns y (B, H, P) float32; h is
    updated in place."""
    refuse_grad("ssd_state_step", h, dt, a_log, x, b, c, d_skip)
    if not _on_card("ssd_state_step", h):
        return ref.ssd_state_step_ref(h, dt, a_log, x, b, c, d_skip)
    check_state_inputs(h, dt, a_log, x, b, c, d_skip)
    y = _launch_step(h, dt, a_log, x, b, c, d_skip, row_stride(b),
                     h.shape[1] // b.shape[1], True)
    ssd_state_step.launches += 1
    return y


ssd_state_step.launches = 0


def ssd_conv_step(u: torch.Tensor, dt_raw: torch.Tensor, buf: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor,
                  dt_bias: torch.Tensor):
    """One decode token of the depthwise causal conv with SiLU, and dt.
    u: (B, C) the new inputs and dt_raw: (B, H), views of the in_proj
    output (any row stride, packed within a row); buf: (B, W-1, C),
    shifted in place; w: (W, C); bias: (C,); all in the model dtype;
    dt_bias: (H,) float32 (``check_conv_inputs``). Returns (out (B, C),
    dt (B, H)), float32."""
    refuse_grad("ssd_conv_step", u, dt_raw, buf, w, bias, dt_bias)
    if not _on_card("ssd_conv_step", buf):
        return ref.ssd_conv_step_ref(u, dt_raw, buf, w, bias, dt_bias)
    check_conv_inputs(u, dt_raw, buf, w, bias, dt_bias)
    bsz, w1, ch = buf.shape
    heads = dt_bias.shape[0]
    out = torch.empty((bsz, ch), dtype=torch.float32, device=buf.device)
    dt = torch.empty((bsz, heads), dtype=torch.float32, device=buf.device)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    rc = lib.lib.laimr_ssd_conv_step(
        u.data_ptr(), dt_raw.data_ptr(), buf.data_ptr(), w.data_ptr(),
        bias.data_ptr(), dt_bias.data_ptr(), out.data_ptr(), dt.data_ptr(),
        DTYPES[buf.dtype], row_stride(u), row_stride(dt_raw), bsz, ch, heads,
        w1 + 1, stream_ptr(buf.device))
    lib.check(rc, "ssd_conv_step")
    ssd_conv_step.launches += 1
    return out, dt


ssd_conv_step.launches = 0


def ssd_gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   groups: int, gate_first: bool,
                   eps: float) -> torch.Tensor:
    """The gated RMSNorm of one decode token (``ref.ssd_gated_norm_ref``):
    y (B, D) float32; z (B, D) in the model dtype, a view of the in_proj
    output (any row stride, packed within a row); scale (D,) float32;
    ``groups`` normed apart under ``gate_first`` (else 1)
    (``check_norm_inputs``). Returns (B, D) contiguous in z's dtype."""
    refuse_grad("ssd_gated_norm", y, z, scale)
    if not _on_card("ssd_gated_norm", y):
        return ref.ssd_gated_norm_ref(y, z, scale, groups, gate_first, eps)
    check_norm_inputs(y, z, scale, groups)
    bsz, d = y.shape
    out = torch.empty((bsz, d), dtype=z.dtype, device=y.device)
    from repro_torch.kernels._build import library
    lib = library("ssd")
    rc = lib.lib.laimr_ssd_gated_norm(
        y.data_ptr(), z.data_ptr(), scale.data_ptr(), out.data_ptr(),
        DTYPES[z.dtype], row_stride(z), bsz, d, groups, int(gate_first), eps,
        stream_ptr(y.device))
    lib.check(rc, "ssd_gated_norm")
    ssd_gated_norm.launches += 1
    return out


ssd_gated_norm.launches = 0
