"""Plain float32 reference of a ``mamba2`` layer, as Mamba2-370m stacks
them (arXiv:2405.21060): the RMS pre-norm, in_proj, causal depthwise
conv with SiLU, the SSD recurrence in its chunked form, the gated
RMSNorm as the port orders it (rmsnorm(y) * silu(z),
``norm_before_gate``), out_proj; ``model_ref.logits`` runs the stack,
its sequence padded to a multiple of ``CHUNK``. Nothing of the program
is imported.

``dims`` is the configuration under the port's field names
(``replica.dims``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from laimr_bench.reference.model_ref import _f, _rmsnorm

#: the SSD's chunk: the sequence a layer takes is a multiple of it
CHUNK = 64


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x[j+1..i] below the diagonal,
    -inf above it."""
    t = x.shape[-1]
    xe = x[..., None].expand(*x.shape, t)
    low = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    xs = torch.cumsum(xe.masked_fill(~low, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return xs.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk: int = CHUNK):
    """The SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t^T,
    y_t = h_t c_t, from a zero state, in chunks (the Mamba-2 paper's
    minimal form). x (B, L, H, P), dt (B, L, H), a (H,), b and c
    (B, L, H, N), L a multiple of ``chunk``. Returns y (B, L, H, P)."""
    bsz, length, h, p = x.shape
    nc = length // chunk
    xc = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p)
    ac = (dt * a).reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)
    bc = b.reshape(bsz, nc, chunk, h, -1)
    cc = c.reshape(bsz, nc, chunk, h, -1)
    acum = torch.cumsum(ac, dim=-1)                         # (B, H, C, Q)
    lmat = torch.exp(_segsum(ac))                           # (B, H, C, Q, Q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", cc, bc, lmat, xc)
    decay = torch.exp(acum[..., -1:] - acum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bc, decay, xc)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cc, states,
                         torch.exp(acum))
    return (y_diag + y_off).reshape(bsz, length, h, p)


def mixer(m: dict, dims: dict, u: torch.Tensor,
          chunk: int = CHUNK) -> torch.Tensor:
    """The Mamba-2 mixer's output for the normed stream u (B, L, D), L a
    multiple of ``chunk``: in_proj, the causal depthwise conv with SiLU,
    the SSD recurrence with its skip, the gated norm
    (rmsnorm(y) * silu(z), ``norm_before_gate``), out_proj."""
    eps = dims["norm_eps"]
    d_in = dims["ssm_expand"] * dims["d_model"]
    hp, n, g = dims["ssm_head_dim"], dims["ssm_state"], dims["ssm_groups"]
    heads = d_in // hp
    w = dims["conv_width"]
    b_, length = u.shape[:2]
    proj = u @ _f(m["in_proj"])
    z, xs, bb, cc, dt = torch.split(
        proj, [d_in, d_in, g * n, g * n, heads], dim=-1)
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    ext = F.pad(conv_in, (0, 0, w - 1, 0))
    cw = _f(m["conv_w"])
    conv = sum(ext[:, i:i + length] * cw[i] for i in range(w))
    conv = F.silu(conv + _f(m["conv_b"]))
    xs, bb, cc = torch.split(conv, [d_in, g * n, g * n], dim=-1)
    xh = xs.reshape(b_, length, heads, hp)
    rep = heads // g
    bh = bb.reshape(b_, length, g, n).repeat_interleave(rep, dim=2)
    ch = cc.reshape(b_, length, g, n).repeat_interleave(rep, dim=2)
    dtp = F.softplus(dt + _f(m["dt_bias"]))
    a = -torch.exp(_f(m["a_log"]))
    y = ssd(xh, dtp, a, bh, ch, chunk) + xh * _f(m["d_skip"])[:, None]
    y = y.reshape(b_, length, d_in)
    y = _rmsnorm(y, m["norm"]["scale"], eps) * F.silu(z)
    return y @ _f(m["out_proj"])


def layer(p: dict, dims: dict, x: torch.Tensor,
          chunk: int = CHUNK) -> torch.Tensor:
    """One ``mamba2`` layer on the float32 residual stream x (B, L, D),
    L a multiple of ``chunk``: the RMS pre-norm and the mixer."""
    u = _rmsnorm(x, p["norm1"]["scale"], dims["norm_eps"])
    return x + mixer(p["mixer"], dims, u, chunk)


def check(dims: dict) -> None:
    if not dims.get("norm_before_gate", True):
        raise ValueError("the reference gates after the norm only")
