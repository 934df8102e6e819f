"""Plain float32 reference of a ``hybrid_mamba`` layer, as
NVIDIA-Nemotron-3-Nano stacks them (the published
``modeling_nemotron_h.py``): the RMS pre-norm, in_proj to [z, x, B, C,
dt] with ``ssm_heads`` heads, the causal depthwise conv with its bias
and SiLU, the SSD recurrence (``reference/mamba2.ssd``, chunks of 64
where the published code takes 128: the same sums), the skip, the gated
norm rmsnorm(y * silu(z)) over ``ssm_groups`` groups of the inner
width (``MambaRMSNormGated``), out_proj. Nothing of the program is
imported.

``dims`` is the configuration under the port's field names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from laimr_bench.reference.mamba2 import CHUNK, ssd
from laimr_bench.reference.model_ref import _f, _rmsnorm

__all__ = ["CHUNK", "check", "layer", "mixer"]


def mixer(m: dict, dims: dict, u: torch.Tensor) -> torch.Tensor:
    """The mixer's output for the normed stream u (B, L, D), L a multiple
    of ``CHUNK``."""
    eps = dims["norm_eps"]
    heads, hp = dims["ssm_heads"], dims["ssm_head_dim"]
    n, g, w = dims["ssm_state"], dims["ssm_groups"], dims["conv_width"]
    d_in = heads * hp
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
    y = ssd(xh, dtp, a, bh, ch) + xh * _f(m["d_skip"])[:, None]
    y = (y.reshape(b_, length, d_in) * F.silu(z)) \
        .unflatten(-1, (dims["ssm_groups"], -1))
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
    y = y.flatten(-2) * (1.0 + _f(m["norm"]["scale"]))
    return y @ _f(m["out_proj"])


def layer(p: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on the float32 residual stream x (B, L, D)."""
    u = _rmsnorm(x, p["norm1"]["scale"], dims["norm_eps"])
    return x + mixer(p["mixer"], dims, u)


def check(dims: dict) -> None:
    if not dims.get("ssm_heads") or not dims.get("ssm_gate_first"):
        raise ValueError("the reference takes a head count and the "
                         "gate-first grouped norm")
