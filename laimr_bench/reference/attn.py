"""Plain float32 reference of an ``attn`` layer, as StableLM-3B stacks
them: a pre-norm block (LayerNorm or RMSNorm, as the configuration's
``norm`` says), attention with rotary embeddings over the whole head
(NeoX halves, as the port computes them) and grouped key/value heads,
and a pre-norm SwiGLU MLP; ``model_ref.logits`` runs the stack. Nothing
of the program is imported.

``dims`` is the configuration under the port's field names
(``replica.dims``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from laimr_bench.reference.model_ref import _f, norm


def rope(x, theta):
    """NeoX-style rotary embedding over the whole head; x (B, S, H, D)
    at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a: dict, dims: dict, h: torch.Tensor) -> torch.Tensor:
    """The attention sublayer's output for the normed stream h (B, S,
    D), causal over S, rotary over the whole head, key/value heads
    repeated to the query heads."""
    theta = dims["rope_theta"]
    s = h.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    q = rope(torch.einsum("bsd,dhk->bshk", h, _f(a["wq"])), theta)
    k = rope(torch.einsum("bsd,dhk->bshk", h, _f(a["wk"])), theta)
    v = torch.einsum("bsd,dhk->bshk", h, _f(a["wv"]))
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    att = torch.einsum("bqhk,bshk->bhqs", q, k) * q.shape[-1] ** -0.5
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqs,bshk->bqhk", att, v)
    return torch.einsum("bqhk,hkd->bqd", o, _f(a["wo"]))


def mlp(m: dict, h: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP's output for the normed stream h."""
    return (F.silu(h @ _f(m["wg"])) * (h @ _f(m["wi"]))) @ _f(m["wo"])


def layer(p: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """One ``attn`` layer on the float32 residual stream x (B, S, D):
    the pre-norm attention block, then the pre-norm MLP."""
    x = x + attention(p["attn"], dims, norm(dims, p["norm1"], x))
    return x + mlp(p["mlp"], norm(dims, p["norm2"], x))


def check(dims: dict) -> None:
    if dims.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("the reference rotates the whole head only")
