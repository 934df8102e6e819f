"""Plain float32 reference of a ``hybrid_attn`` layer, as
NVIDIA-Nemotron-3-Nano stacks them: the RMS pre-norm and causal
attention alone, grouped key / value heads repeated to the query heads,
no bias, no MLP, and no rotary embedding (the published
``modeling_nemotron_h.py`` applies none; ``reference/attn.attention``
rotates, so it is not reused). Nothing of the program is imported.

``dims`` is the configuration under the port's field names.
"""
from __future__ import annotations

import torch

from laimr_bench.reference.model_ref import _f, norm


def attention(a: dict, h: torch.Tensor) -> torch.Tensor:
    """Causal attention over the normed stream h (B, S, D)."""
    s = h.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    q = torch.einsum("bsd,dhk->bshk", h, _f(a["wq"]))
    k = torch.einsum("bsd,dhk->bshk", h, _f(a["wk"]))
    v = torch.einsum("bsd,dhk->bshk", h, _f(a["wv"]))
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    att = torch.einsum("bqhk,bshk->bhqs", q, k) * q.shape[-1] ** -0.5
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqs,bshk->bqhk", att, v)
    return torch.einsum("bqhk,hkd->bqd", o, _f(a["wo"]))


def layer(p: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on the float32 residual stream x (B, S, D)."""
    return x + attention(p["attn"], norm(dims, p["norm1"], x))


def check(dims: dict) -> None:
    if dims.get("use_rope", True):
        raise ValueError("the reference applies no rotary embedding")
