"""Plain float32 reference of a decoder of ``attn`` layers, such as
StableLM-3B: a pre-norm block (LayerNorm or RMSNorm, as the
configuration's ``norm`` says), attention with rotary embeddings over
the whole head (NeoX halves, as the port computes them) and grouped
key/value heads, a SwiGLU MLP, and the head (untied, or the embedding's
transpose). Nothing of the program is imported.

``dims`` is the configuration under the port's field names
(``replica.dims``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from laimr_bench.reference.model_ref import _f, _rmsnorm


def _rope(x, theta):
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


def _norm(dims, p, x):
    if dims["norm"] == "rmsnorm":
        return _rmsnorm(x, p["scale"], dims["norm_eps"])
    return F.layer_norm(x, (x.shape[-1],), _f(p["scale"]), _f(p["bias"]),
                        dims["norm_eps"])


def logits(params: dict, dims: dict, tokens: torch.Tensor,
           first: int) -> torch.Tensor:
    """(B, L) tokens -> float32 logits (B, L - first, V) at positions
    first..L-1."""
    if dims.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("the reference rotates the whole head only")
    theta = dims["rope_theta"]
    x = _f(params["embed"][tokens])
    s = x.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for p in params["layers"]:
        h = _norm(dims, p["norm1"], x)
        a = p["attn"]
        q = _rope(torch.einsum("bsd,dhk->bshk", h, _f(a["wq"])), theta)
        k = _rope(torch.einsum("bsd,dhk->bshk", h, _f(a["wk"])), theta)
        v = torch.einsum("bsd,dhk->bshk", h, _f(a["wv"]))
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        att = torch.einsum("bqhk,bshk->bhqs", q, k) * q.shape[-1] ** -0.5
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("bhqs,bshk->bqhk", att, v)
        x = x + torch.einsum("bqhk,hkd->bqd", o, _f(a["wo"]))
        h = _norm(dims, p["norm2"], x)
        m = p["mlp"]
        x = x + (F.silu(h @ _f(m["wg"])) * (h @ _f(m["wi"]))) @ _f(m["wo"])
    x = _norm(dims, params["final_norm"], x[:, first:])
    head = _f(params["embed"]).T if dims["tie_embeddings"] \
        else _f(params["lm_head"])
    return x @ head
