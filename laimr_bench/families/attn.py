"""The ``attn`` layer kind, and the family of a decoder of such layers
alone, such as StableLM-3B: a pre-norm attention block with rotary
embeddings and grouped key/value heads, and a pre-norm SwiGLU MLP. Its
reference is ``reference/attn.py``."""
from __future__ import annotations

from laimr_bench.families import norm
from laimr_bench.metrics import counts

KERNELS = ("flash_attention",)


def check(cfg) -> None:
    if cfg.head_dim * cfg.n_heads != cfg.d_model:
        raise ValueError("heads do not tile d_model")


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``attn`` layer at path ``p``: attention, the
    MLP, and their two norms."""
    d = cfg.d_model
    h, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    rand = {p + ("attn", "wq"): ((d, h, hd), d ** -0.5),
            p + ("attn", "wk"): ((d, hkv, hd), d ** -0.5),
            p + ("attn", "wv"): ((d, hkv, hd), d ** -0.5),
            p + ("attn", "wo"): ((h, hd, d), (h * hd) ** -0.5),
            p + ("mlp", "wi"): ((d, f), d ** -0.5),
            p + ("mlp", "wg"): ((d, f), d ** -0.5),
            p + ("mlp", "wo"): ((f, d), f ** -0.5)}
    fixed = []
    for name in ("norm1", "norm2"):
        fixed += norm(cfg, p + (name,), d)
    return rand, fixed


def _token_flops(dims: dict) -> int:
    """One token through one layer's projections and MLP."""
    d, h, hkv, hd, f = (dims[k] for k in ("d_model", "n_heads",
                                          "n_kv_heads", "head_dim", "d_ff"))
    return 2 * (d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f)


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    """b prompts of s tokens through one layer: the projections, the
    MLP, and attention over the causal pairs."""
    attn = 4 * b * dims["n_heads"] * dims["head_dim"] * counts.causal_pairs(s)
    return b * s * _token_flops(dims) + attn


def layer_decode_flops(dims: dict, pos: int) -> int:
    """One token at position ``pos`` (attending to pos + 1 keys) through
    one layer."""
    return _token_flops(dims) \
        + 4 * dims["n_heads"] * dims["head_dim"] * (pos + 1)
