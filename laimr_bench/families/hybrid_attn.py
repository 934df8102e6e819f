"""The ``hybrid_attn`` layer kind: a Nemotron-H ``*`` layer, pre-norm
attention alone (no MLP after it), grouped key / value heads whose width
need not tile d_model (32 x 128 = 4096 against 2688), no bias and no
rotary embedding. Its reference is ``reference/hybrid_attn.py``."""
from __future__ import annotations

from laimr_bench.families import norm
from laimr_bench.metrics import counts

KERNELS = ("flash_attention",)


def check(cfg) -> None:
    if cfg.use_rope:
        raise ValueError("a hybrid_attn layer has no rotary embedding")


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``hybrid_attn`` layer at path ``p``."""
    d = cfg.d_model
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rand = {p + ("attn", "wq"): ((d, h, hd), d ** -0.5),
            p + ("attn", "wk"): ((d, hkv, hd), d ** -0.5),
            p + ("attn", "wv"): ((d, hkv, hd), d ** -0.5),
            p + ("attn", "wo"): ((h, hd, d), (h * hd) ** -0.5)}
    return rand, norm(cfg, p + ("norm1",), d)


def _token_flops(dims: dict) -> int:
    """One token through the projections."""
    d, h, hkv, hd = (dims[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "head_dim"))
    return 2 * (d * h * hd + 2 * d * hkv * hd + h * hd * d)


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    """b prompts of s tokens: the projections and attention over the
    causal pairs."""
    return b * s * _token_flops(dims) \
        + 4 * b * dims["n_heads"] * dims["head_dim"] * counts.causal_pairs(s)


def layer_decode_flops(dims: dict, pos: int) -> int:
    """One token at position ``pos`` (attending to pos + 1 keys)."""
    return _token_flops(dims) \
        + 4 * dims["n_heads"] * dims["head_dim"] * (pos + 1)
