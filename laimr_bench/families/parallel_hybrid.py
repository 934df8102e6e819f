"""The ``parallel_hybrid`` layer kind, and the family of a stack of such
layers alone, such as Falcon-H1-34B-Instruct: one RMS pre-norm, then on
the same normed stream grouped-query attention with rotary over the
whole head and a Mamba-2 mixer whose inner width is its heads x head_dim
(32 x 128 = 4096, not expand x d_model = 10240) with the gate-first
grouped norm, both added into the residual; then a pre-norm SwiGLU MLP.
The attention's width need not tile d_model (20 x 128 = 2560 against
5120). The mixer's leaves and makers are ``hybrid_mamba``'s (the
published Mamba-2 init of dt_bias and A_log). Its reference is
``reference/parallel_hybrid.py``."""
from __future__ import annotations

from laimr_bench.families import hybrid_attn, hybrid_mamba, norm

KERNELS = ("flash_attention", "ssd_scan")


def check(cfg) -> None:
    if not cfg.ssm_heads or not cfg.ssm_gate_first or not cfg.use_rope:
        raise ValueError("a parallel_hybrid layer gives its SSM heads, "
                         "gates before its grouped norm and rotates its "
                         "attention")


def widths(dims) -> dict:
    """The mixer's derived widths from ``dims`` (or a config's fields):
    its heads, inner width, conv channels and in_proj width."""
    return hybrid_mamba.widths(dims)


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``parallel_hybrid`` layer at path ``p``: the
    attention, the mixer and their pre-norm, the MLP and its norm."""
    d, f = cfg.d_model, cfg.d_ff
    rand, fixed = hybrid_attn.layer(cfg, p)
    mixer_rand, mixer_fixed = hybrid_mamba.layer(cfg, p)
    rand.update(mixer_rand)
    fixed += [leaf for leaf in mixer_fixed if leaf[0][-2] != "norm1"]
    rand.update({p + ("mlp", "wi"): ((d, f), d ** -0.5),
                 p + ("mlp", "wg"): ((d, f), d ** -0.5),
                 p + ("mlp", "wo"): ((f, d), f ** -0.5)})
    fixed += norm(cfg, p + ("norm2",), d)
    return rand, fixed


def _mlp_flops(dims: dict) -> int:
    return 2 * 3 * dims["d_model"] * dims["d_ff"]


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    """b prompts of s tokens: the attention's projections and its causal
    pairs, the mixer (its own widths: ``widths``), the MLP."""
    return hybrid_attn.layer_prefill_flops(dims, b, s) \
        + hybrid_mamba.layer_prefill_flops(dims, b, s) \
        + b * s * _mlp_flops(dims)


def layer_decode_flops(dims: dict, pos: int) -> int:
    """One token at position ``pos`` (attending to pos + 1 keys)."""
    return hybrid_attn.layer_decode_flops(dims, pos) \
        + hybrid_mamba.layer_decode_flops(dims, pos) + _mlp_flops(dims)
