"""The ``hybrid_mamba`` layer kind: a Nemotron-H ``M`` layer, a pre-norm
Mamba-2 mixer whose inner width is its heads x head_dim (64 x 64 = 4096
for Nemotron-3-Nano, not expand x d_model) and whose gated norm is the
published one, rmsnorm(y * silu(z)) over ``ssm_groups`` groups. The
leaves are a ``mamba2`` layer's, with the same makers for dt_bias and
A_log (the published Mamba-2 init). Its reference is
``reference/hybrid_mamba.py``."""
from __future__ import annotations

from laimr_bench.families import mamba2, norm

KERNELS = ("ssd_scan",)


def check(cfg) -> None:
    if not cfg.ssm_heads or not cfg.ssm_gate_first:
        raise ValueError("a hybrid_mamba layer gives its heads and gates "
                         "before its grouped norm")


def widths(dims) -> dict:
    """The mixer's derived widths from ``dims`` (or a config's fields)."""
    heads = dims["ssm_heads"]
    d_in = heads * dims["ssm_head_dim"]
    gn = dims["ssm_groups"] * dims["ssm_state"]
    return dict(heads=heads, d_in=d_in, conv=d_in + 2 * gn,
                proj=2 * d_in + 2 * gn + heads)


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``hybrid_mamba`` layer at path ``p``."""
    d = cfg.d_model
    k = widths(vars(cfg))
    rand = {p + ("mixer", "in_proj"): ((d, k["proj"]), d ** -0.5),
            p + ("mixer", "conv_w"): ((cfg.conv_width, k["conv"]), 0.1),
            p + ("mixer", "out_proj"): ((k["d_in"], d), k["d_in"] ** -0.5)}
    fixed = norm(cfg, p + ("norm1",), d)
    fixed += [(p + ("mixer", "conv_b"), ("zeros", (k["conv"],), "model")),
              (p + ("mixer", "dt_bias"), (mamba2.dt_bias, (k["heads"],),
                                          None)),
              (p + ("mixer", "a_log"), (mamba2.a_log, (k["heads"],), None)),
              (p + ("mixer", "d_skip"), ("ones", (k["heads"],), None)),
              (p + ("mixer", "norm", "scale"), ("zeros", (k["d_in"],),
                                                None))]
    return rand, fixed


def _token_flops(dims: dict) -> int:
    """One token: in_proj, the conv's taps, out_proj, and the
    recurrence's update and readout."""
    k = widths(dims)
    return 2 * (dims["d_model"] * k["proj"] + dims["conv_width"] * k["conv"]
                + k["d_in"] * dims["d_model"]) \
        + 5 * k["heads"] * dims["ssm_head_dim"] * dims["ssm_state"]


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    return b * s * _token_flops(dims)


def layer_decode_flops(dims: dict, pos: int) -> int:
    return _token_flops(dims)
