"""The ``mamba2`` layer kind, and the family of a stack of such layers
alone, such as Mamba2-370m: a Mamba-2 block (arXiv:2405.21060), a
pre-norm mixer (in_proj, causal depthwise conv, the SSD recurrence, the
gated norm, out_proj) and nothing else. Its reference is
``reference/mamba2.py``."""
from __future__ import annotations

import math

import torch

from laimr_bench.families import norm
from laimr_bench.metrics import counts

KERNELS = ("ssd_scan",)


def dt_bias(gen, shape, device) -> torch.Tensor:
    """The published Mamba-2 init: the inverse softplus of dt drawn
    log-uniform in [1e-3, 1e-1], in float32."""
    u = torch.rand(shape, generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))


def a_log(gen, shape, device) -> torch.Tensor:
    """The published Mamba-2 init: A = -U(1, 16), kept as log(-A)."""
    return torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen,
                                             device=device))


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``mamba2`` layer at path ``p``: the mixer and
    its pre-norm."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    heads = d_in // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_ch = d_in + 2 * gn
    rand = {p + ("mixer", "in_proj"): ((d, 2 * d_in + 2 * gn + heads),
                                       d ** -0.5),
            p + ("mixer", "conv_w"): ((cfg.conv_width, conv_ch), 0.1),
            p + ("mixer", "out_proj"): ((d_in, d), d_in ** -0.5)}
    fixed = norm(cfg, p + ("norm1",), d)
    fixed += [(p + ("mixer", "conv_b"), ("zeros", (conv_ch,), "model")),
              (p + ("mixer", "dt_bias"), (dt_bias, (heads,), None)),
              (p + ("mixer", "a_log"), (a_log, (heads,), None)),
              (p + ("mixer", "d_skip"), ("ones", (heads,), None)),
              (p + ("mixer", "norm", "scale"), ("zeros", (d_in,), None))]
    return rand, fixed


def _token_flops(dims: dict) -> int:
    """One token through one layer: in_proj, the conv's taps, out_proj,
    and the recurrence's update and readout."""
    k = counts.ssm_dims(dims)
    return 2 * (dims["d_model"] * k["proj"] + dims["conv_width"] * k["conv"]
                + k["d_in"] * dims["d_model"]) \
        + 5 * k["heads"] * dims["ssm_head_dim"] * dims["ssm_state"]


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    return b * s * _token_flops(dims)


def layer_decode_flops(dims: dict, pos: int) -> int:
    return _token_flops(dims)
