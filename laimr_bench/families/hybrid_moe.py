"""The ``hybrid_moe`` layer kind: a Nemotron-H ``E`` layer, a pre-norm
mixture of experts alone. A float32 sigmoid router (d, E) with its
float32 selection bias, each made by a maker of its own (the random
leaves are drawn in the model dtype); E relu² experts ``wi`` (E, d, f),
``wo`` (E, f, d) in the model dtype, Normal(0, 1/fan_in); a shared relu²
expert of width ``shared_d_ff``. Its model FLOPs are the active ones: the
router, ``top_k`` experts and the shared expert a token. The fp8 control
scales a stacked expert weight per expert and output channel. Its
reference is ``reference/hybrid_moe.py``."""
from __future__ import annotations

import torch

from laimr_bench.families import norm

#: the port's grouped expert GEMM, launched twice a layer (up, down)
KERNELS = ("moe_gemm",)
#: the selection bias's spread: small against the scores' (sigmoid of
#: a unit-variance logit), so that it moves some choices, not most
SELECT_BIAS_STD = 0.02


def check(cfg) -> None:
    if cfg.mlp_kind != "relu2":
        raise ValueError("a hybrid_moe layer's experts are relu²")


def router(gen, shape, device) -> torch.Tensor:
    """Normal(0, 1/d) in float32, as the program keeps it."""
    return torch.randn(shape, generator=gen, device=device) \
        .mul_(shape[0] ** -0.5)


def select_bias(gen, shape, device) -> torch.Tensor:
    """Normal(0, ``SELECT_BIAS_STD``^2) in float32."""
    return torch.randn(shape, generator=gen, device=device) \
        .mul_(SELECT_BIAS_STD)


def layer(cfg, p: tuple) -> tuple[dict, list]:
    """The leaves of one ``hybrid_moe`` layer at path ``p``."""
    d, e = cfg.d_model, cfg.n_experts
    f, fs = cfg.d_ff, cfg.shared_d_ff
    m = p + ("moe",)
    rand = {m + ("wi",): ((e, d, f), d ** -0.5),
            m + ("wo",): ((e, f, d), f ** -0.5),
            m + ("shared", "wi"): ((d, fs), d ** -0.5),
            m + ("shared", "wo"): ((fs, d), fs ** -0.5)}
    fixed = norm(cfg, p + ("norm1",), d)
    fixed += [(m + ("router",), (router, (d, e), None)),
              (m + ("select_bias",), (select_bias, (e,), None))]
    return rand, fixed


def fp8_in_dims(path: tuple, leaf):
    """A stacked expert weight (E, in, out): one scale per expert and
    output channel."""
    if path[-1] in ("wi", "wo") and leaf.ndim == 3:
        return (1,)
    return None


def _token_flops(dims: dict) -> int:
    """One token: the router, ``top_k`` experts and the shared expert."""
    d = dims["d_model"]
    f = dims["d_ff"]
    return 2 * d * dims["n_experts"] \
        + dims["top_k"] * 4 * d * f + 4 * d * dims["shared_d_ff"]


def layer_prefill_flops(dims: dict, b: int, s: int) -> int:
    return b * s * _token_flops(dims)


def layer_decode_flops(dims: dict, pos: int) -> int:
    return _token_flops(dims)
