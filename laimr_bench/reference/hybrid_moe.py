"""Plain float32 reference of a ``hybrid_moe`` layer, as
NVIDIA-Nemotron-3-Nano stacks them (the published ``NemotronHMOE``):
the RMS pre-norm; float32 sigmoid scores of the float32 router; each
token's ``top_k`` experts by score + selection bias (the bias chooses,
it never weighs; ties to the lower index); the chosen scores divided by
their sum (+ 1e-20) and multiplied by ``routed_scale``; each expert
down(relu(up(x))²) on the tokens that chose it, weighted; the shared
expert of the same form added unscaled. The reference routes on its own
float32 scores: the program's choice is never given to it. No token is
dropped. One expert's weights are upcast at a time. Nothing of the
program is imported.

``dims`` is the configuration under the port's field names.
"""
from __future__ import annotations

import torch

from laimr_bench.reference.model_ref import _f, _rmsnorm


def relu2(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
          ) -> torch.Tensor:
    return torch.relu(x @ _f(wi)).square() @ _f(wo)


def route(e: dict, dims: dict, x: torch.Tensor):
    """Per token of x (T, D): its experts (T, k) and weights (T, k)."""
    scores = torch.sigmoid(x @ _f(e["router"]))
    idx = torch.sort(scores + _f(e["select_bias"]), dim=-1,
                     descending=True, stable=True).indices[:, :dims["top_k"]]
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * dims["routed_scale"]


def experts(e: dict, dims: dict, u: torch.Tensor) -> torch.Tensor:
    """The sublayer's output for the normed stream u (B, L, D)."""
    x = u.reshape(-1, u.shape[-1])
    idx, w = route(e, dims, x)
    y = torch.zeros_like(x)
    for k in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == k, as_tuple=True)
        y.index_add_(0, tok, w[tok, slot, None]
                     * relu2(x[tok], e["wi"][k], e["wo"][k]))
    y = y + relu2(x, e["shared"]["wi"], e["shared"]["wo"])
    return y.reshape(u.shape)


def layer(p: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on the float32 residual stream x (B, L, D)."""
    u = _rmsnorm(x, p["norm1"]["scale"], dims["norm_eps"])
    return x + experts(p["moe"], dims, u)


def check(dims: dict) -> None:
    if dims.get("mlp_kind") != "relu2":
        raise ValueError("the reference's experts are relu²")
