"""Plain float32 reference of a ``parallel_hybrid`` layer, as
Falcon-H1-34B-Instruct stacks them (the published
``modeling_falcon_h1.py``'s ``FalconH1DecoderLayer``): one RMS pre-norm,
then on the same normed stream causal GQA attention with rotary over
the whole head (``reference/attn.attention``: NeoX halves, the
published ``rotate_half``) and a Mamba-2 mixer of ``ssm_heads`` heads
with the gate-first grouped norm (``reference/hybrid_mamba.mixer``; the
SSD in chunks of 64 where the published code takes 128: the same sums),
both added into the residual; then a second RMS pre-norm and the SwiGLU
MLP (``reference/attn.mlp``). Nothing of the program is imported.

The weights are the tree handed to the program, in which the published
muP multipliers are already folded (``repro_torch.convert.
falcon_h1_params`` does so for a published checkpoint): each scales a
linear map, or a product that a SiLU or the rotary embedding reads
linearly, so the folded layer computes the published one. ``dims`` is
the configuration under the port's field names.
"""
from __future__ import annotations

import torch

from laimr_bench.reference import attn, hybrid_mamba
from laimr_bench.reference.mamba2 import CHUNK
from laimr_bench.reference.model_ref import norm

__all__ = ["CHUNK", "check", "layer"]


def layer(p: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on the float32 residual stream x (B, L, D), L a multiple
    of ``CHUNK``."""
    u = norm(dims, p["norm1"], x)
    x = x + (attn.attention(p["attn"], dims, u)
             + hybrid_mamba.mixer(p["mixer"], dims, u))
    return x + attn.mlp(p["mlp"], norm(dims, p["norm2"], x))


def check(dims: dict) -> None:
    attn.check(dims)
    hybrid_mamba.check(dims)
