"""Unified model API of the port, dispatching decoder-only and
encoder-decoder architectures.

Batch conventions, as in the reference ``repro.models.model``:

* decoder-only, frontend=tokens:     ``{"tokens": (B, S) ints}``
* decoder-only, frontend=embeddings: ``{"embeddings": (B, S, d)}``
* encoder-decoder (whisper):         ``{"frames": (B, S, d),
  "tokens": (B, T) ints}``

Entry points that make tensors run on the card unless the caller passes
``device="cpu"``; those that run the model take ``kernels="cuda"`` (the
hand-written kernels: attention, and the SSD scan of Mamba-2 layers;
default) or ``"ref"`` (their plain versions, on any device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    if cfg.is_encoder_decoder:
        return encdec.init_params(cfg, seed, device)
    return transformer.init_params(cfg, seed, device)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            kernels: str = "cuda"):
    """Training forward -> (float32 logits, aux loss)."""
    if cfg.is_encoder_decoder:
        return encdec.forward(params, cfg, batch["frames"], batch["tokens"],
                              kernels)
    inp = batch.get("tokens", batch.get("embeddings"))
    return transformer.forward(params, cfg, inp, kernels=kernels)


def prefill(params: dict, cfg: ArchConfig, batch: dict,
            kernels: str = "cuda", max_len=None):
    """-> (last-token float32 logits (B, V), cache: attention rings of
    depth ``max_len`` (S when None), or the encoder-decoder's
    ``max_decoder_len`` ring with cross K/V)."""
    if cfg.is_encoder_decoder:
        return encdec.prefill(params, cfg, batch["frames"], batch["tokens"],
                              kernels)
    inp = batch.get("tokens", batch.get("embeddings"))
    return transformer.prefill(params, cfg, inp, max_len=max_len,
                               kernels=kernels)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"
               ) -> dict:
    """The encoder-decoder's cross K/V are ``max_len`` frames deep."""
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, batch, max_len, device)
    return transformer.init_cache(cfg, batch, max_len, device)


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor, kernels: str = "cuda"):
    """-> ((B, V) float32 logits, cache updated in place)."""
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, cfg, tokens, cache, pos, kernels)
    return transformer.decode_step(params, cfg, tokens, cache, pos, kernels)


def _numel(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_numel(t) for t in items)


def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count, from the real init on the meta device (no
    allocation)."""
    return _numel(init_params(cfg, device="meta"))


def active_param_count(cfg: ArchConfig) -> int:
    """Params touched per token: the total less the (n_experts - top_k)
    unused expert slices of every MoE layer (a hybrid stack's expert
    layers)."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    per_expert = cfg.d_model * cfg.d_ff * (3 if gated else 2)
    n_moe = cfg.hybrid_pattern.count("E") if cfg.hybrid_pattern \
        else cfg.n_layers
    return total - n_moe * (cfg.n_experts - cfg.top_k) * per_expert
