"""Unified model API of the port (decoder-only architectures).

Batch conventions, as in the reference ``repro.models.model``:
``{"tokens": (B, S) ints}`` or ``{"embeddings": (B, S, d)}``. The
encoder-decoder (whisper) is not ported yet and raises.

Entry points that make tensors run on the card unless the caller passes
``device="cpu"``; those that run the model take ``kernels="cuda"`` (the
hand-written kernels: attention, and the SSD scan of Mamba-2 layers;
default) or ``"ref"`` (their plain versions, on any device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet: "
            "ROADMAP.md queue 1 item d")


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    _decoder_only(cfg)
    return transformer.init_params(cfg, seed, device)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            kernels: str = "cuda"):
    """Training forward -> (float32 logits, aux loss)."""
    _decoder_only(cfg)
    inp = batch.get("tokens", batch.get("embeddings"))
    return transformer.forward(params, cfg, inp, kernels=kernels)


def prefill(params: dict, cfg: ArchConfig, batch: dict,
            kernels: str = "cuda"):
    """-> (last-token float32 logits (B, V), cache of depth S)."""
    _decoder_only(cfg)
    inp = batch.get("tokens", batch.get("embeddings"))
    return transformer.prefill(params, cfg, inp, kernels=kernels)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"
               ) -> dict:
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, device)


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor, kernels: str = "cuda"):
    """-> ((B, V) float32 logits, cache updated in place)."""
    _decoder_only(cfg)
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
