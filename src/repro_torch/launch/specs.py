"""Meta-tensor stand-ins for every (arch x shape) input of the dry run.

The twin of the reference's ``repro.launch.specs``: where it builds
``ShapeDtypeStruct`` s, this builds tensors on the ``meta`` device (shape
and dtype, no storage) with the same shapes and dtypes: int32 tokens,
labels and positions, the config's dtype for frames and embeddings, and
the port's own param, optimizer-state and cache trees (its layers
unrolled, one dict per layer). ``step_fn_for`` returns the function the
dry run runs and its argument tuple.

The dry run runs the plain kernel versions (``kernels="ref"``), as the
reference lowers its ``ops`` default ``"ref"``; ``"fused"`` is the
``--opt fused_attn`` path. The hand-written kernels take neither meta
tensors nor DTensors and are never reached here.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model
from repro_torch.training import optimizer as opt
from repro_torch.training.train import make_functional_step

PyTree = Any
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape``; ``dtype`` a torch dtype or its name."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        t = cfg.max_decoder_len
        return {"frames": sds((b, s, cfg.d_model), cfg.dtype),
                "tokens": sds((b, t), torch.int32),
                "labels": sds((b, t), torch.int32)}
    if cfg.frontend == "embeddings":
        return {"embeddings": sds((b, s, cfg.d_model), cfg.dtype),
                "labels": sds((b, s), torch.int32)}
    return {"tokens": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32)}


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"frames": sds((b, s, cfg.d_model), cfg.dtype),
                "tokens": sds((b, cfg.max_decoder_len), torch.int32)}
    if cfg.frontend == "embeddings":
        return {"embeddings": sds((b, s, cfg.d_model), cfg.dtype)}
    return {"tokens": sds((b, s), torch.int32)}


def params_specs(cfg: ArchConfig) -> PyTree:
    return model.init_params(cfg, device=META)


def opt_cfg(cfg: ArchConfig) -> opt.AdamWConfig:
    return opt.AdamWConfig(state_dtype=cfg.opt_state_dtype)


def opt_state_specs(cfg: ArchConfig) -> PyTree:
    return opt.init_opt_state(params_specs(cfg), opt_cfg(cfg))


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> PyTree:
    return model.init_cache(cfg, batch, max_len, device=META)


def decode_token_specs(cfg: ArchConfig, shape: InputShape):
    b = shape.global_batch
    return sds((b,), torch.int32), sds((b,), torch.int32)


def step_fn_for(cfg: ArchConfig, shape: InputShape, kernels: str = "ref"):
    """The function the dry run runs, plus its argument tuple.

    Returns (fn, args) with ``fn(*args)`` one step: the train step
    (``make_functional_step``) over (params, opt_state, batch), the
    prefill over (params, batch), or one decode token against a
    ``seq_len``-deep cache over (params, tokens, cache, pos)."""
    if shape.kind == "train":
        fn = make_functional_step(cfg, opt_cfg(cfg), kernels)
        args = (params_specs(cfg), opt_state_specs(cfg),
                train_batch_specs(cfg, shape))
        return fn, args
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, cfg, batch, kernels=kernels)
        return prefill, (params_specs(cfg), prefill_batch_specs(cfg, shape))

    def decode(params, tokens, cache, pos):
        return model.decode_step(params, cfg, tokens, cache, pos,
                                 kernels=kernels)
    tokens, pos = decode_token_specs(cfg, shape)
    cache = cache_specs(cfg, shape.global_batch, shape.seq_len)
    return decode, (params_specs(cfg), tokens, cache, pos)
