"""Plain float32 references of the served models, for the check that
decides ``correct``.

Full forward passes in plain PyTorch, with no kernel, cache or batching
of the program and nothing imported from it, one module per layer kind
(``reference/<layer_kind>.py``, named by the configuration file):
``attn`` (StableLM-3B) and ``mamba2`` (Mamba2-370m). Weights are the
benchmark's own tree, the one handed to the program, read leaf by leaf
and upcast to float32 a layer at a time. TF32 is off for the duration
of a call.

``quantize_fp8`` makes the control: the same weights rounded to fp8
e4m3 with a scale per output channel, the nearest precision below the
configuration's bf16.
"""
from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def exact_float32():
    cuda = torch.backends.cuda.matmul
    saved = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    cuda.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + _f(scale))


def logits(conf: dict, params: dict, tokens: torch.Tensor,
           first: int) -> torch.Tensor:
    """(B, L) tokens -> float32 logits (B, L - first, V) at positions
    first..L-1, by ``reference/<layer_kind>.py`` of the configuration
    ``conf``, with TF32 off."""
    from laimr_bench import replica
    family = importlib.import_module(
        f"laimr_bench.reference.{conf['layer_kind']}")
    with exact_float32(), torch.no_grad():
        return family.logits(params, replica.dims(conf), tokens, first)


# ---------------------------------------------------------------- control
#: leaves that stay in their own precision in the control: norms and the
#: SSM's per-head constants
_KEEP = ("scale", "bias", "conv_b", "dt_bias", "a_log", "d_skip")
_FP8_MAX = 448.0


def _fp8(w: torch.Tensor, in_dims: tuple) -> torch.Tensor:
    wf = _f(w)
    amax = wf.abs().amax(dim=in_dims, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    return (wf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def quantize_fp8(params):
    """The weight tree with every matrix rounded to fp8 e4m3, a scale
    per output channel (the input dimensions reduced: the first one of
    a projection, the (H, hd) pair of an attention output, the width of
    an embedding row), returned in float32."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if key in _KEEP or tree.ndim < 2:
            return tree
        if key == "embed":
            return _fp8(tree, (1,))
        if key == "wo" and tree.ndim == 3:
            return _fp8(tree, (0, 1))
        return _fp8(tree, (0,))
    return walk(params)
