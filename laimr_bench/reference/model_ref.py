"""Plain float32 references of the served models, for the check that
decides ``correct``.

Full forward passes in plain PyTorch, with no kernel, cache or batching
of the program and nothing imported from it: the embedding, each layer
by the reference of its kind (``reference/<kind>.py``'s ``layer``, the
kinds in the order that ``families.kinds`` gives for the configuration's
``layer_kind``), the final norm and the head. The norms and the head are
here. Weights are the benchmark's own tree, the one handed to the
program, read leaf by leaf and upcast to float32 a layer at a time. TF32
is off for the duration of a call.

The control (``logits(..., control=True)``) is the same pass over the
same weights rounded to fp8 e4m3 with a scale per output channel
(``quantize_fp8``), the nearest precision below the configuration's
bf16, rounded a layer at a time as the pass reads it.
"""
from __future__ import annotations

import contextlib
import importlib
import math

import torch
import torch.nn.functional as F


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


def norm(dims: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The configuration's ``norm`` (LayerNorm or RMSNorm) of x with the
    leaves ``p``."""
    if dims["norm"] == "rmsnorm":
        return _rmsnorm(x, p["scale"], dims["norm_eps"])
    return F.layer_norm(x, (x.shape[-1],), _f(p["scale"]), _f(p["bias"]),
                        dims["norm_eps"])


def head(params: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head (untied, or the embedding's
    transpose) over the float32 stream x: the logits."""
    x = norm(dims, params["final_norm"], x)
    w = _f(params["embed"]).T if dims["tie_embeddings"] \
        else _f(params["lm_head"])
    return x @ w


def logits(conf: dict, params: dict, tokens: torch.Tensor, first: int,
           control: bool = False) -> torch.Tensor:
    """(B, L) tokens -> float32 logits (B, L - first, V) at positions
    first..L-1 of the configuration ``conf``, with TF32 off; with
    ``control``, of its weights rounded to fp8 (``quantize_fp8``), each
    layer as it is read, so that no more than one layer is held in
    float32. The sequence is padded at its end to a multiple of every
    kind's ``CHUNK`` (the SSD's chunks); nothing after a position reaches
    it."""
    from laimr_bench import families, replica
    dims = replica.dims(conf)
    family = conf["layer_kind"]
    kinds = families.kinds(family, dims)
    refs = {k: importlib.import_module(f"laimr_bench.reference.{k}")
            for k in dict.fromkeys(kinds)}
    for ref in refs.values():
        getattr(ref, "check", lambda dims: None)(dims)
    chunk = math.lcm(*(getattr(ref, "CHUNK", 1) for ref in refs.values()))

    def rounded(tree, kind):
        if not control:
            return tree
        return quantize_fp8(tree, getattr(families.get(kind), "fp8_in_dims",
                                          None))
    s = tokens.shape[1]
    with exact_float32(), torch.no_grad():
        top = rounded({k: v for k, v in params.items() if k != "layers"},
                      family)
        x = _f(top["embed"][F.pad(tokens, (0, (-s) % chunk))])
        for kind, p in zip(kinds, params["layers"], strict=True):
            x = refs[kind].layer(rounded(p, kind), dims, x)
        return head(top, dims, x[:, first:s])


# ---------------------------------------------------------------- control
#: leaves that stay in their own precision in the control: norms and the
#: SSM's per-head constants
_KEEP = ("scale", "bias", "conv_b", "dt_bias", "a_log", "d_skip")
_FP8_MAX = 448.0


def _fp8(w: torch.Tensor, in_dims: tuple) -> torch.Tensor:
    wf = w.to(torch.float32, copy=True)
    amax = wf.abs().amax(dim=in_dims, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    q = wf.div_(scale).to(torch.float8_e4m3fn)
    del wf
    return q.to(torch.float32).mul_(scale)


def quantize_fp8(tree, rule=None):
    """The weight tree (the whole model's, or one layer's) with every
    matrix rounded to fp8 e4m3, a scale per output channel, in float32.
    The dimensions each scale reduces are those that ``rule(path, leaf)``
    names, where it is given and names some (a stacked expert weight:
    per expert and output channel); else the input dimensions: the first
    one of a projection, the (H, hd) pair of an attention output, the
    width of an embedding row."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        key = path[-1]
        if key in _KEEP or tree.ndim < 2:
            return tree
        dims = rule(path, tree) if rule is not None else None
        if dims is not None:
            return _fp8(tree, tuple(dims))
        if key == "embed":
            return _fp8(tree, (1,))
        if key == "wo" and tree.ndim == 3:
            return _fp8(tree, (0, 1))
        return _fp8(tree, (0,))
    return walk(tree)
