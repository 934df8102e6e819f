"""Shared transformer layer primitives of the port.

Plain functions on tensors, params as nested dicts of tensors, as in the
reference ``repro.models.layers``: init functions draw a dict, apply
functions take one. Weights keep the reference's layouts (``wq`` (d, H,
hd), ``wo`` (H, hd, d), MLP ``wi`` (d, d_ff)), so a reference pytree
carries across leaf for leaf (``repro_torch.convert``).

* Attention goes through ``repro_torch.kernels.ops``; ``kernels="cuda"``
  (the default) launches the hand-written kernels, ``kernels="ref"``
  runs their plain versions. ``"cuda"`` with CPU tensors raises.
* Matrix products run in the activation dtype through ``torch.matmul``
  and return that dtype, as the reference's
  ``preferred_element_type=float32`` followed by a cast. The CUDA GEMMs
  accumulate in float32 only under ``float32_gemms``, which the
  transformer's entry points enter: PyTorch's defaults let cuBLAS reduce
  bf16 products in bf16.
* Norms, RoPE and activations compute in float32 and cast back.
* ``self_attention_decode`` writes the new token into the cache tensors
  in place (the reference returns updated copies): a decode step then
  moves no cache bytes besides the one row per sequence.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class Init:
    """Draws weights: a seeded ``torch.Generator`` on ``device``. On the
    ``meta`` device it only shapes them (``model.param_count``)."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)

    def dense(self, shape: tuple, fan_in: int, dtype) -> torch.Tensor:
        """Normal(0, 1/fan_in) in float32, cast to ``dtype``."""
        return self.normal(shape, fan_in ** -0.5, dtype)

    def normal(self, shape: tuple, std: float, dtype) -> torch.Tensor:
        """Normal(0, std^2) in float32, cast to ``dtype``."""
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return w.mul_(std).to(dtype)

    def full(self, shape: tuple, value: float, dtype=torch.float32
             ) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


@contextlib.contextmanager
def float32_gemms():
    """The GEMM numerics the model assumes, for the duration: float32
    products without TF32, and bf16 products reduced in float32 (no
    reduced-precision split-K). The settings are process-wide; the
    caller's are put back on exit. Usable as a decorator."""
    cuda = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(),
             cuda.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("highest")
    cuda.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cuda.allow_bf16_reduced_precision_reduction = saved[1]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype (float32 accumulation in the GEMM under
    ``float32_gemms``)."""
    return torch.matmul(x, w)


# ------------------------------------------------------------------ norms
def rmsnorm_init(init: Init, d: int) -> dict:
    return {"scale": init.full((d,), 0.0)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])).to(x.dtype)


def layernorm_init(init: Init, d: int) -> dict:
    return {"scale": init.full((d,), 1.0), "bias": init.full((d,), 0.0)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return y.to(x.dtype)


def norm_init(init: Init, kind: str, d: int) -> dict:
    return rmsnorm_init(init, d) if kind == "rmsnorm" \
        else layernorm_init(init, d)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    angles = angles[..., None, :]                            # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0          # 0 = global
    softcap: float = 0.0
    causal: bool = True
    use_rope: bool = True
    qk_norm: bool = False    # chameleon-style query/key RMSNorm
    scale: Optional[float] = None


def attention_init(init: Init, spec: AttnSpec, dtype) -> dict:
    """Head-separated weights: wq (d, H, hd), wk / wv (d, Hkv, hd), wo
    (H, hd, d)."""
    d, h, hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    p = {"wq": init.dense((d, h, hd), d, dtype),
         "wk": init.dense((d, hkv, hd), d, dtype),
         "wv": init.dense((d, hkv, hd), d, dtype),
         "wo": init.dense((h, hd, d), h * hd, dtype)}
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(init, hd)
        p["k_norm"] = rmsnorm_init(init, hd)
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, H, hd) -> (..., H, hd)."""
    return matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _proj_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) @ (H, hd, d) -> (..., d)."""
    return matmul(x.flatten(-2), w.reshape(-1, w.shape[-1]))


def _project_qkv(params: dict, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if spec.use_rope:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def self_attention(params: dict, spec: AttnSpec, x: torch.Tensor,
                   positions: torch.Tensor, kernels: str = "cuda"
                   ) -> torch.Tensor:
    """Training / prefill self-attention over a full sequence."""
    q, k, v = _project_qkv(params, spec, x, positions)
    out = ops.attention(q, k, v, causal=spec.causal, window=spec.window,
                        softcap=spec.softcap, scale=spec.scale,
                        segment_pos=positions, impl=kernels)
    return _proj_out(out, params["wo"])


def self_attention_prefill(params: dict, spec: AttnSpec, x: torch.Tensor,
                           positions: torch.Tensor, cache_len: int,
                           kernels: str = "cuda"):
    """Prefill: full attention plus the KV cache, ring-buffered to
    ``cache_len`` slots (slot = position % cache_len, newest tokens win).

    ``positions`` are ascending and contiguous in every row, as every
    caller passes them, so the newest ``min(S, cache_len)`` tokens are
    the winners and land in distinct slots: only those are written. (A
    scatter of all S tokens has duplicate slots when S > cache_len, and
    a CUDA ``index_put_`` does not promise which duplicate write wins.)
    """
    q, k, v = _project_qkv(params, spec, x, positions)
    out = ops.attention(q, k, v, causal=spec.causal, window=spec.window,
                        softcap=spec.softcap, scale=spec.scale,
                        segment_pos=positions, impl=kernels)
    b, s = out.shape[:2]
    y = _proj_out(out, params["wo"])
    n = min(s, cache_len)
    shape = (b, cache_len, spec.n_kv_heads, spec.head_dim)
    k_cache = torch.zeros(shape, dtype=k.dtype, device=k.device)
    v_cache = torch.zeros_like(k_cache)
    kv_pos = torch.full((b, cache_len), -1, dtype=torch.int32,
                        device=k.device)
    newest = positions[:, s - n:]                              # (b, n)
    slots = (newest % cache_len).long()
    bidx = torch.arange(b, device=k.device)[:, None]
    k_cache[bidx, slots] = k[:, s - n:]
    v_cache[bidx, slots] = v[:, s - n:]
    kv_pos[bidx, slots] = newest.to(torch.int32)
    return y, {"k": k_cache, "v": v_cache, "pos": kv_pos}


def self_attention_decode(params: dict, spec: AttnSpec, x: torch.Tensor,
                          cache: dict, q_pos: torch.Tensor,
                          kernels: str = "cuda"):
    """One-token decode. x: (B, 1, d); q_pos: (B,) absolute positions.
    Writes the token's K/V and position into ``cache`` in place and
    returns (y (B, 1, d), cache)."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, spec, x, q_pos[:, None])
    cache_len = cache["k"].shape[1]
    slot = (q_pos % cache_len).long()                          # (B,)
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = q_pos.to(torch.int32)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               cache["pos"], q_pos.to(torch.int32),
                               window=spec.window, softcap=spec.softcap,
                               scale=spec.scale, impl=kernels)
    return _proj_out(out, params["wo"])[:, None, :], cache


# ------------------------------------------------------------------- MLPs
MLP_KINDS = ("swiglu", "geglu", "relu2", "gelu")


def mlp_init(init: Init, d: int, d_ff: int, kind: str, dtype) -> dict:
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp kind {kind}")
    p = {"wi": init.dense((d, d_ff), d, dtype)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = init.dense((d, d_ff), d, dtype)
    p["wo"] = init.dense((d_ff, d), d_ff, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = matmul(x, params["wi"])
    if kind == "swiglu":
        h = F.silu(matmul(x, params["wg"]).to(torch.float32)).to(x.dtype) * h
    elif kind == "geglu":
        h = F.gelu(matmul(x, params["wg"]).to(torch.float32),
                   approximate="tanh").to(x.dtype) * h
    elif kind == "relu2":
        h = F.relu(h.to(torch.float32)).square().to(x.dtype)
    elif kind == "gelu":
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return matmul(h, params["wo"])
