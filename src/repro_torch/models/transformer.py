"""Decoder-only transformer assembly of the port.

The reference (``repro.models.transformer``) stacks each pattern
period's parameters and runs a ``lax.scan`` over periods; here the
layers are a plain list, in order (period by period, then the
remainder layers), and every entry point is a Python loop over them.
The reference's ``constrain_batch`` sharding hint has no single-device
counterpart and is dropped.

Three entry points: ``forward`` (full logits), ``prefill`` (last-token
logits plus the cache), ``decode_step`` (one token per sequence), each
run under ``layers.float32_gemms``.
Layer kinds ``"attn"``, ``"local"`` (attention with a KV cache) and
``"mamba2"`` (``models/ssm.py``, with a conv buffer and an SSM state) are
ported; ``"rglru"`` and mixture-of-experts layers raise
``NotImplementedError`` naming the ``ROADMAP.md`` item where they wait.
As in the reference, a ``"mamba2"`` layer is the whole layer: it never
carries an MLP, whatever ``d_ff`` is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, ssm

ATTN_KINDS = ("attn", "local")
NOT_PORTED = {
    "rglru": "ROADMAP.md queue 1 item c (RG-LRU layers)",
}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is one the port runs."""
    for kind in cfg.layer_pattern:
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers are not ported yet: "
                f"{NOT_PORTED[kind]}")
        if kind not in ATTN_KINDS + ("mamba2",):
            raise ValueError(f"unknown layer kind {kind}")
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts layers are not ported yet: "
            "ROADMAP.md queue 1 item b (MoE)")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of every layer, in order: n_periods full patterns, then
    the remainder."""
    return list(cfg.layer_pattern) * cfg.n_periods \
        + list(cfg.layer_pattern[:cfg.n_remainder_layers])


def attn_spec(cfg: ArchConfig, kind: str) -> layers.AttnSpec:
    window = cfg.window if kind == "local" else cfg.global_window
    return layers.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=window,
        softcap=cfg.attn_softcap, causal=True, use_rope=cfg.use_rope,
        qk_norm=cfg.qk_norm, scale=cfg.attn_scale)


def cache_len_for(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind == "local":
        return min(cfg.window, max_len)
    if cfg.global_window > 0:
        return min(cfg.global_window, max_len)
    return max_len


def _has_mlp(cfg: ArchConfig, kind: str) -> bool:
    # Mamba-2 blocks are the whole layer; attention layers carry an MLP.
    return cfg.d_ff > 0 and kind != "mamba2"


# ------------------------------------------------------------------ init
def layer_init(init: layers.Init, cfg: ArchConfig, kind: str) -> dict:
    dt = dtype_of(cfg)
    p = {"norm1": layers.norm_init(init, cfg.norm, cfg.d_model)}
    if kind in ATTN_KINDS:
        p["attn"] = layers.attention_init(init, attn_spec(cfg, kind), dt)
    else:
        p["mixer"] = ssm.init(init, cfg, dt)
    if _has_mlp(cfg, kind):
        p["norm2"] = layers.norm_init(init, cfg.norm, cfg.d_model)
        p["mlp"] = layers.mlp_init(init, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_kind, dt)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the reference's shapes and init scales: {"embed" (V, d),
    "layers": [per-layer dicts], "final_norm", "lm_head" (d, V) unless
    tied}."""
    check_ported(cfg)
    init = layers.Init(seed, device)
    dt = dtype_of(cfg)
    params: dict = {
        "embed": init.dense((cfg.vocab_size, cfg.d_model), cfg.d_model, dt),
        "layers": [layer_init(init, cfg, kind) for kind in layer_kinds(cfg)],
        "final_norm": layers.norm_init(init, cfg.norm, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_size),
                                       cfg.d_model, dt)
    return params


# --------------------------------------------------------------- forward
def _mlp_block(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor
               ) -> torch.Tensor:
    if not _has_mlp(cfg, kind):
        return x
    h = layers.apply_norm(cfg.norm, p["norm2"], x)
    return x + layers.mlp(p["mlp"], h, cfg.mlp_kind)


def _embed(params: dict, cfg: ArchConfig, inp: torch.Tensor) -> torch.Tensor:
    if cfg.frontend == "embeddings" or inp.ndim == 3:
        return inp.to(dtype_of(cfg))
    return params["embed"][inp.long()]


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head with a float32 result. bf16 x bf16 products
    are exact in float32, so a float32 GEMM of the upcast operands is
    the reference's bf16 product with float32 accumulation and output; a
    bf16 GEMM would round the logits to bf16 and flip greedy tokens."""
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


@layers.float32_gemms()
def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, kernels: str = "cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> ((B, S, V) float32 logits, aux loss 0)."""
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, x.device)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        if kind in ATTN_KINDS:
            x = x + layers.self_attention(p["attn"], attn_spec(cfg, kind), h,
                                          positions, kernels)
        else:
            x = x + ssm.forward(p["mixer"], cfg, h, kernels=kernels)
        x = _mlp_block(p, cfg, kind, x)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


# ---------------------------------------------------------------- caches
def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device="cuda") -> dict:
    if kind == "mamba2":
        return ssm.init_state(cfg, batch, dtype_of(cfg), device)
    c = cache_len_for(cfg, kind, max_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "pos": torch.full((batch, c), -1, dtype=torch.int32,
                              device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"
               ) -> dict:
    """{"layers": [one dict per layer]}: {"k", "v" (batch, C, Hkv, hd),
    "pos" (batch, C)} for attention layers, C = max_len for global
    layers, min(window, max_len) for local ones, pos -1 marking a slot
    never written; {"conv" (batch, W-1, conv channels), "ssm" (batch, H,
    P, N) float32} for Mamba-2 layers, zeros."""
    check_ported(cfg)
    return {"layers": [init_layer_cache(cfg, kind, batch, max_len, device)
                       for kind in layer_kinds(cfg)]}


# --------------------------------------------------------------- prefill
@layers.float32_gemms()
def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, kernels: str = "cuda"
            ) -> tuple[torch.Tensor, dict]:
    """Prefill pass: ((B, V) float32 last-token logits, cache). An
    attention layer's cache depth is ``max_len``, or the prompt length S
    when it is None (as in the reference); a Mamba-2 layer's state has
    no depth."""
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    caches = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        if kind in ATTN_KINDS:
            y, c = layers.self_attention_prefill(
                p["attn"], attn_spec(cfg, kind), h, positions,
                cache_len_for(cfg, kind, max_len), kernels)
        else:
            y, c = ssm.forward(p["mixer"], cfg, h, return_state=True,
                               kernels=kernels)
        x = _mlp_block(p, cfg, kind, x + y)
        caches.append(c)
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :], {"layers": caches}


# ----------------------------------------------------------------- decode
@layers.float32_gemms()
def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor, kernels: str = "cuda"
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B,) ints (or (B, d) embeddings); pos:
    (B,) absolute positions. Returns ((B, V) float32 logits, cache); the
    cache is updated in place."""
    if tokens.ndim == 1 and cfg.frontend == "tokens":
        x = params["embed"][tokens.long()][:, None, :]
    else:
        x = tokens.to(dtype_of(cfg))[:, None, :]
    for p, kind, c in zip(params["layers"], layer_kinds(cfg),
                          cache["layers"]):
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        if kind in ATTN_KINDS:
            y, _ = layers.self_attention_decode(
                p["attn"], attn_spec(cfg, kind), h, c, pos, kernels)
        else:
            y, _ = ssm.decode_step(p["mixer"], cfg, h, c)
        x = _mlp_block(p, cfg, kind, x + y)
    return _logits(params, cfg, x)[:, 0, :], cache
