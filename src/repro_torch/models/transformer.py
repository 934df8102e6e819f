"""Decoder-only transformer assembly of the port.

The reference (``repro.models.transformer``) stacks each pattern
period's parameters and runs a ``lax.scan`` over periods; here the
layers are a plain list, in order (period by period, then the
remainder layers), and every entry point is a Python loop over them.
The reference's ``constrain_batch`` sharding hint sits at the same
places (after the embedding and at every layer boundary), and also on
the MLP's input: on a DTensor under the dry run's hooks it redistributes
the residual stream (without the MLP's, DTensor reduce-scatters the
attention's row-parallel output over d_model and then gathers the MLP's
column-parallel weights whole), on a plain tensor it returns its
argument (``repro_torch.distributed``).

Three entry points: ``forward`` (full logits), ``prefill`` (last-token
logits plus the cache), ``decode_step`` (one token per sequence), each
run under ``layers.float32_gemms`` (whose settings end with the call: a
training step enters it around its backward too,
``repro_torch.training.train``). Under ``cfg.remat`` ``forward``
recomputes each layer in the backward (:func:`remat`).
Every layer kind of the reference is ported: ``"attn"`` and ``"local"``
(attention with a KV cache), ``"mamba2"`` (``models/ssm.py``, with a conv
buffer and an SSM state) and ``"rglru"`` (``models/rglru.py``, with a
conv buffer and a hidden state). As in the reference, a ``"mamba2"``
layer is the whole layer: it never carries an MLP, whatever ``d_ff`` is;
an ``"rglru"`` layer carries one, as an attention layer does. With
``n_experts > 0`` that MLP is a mixture of experts (``layers.moe``),
beside a dense MLP under ``dense_residual``; ``forward`` returns the sum
of the layers' load-balance losses, ``prefill`` and ``decode_step`` drop
them, as the reference does.

A hybrid stack (``cfg.hybrid_pattern``, Nemotron-H; the reference has
none) lays out one layer a character, each layer ONE sublayer behind its
own pre-norm and a residual add: ``"hybrid_mamba"`` (a Mamba-2 mixer,
cached as a ``"mamba2"`` layer), ``"hybrid_moe"`` (the dropless mixture
of experts alone, ``layers.moe_dropless``, no cache) and
``"hybrid_attn"`` (attention alone, cached as an ``"attn"`` layer).
Norms take ``cfg.norm_eps`` where it is set. ``prefill`` and
``decode_step`` add each expert layer's routing to the device's expert
counters (``layers.expert_counters``), phase 0 and phase 1.

A ``"parallel_hybrid"`` layer (Falcon-H1; the reference has none) runs
attention and a Mamba-2 mixer side by side on ONE normed input and adds
both into the residual, then the MLP behind its own norm::

  h = norm1(x);  x = x + attn(h) + mamba(h);  x = x + mlp(norm2(x))

through the same kernels as an attention and a Mamba-2 layer. Its cache
is one dict with both kinds of state: the attention ring (``k``, ``v``,
``pos``) and the mixer's ``conv`` buffer and ``ssm`` state.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import HYBRID_KINDS, ArchConfig
from repro_torch.distributed.sharding import constrain_batch, embed_lookup
from repro_torch.models import layers, rglru, ssm

ATTN_KINDS = ("attn", "local", "hybrid_attn")
#: attention and a Mamba-2 mixer side by side, then an MLP
PARALLEL = "parallel_hybrid"
#: recurrent layer kind -> its module: init, forward (with state,
#: return_state and kernels), init_state and an in-place decode_step
#: (with kernels)
MIXERS = {"mamba2": ssm, "rglru": rglru, "hybrid_mamba": ssm}
#: layer kinds that are one sublayer, with no MLP after it
SINGLE = tuple(HYBRID_KINDS.values())


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is of a kind the port runs."""
    for kind in cfg.layer_pattern:
        if kind not in ATTN_KINDS + tuple(MIXERS) + (PARALLEL,):
            raise ValueError(f"unknown layer kind {kind}")
    for c in cfg.hybrid_pattern:
        if c not in HYBRID_KINDS:
            raise ValueError(f"unknown hybrid layer {c!r}")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of every layer, in order: the hybrid pattern's, or
    n_periods full patterns, then the remainder."""
    if cfg.hybrid_pattern:
        return [HYBRID_KINDS[c] for c in cfg.hybrid_pattern]
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
    # Mamba-2 blocks and a hybrid stack's layers are the whole layer;
    # attention/rglru layers carry an MLP.
    return cfg.d_ff > 0 and kind != "mamba2" and kind not in SINGLE


def _norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layers.apply_norm(cfg.norm, p, x, cfg.norm_eps)


# ------------------------------------------------------------------ init
def layer_init(init: layers.Init, cfg: ArchConfig, kind: str) -> dict:
    dt = dtype_of(cfg)
    p = {"norm1": layers.norm_init(init, cfg.norm, cfg.d_model)}
    if kind == "hybrid_moe":
        p["moe"] = layers.moe_init(init, cfg.d_model, cfg.d_ff,
                                   cfg.n_experts, cfg.mlp_kind, dt,
                                   select_bias=True,
                                   shared_d_ff=cfg.shared_d_ff)
    elif kind in ATTN_KINDS:
        p["attn"] = layers.attention_init(init, attn_spec(cfg, kind), dt)
    elif kind == PARALLEL:
        p["attn"] = layers.attention_init(init, attn_spec(cfg, kind), dt)
        p["mixer"] = ssm.init(init, cfg, dt)
    else:
        p["mixer"] = MIXERS[kind].init(init, cfg, dt)
    if _has_mlp(cfg, kind):
        p["norm2"] = layers.norm_init(init, cfg.norm, cfg.d_model)
        if cfg.n_experts > 0:
            p["moe"] = layers.moe_init(init, cfg.d_model, cfg.d_ff,
                                       cfg.n_experts, cfg.mlp_kind, dt)
            if cfg.dense_residual:
                p["dense_mlp"] = layers.mlp_init(init, cfg.d_model,
                                                 cfg.d_ff, cfg.mlp_kind, dt)
        else:
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
def _mlp_block(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor):
    """The layer's MLP residual: (x, the MoE aux loss or None). The
    reference's order of adds: the experts' output, plus the dense
    residual's, then onto x."""
    if not _has_mlp(cfg, kind):
        return x, None
    x = constrain_batch(x)
    h = _norm(cfg, p["norm2"], x)
    if cfg.n_experts == 0:
        return x + layers.mlp(p["mlp"], h, cfg.mlp_kind), None
    y, aux = layers.moe(p["moe"], h, top_k=cfg.top_k, kind=cfg.mlp_kind,
                        capacity_factor=cfg.capacity_factor)
    if cfg.dense_residual:
        y = y + layers.mlp(p["dense_mlp"], h, cfg.mlp_kind)
    return x + y, aux


def _embed(params: dict, cfg: ArchConfig, inp: torch.Tensor) -> torch.Tensor:
    if cfg.frontend == "embeddings" or inp.ndim == 3:
        return inp.to(dtype_of(cfg))
    return embed_lookup(params["embed"], inp)


#: float32 elements of the head upcast at a time in ``_logits``
HEAD_BLOCK = 1 << 28


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head with a float32 result. bf16 x bf16 products
    are exact in float32, so a float32 GEMM of the upcast operands is
    the reference's bf16 product with float32 accumulation and output; a
    bf16 GEMM would round the logits to bf16 and flip greedy tokens. A
    head of more than ``HEAD_BLOCK`` elements is upcast a block of
    vocabulary columns at a time (each logit is its own column's sum),
    so no float32 copy of a whole 18432 x 256000 head is made."""
    x = _norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    x = x.to(torch.float32)
    parts = [torch.matmul(x, block.to(torch.float32)) for block in
             head.split(max(1, HEAD_BLOCK // head.shape[0]), dim=1)]
    logits = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def _experts(p: dict, cfg: ArchConfig, h: torch.Tensor, kernels: str,
             counters: Optional[tuple] = None) -> torch.Tensor:
    """A ``"hybrid_moe"`` layer's sublayer on the normed stream h."""
    return layers.moe_dropless(p["moe"], h, top_k=cfg.top_k,
                               kind=cfg.mlp_kind,
                               routed_scale=cfg.routed_scale,
                               kernels=kernels, counters=counters)


def _layer(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
           positions: torch.Tensor, kernels: str):
    """One layer of the training forward: (x, its MoE aux loss or
    None)."""
    h = _norm(cfg, p["norm1"], x)
    if kind == "hybrid_moe":
        return x + _experts(p, cfg, h, kernels), None
    if kind in ATTN_KINDS:
        x = x + layers.self_attention(p["attn"], attn_spec(cfg, kind), h,
                                      positions, kernels)
    elif kind == PARALLEL:
        x = x + (layers.self_attention(p["attn"], attn_spec(cfg, kind), h,
                                       positions, kernels)
                 + ssm.forward(p["mixer"], cfg, h, kernels=kernels))
    else:
        x = x + MIXERS[kind].forward(p["mixer"], cfg, h, kernels=kernels)
    return _mlp_block(p, cfg, kind, x)


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward instead of saving its
    activations when ``cfg.remat`` and autograd records (grad mode on and
    a tensor among ``args``, a layer's params included, requires grad):
    the reference's ``jax.checkpoint`` with nothing saveable, a layer at
    a time. The forward draws no random numbers, so no rng state is
    kept."""
    if cfg.remat and layers.records_grad(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


@layers.float32_gemms()
def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, kernels: str = "cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> ((B, S, V) float32 logits, the sum of the MoE
    layers' aux losses, 0 without experts). Each layer is rematerialised
    in the backward under ``cfg.remat`` (:func:`remat`)."""
    x = constrain_batch(_embed(params, cfg, tokens))
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        x, a = remat(cfg, _layer, p, cfg, kind, constrain_batch(x),
                     positions, kernels)
        if a is not None:
            aux = aux + a
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------- caches
def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device="cuda") -> dict:
    if kind == "hybrid_moe":
        return {}
    if kind in MIXERS:
        return MIXERS[kind].init_state(cfg, batch, dtype_of(cfg), device)
    c = cache_len_for(cfg, kind, max_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    ring = {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "pos": torch.full((batch, c), -1, dtype=torch.int32,
                              device=device)}
    if kind == PARALLEL:
        ring.update(ssm.init_state(cfg, batch, dtype_of(cfg), device))
    return ring


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"
               ) -> dict:
    """{"layers": [one dict per layer]}: {"k", "v" (batch, C, Hkv, hd),
    "pos" (batch, C)} for attention layers, C = max_len for global
    layers, min(window, max_len) for local ones, pos -1 marking a slot
    never written; {"conv" (batch, W-1, conv channels), "ssm" (batch, H,
    P, N) float32} for Mamba-2 layers, {"conv" (batch, W-1, w), "h"
    (batch, w) float32} for RG-LRU layers, zeros; {} for an expert
    layer; both a ring's and a Mamba-2 layer's keys for a parallel
    layer."""
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
    when it is None (as in the reference); a Mamba-2 or RG-LRU layer's
    state has no depth."""
    x = constrain_batch(_embed(params, cfg, tokens))
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    caches = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        x = constrain_batch(x)
        h = _norm(cfg, p["norm1"], x)
        if kind == "hybrid_moe":
            x = x + _experts(p, cfg, h, kernels,
                             (layers.expert_counters(x.device), 0))
            caches.append({})
            continue
        if kind in ATTN_KINDS:
            y, c = layers.self_attention_prefill(
                p["attn"], attn_spec(cfg, kind), h, positions,
                cache_len_for(cfg, kind, max_len), kernels)
        elif kind == PARALLEL:
            y, c = layers.self_attention_prefill(
                p["attn"], attn_spec(cfg, kind), h, positions,
                cache_len_for(cfg, kind, max_len), kernels)
            m, state = ssm.forward(p["mixer"], cfg, h, return_state=True,
                                   kernels=kernels)
            y = y + m
            c.update(state)
        else:
            y, c = MIXERS[kind].forward(p["mixer"], cfg, h,
                                        return_state=True, kernels=kernels)
        x, _ = _mlp_block(p, cfg, kind, x + y)
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
        x = embed_lookup(params["embed"], tokens)[:, None, :]
    else:
        x = tokens.to(dtype_of(cfg))[:, None, :]
    for p, kind, c in zip(params["layers"], layer_kinds(cfg),
                          cache["layers"]):
        x = constrain_batch(x)
        h = _norm(cfg, p["norm1"], x)
        if kind == "hybrid_moe":
            x = x + _experts(p, cfg, h, kernels,
                             (layers.expert_counters(x.device), 1))
            continue
        if kind in ATTN_KINDS:
            y, _ = layers.self_attention_decode(
                p["attn"], attn_spec(cfg, kind), h, c, pos, kernels)
        elif kind == PARALLEL:
            y, _ = layers.self_attention_decode(
                p["attn"], attn_spec(cfg, kind), h, c, pos, kernels)
            y = y + ssm.decode_step(p["mixer"], cfg, h, c, kernels)[0]
        else:
            y, _ = MIXERS[kind].decode_step(p["mixer"], cfg, h, c, kernels)
        x, _ = _mlp_block(p, cfg, kind, x + y)
    return _logits(params, cfg, x)[:, 0, :], cache
