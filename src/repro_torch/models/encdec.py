"""Whisper-style encoder-decoder of the port. arXiv:2212.04356.

The twin of the reference's ``repro.models.encdec``. The mel-spectrogram
and conv feature extractor is the stubbed modality frontend: the encoder
takes precomputed frame embeddings (B, S_audio, d_model) and adds
sinusoidal positions. The encoder is bidirectional; the decoder is
causal, with cross-attention to the encoder states. Serving keeps a
self-attention KV ring per decoder layer and precomputed cross K/V.

The reference stacks its blocks over layers and scans them; here the
layers are plain lists and every entry point a Python loop, as in
``transformer.py``, with its ``constrain_batch`` points after the
embedding, at every layer boundary and on each MLP's input. Params:
{"embed" (V, d), "enc_layers": [...], "enc_norm", "dec_layers": [...],
"final_norm", "lm_head" (d, V)}. The
cache is {"layers": [one dict per decoder layer]} with "k", "v"
(B, max_decoder_len, Hkv, hd), "pos" (B, max_decoder_len) and
"cross_k", "cross_v" (B, enc_len, Hkv, hd); ``decode_step`` writes the
self K/V in place.

A reference quirk kept on purpose: ``decode_step`` adds the sinusoid of
position 0 to every decoded token, whatever its position (the
reference's ``[None, :1]`` slice of the table).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain_batch, embed_lookup
from repro_torch.models import layers
from repro_torch.models.transformer import (_logits, _positions, dtype_of,
                                             remat)


def _spec(cfg: ArchConfig, causal: bool) -> layers.AttnSpec:
    return layers.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, causal=causal, use_rope=False,
        softcap=cfg.attn_softcap)


def _enc_layer_init(init: layers.Init, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    return {
        "norm1": layers.norm_init(init, cfg.norm, cfg.d_model),
        "attn": layers.attention_init(init, _spec(cfg, False), dt),
        "norm2": layers.norm_init(init, cfg.norm, cfg.d_model),
        "mlp": layers.mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                               dt),
    }


def _dec_layer_init(init: layers.Init, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    return {
        "norm1": layers.norm_init(init, cfg.norm, cfg.d_model),
        "self_attn": layers.attention_init(init, _spec(cfg, True), dt),
        "norm_x": layers.norm_init(init, cfg.norm, cfg.d_model),
        "cross_attn": layers.cross_attention_init(init, _spec(cfg, False),
                                                  dt),
        "norm2": layers.norm_init(init, cfg.norm, cfg.d_model),
        "mlp": layers.mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                               dt),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the reference's shapes and init scales."""
    init = layers.Init(seed, device)
    dt = dtype_of(cfg)
    return {
        "embed": init.dense((cfg.vocab_size, cfg.d_model), cfg.d_model, dt),
        "enc_layers": [_enc_layer_init(init, cfg)
                       for _ in range(cfg.n_encoder_layers)],
        "enc_norm": layers.norm_init(init, cfg.norm, cfg.d_model),
        "dec_layers": [_dec_layer_init(init, cfg)
                       for _ in range(cfg.n_layers)],
        "final_norm": layers.norm_init(init, cfg.norm, cfg.d_model),
        "lm_head": init.dense((cfg.d_model, cfg.vocab_size), cfg.d_model,
                              dt),
    }


def _mlp(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = constrain_batch(x)
    h = layers.apply_norm(cfg.norm, p["norm2"], x)
    return x + layers.mlp(p["mlp"], h, cfg.mlp_kind)


def _cross(p: dict, cfg: ArchConfig, x: torch.Tensor, enc_k, enc_v,
           kernels: str) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, p["norm_x"], x)
    return x + layers.cross_attention(p["cross_attn"], _spec(cfg, False), h,
                                      enc_k, enc_v, kernels)


def _embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Token embeddings plus the sinusoids of positions 0 .. T-1."""
    t = tokens.shape[1]
    return embed_lookup(params["embed"], tokens) \
        + layers.sinusoidal_positions(t, cfg.d_model, tokens.device)[None] \
        .to(dtype_of(cfg))


# ---------------------------------------------------------------- encoder
@layers.float32_gemms()
def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor,
           kernels: str = "cuda") -> torch.Tensor:
    """frames: (B, S, d), the stubbed frontend's output -> encoder states
    (B, S, d)."""
    b, s, d = frames.shape
    dt = dtype_of(cfg)
    x = constrain_batch(frames.to(dt) + layers.sinusoidal_positions(
        s, d, frames.device)[None].to(dt))
    positions = _positions(b, s, x.device)
    for p in params["enc_layers"]:
        x = remat(cfg, _enc_layer, p, cfg, constrain_batch(x), positions,
                  kernels)
    return layers.apply_norm(cfg.norm, params["enc_norm"], x)


def _enc_layer(p: dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, kernels: str) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    x = x + layers.self_attention(p["attn"], _spec(cfg, False), h, positions,
                                  kernels)
    return _mlp(p, cfg, x)


# ---------------------------------------------------------------- decoder
@layers.float32_gemms()
def forward(params: dict, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor, kernels: str = "cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames, decoder tokens (B, T)) -> ((B, T, V) float32 logits,
    aux 0)."""
    enc_out = encode(params, cfg, frames, kernels)
    x = constrain_batch(_embed_tokens(params, cfg, tokens))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for p in params["dec_layers"]:
        x = remat(cfg, _dec_layer, p, cfg, constrain_batch(x), enc_out,
                  positions, kernels)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def _dec_layer(p: dict, cfg: ArchConfig, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor,
               kernels: str) -> torch.Tensor:
    k, v = layers.cross_kv(p["cross_attn"], _spec(cfg, False), enc_out)
    h = layers.apply_norm(cfg.norm, p["norm1"], x)
    x = x + layers.self_attention(p["self_attn"], _spec(cfg, True), h,
                                  positions, kernels)
    return _mlp(p, cfg, _cross(p, cfg, x, k, v, kernels))


# --------------------------------------------------------------- serving
def init_cache(cfg: ArchConfig, batch: int, enc_len: int, device="cuda"
               ) -> dict:
    """Zeros, positions -1: per decoder layer a self-attention ring of
    ``max_decoder_len`` slots and cross K/V of ``enc_len`` frames."""
    dt = dtype_of(cfg)
    t, hkv, hd = cfg.max_decoder_len, cfg.n_kv_heads, cfg.head_dim

    def layer():
        return {"k": torch.zeros((batch, t, hkv, hd), dtype=dt,
                                 device=device),
                "v": torch.zeros((batch, t, hkv, hd), dtype=dt,
                                 device=device),
                "pos": torch.full((batch, t), -1, dtype=torch.int32,
                                  device=device),
                "cross_k": torch.zeros((batch, enc_len, hkv, hd), dtype=dt,
                                       device=device),
                "cross_v": torch.zeros((batch, enc_len, hkv, hd), dtype=dt,
                                       device=device)}
    return {"layers": [layer() for _ in range(cfg.n_layers)]}


@layers.float32_gemms()
def prefill(params: dict, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor, kernels: str = "cuda"
            ) -> tuple[torch.Tensor, dict]:
    """Encode the frames, precompute each layer's cross K/V and prefill
    the decoder's self-KV rings (``max_decoder_len`` deep). Returns
    ((B, V) float32 last-token logits, cache)."""
    enc_out = encode(params, cfg, frames, kernels)
    x = constrain_batch(_embed_tokens(params, cfg, tokens))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    spec = _spec(cfg, True)
    caches = []
    for p in params["dec_layers"]:
        x = constrain_batch(x)
        ck, cv = layers.cross_kv(p["cross_attn"], _spec(cfg, False), enc_out)
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        y, kv = layers.self_attention_prefill(
            p["self_attn"], spec, h, positions, cfg.max_decoder_len, kernels)
        x = _mlp(p, cfg, _cross(p, cfg, x + y, ck, cv, kernels))
        caches.append({**kv, "cross_k": ck, "cross_v": cv})
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :], {"layers": caches}


@layers.float32_gemms()
def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor, kernels: str = "cuda"
                ) -> tuple[torch.Tensor, dict]:
    """One decoder token per sequence against the self-KV ring and the
    cross K/V. tokens: (B,) ints; pos: (B,) absolute positions. Returns
    ((B, V) float32 logits, cache); the self K/V is written in place.
    Every token gets the sinusoid of position 0 (the reference's)."""
    x = embed_lookup(params["embed"], tokens)[:, None, :] + \
        layers.sinusoidal_positions(1, cfg.d_model, tokens.device)[None] \
        .to(dtype_of(cfg))
    spec = _spec(cfg, True)
    for p, c in zip(params["dec_layers"], cache["layers"]):
        x = constrain_batch(x)
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        y, _ = layers.self_attention_decode(p["self_attn"], spec, h, c, pos,
                                            kernels)
        x = _mlp(p, cfg, _cross(p, cfg, x + y, c["cross_k"], c["cross_v"],
                                kernels))
    return _logits(params, cfg, x)[:, 0, :], cache
