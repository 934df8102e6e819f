"""Whisper-small — encoder-decoder audio transformer.

12 encoder + 12 decoder layers, d_model=768, 12 heads, d_ff=3072, vocab
51865, GELU, LayerNorm, sinusoidal positions (no RoPE). The
mel-spectrogram + conv frontend is the stubbed modality frontend: the
encoder takes precomputed frame embeddings (B, S, d_model). Decoder
context is 448 tokens. [arXiv:2212.04356] Field for field the
reference's ``repro.configs.whisper_small``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    layer_pattern=("attn",),
    mlp_kind="gelu",
    norm="layernorm",
    use_rope=False,
    max_decoder_len=448,
    frontend="embeddings",
)
