"""Chameleon-34B — early-fusion VLM: image VQ tokens are ordinary vocab ids.

The VQ-GAN tokenizer is the reference's stubbed modality frontend: the
language transformer below is complete and consumes mixed text+image
token ids from the 65536-entry vocabulary. QK-norm per the Chameleon
paper's training-stability fix. [arXiv:2405.09818]

Field for field the reference's ``repro.configs.chameleon_34b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=10000.0,
    frontend="tokens",        # early fusion: VQ image tokens ARE tokens
    serve_fsdp=False,
    opt_state_dtype="float32",
)
