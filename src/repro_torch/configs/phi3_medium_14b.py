"""Phi-3-medium-14B — dense decoder: RoPE, SwiGLU, GQA.

40 layers, d_model=5120, 40 heads (kv=10), d_ff=17920, vocab 100352.
[arXiv:2404.14219] Field for field the reference's
``repro.configs.phi3_medium_14b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    source="arXiv:2404.14219",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    norm="rmsnorm",
)
