"""StableLM-3B: compact dense decoder, MHA (kv == heads).

32 layers, d_model=2560, 32 heads of 80, d_ff=6912, vocab 50304.
[hf:stabilityai/stablelm-2-1_6b family]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    norm="layernorm",
)
