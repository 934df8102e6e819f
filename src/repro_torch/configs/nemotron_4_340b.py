"""Nemotron-4-340B — dense decoder, GQA, squared-ReLU MLP.

96 layers, d_model=18432, 96 heads (kv=8), d_ff=73728 (non-gated
squared-ReLU), vocab 256000. The heavyweight of the pool; its
distribution hints (AdamW state in bf16, serve-time FSDP) are the
reference's, kept for field parity: the port serves it on one card cut
in depth. [arXiv:2402.16819]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    layer_pattern=("attn",),
    mlp_kind="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    serve_fsdp=True,
    opt_state_dtype="bfloat16",
)
