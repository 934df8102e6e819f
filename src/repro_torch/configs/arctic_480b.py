"""Snowflake Arctic-480B — 128-expert top-2 MoE with a dense residual path.

35 layers, d_model=7168, 56 heads (kv=8), expert d_ff=4864, a parallel
dense MLP residual per layer (dense-MoE hybrid), vocab 32000.
[hf:Snowflake/snowflake-arctic-base] Field for field the reference's
``repro.configs.arctic_480b``; the port serves it on one card cut in
depth.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    arch_type="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    layer_pattern=("attn",),
    n_experts=128,
    top_k=2,
    dense_residual=True,
    mlp_kind="swiglu",
    norm="rmsnorm",
    serve_fsdp=True,
    opt_state_dtype="bfloat16",
)
