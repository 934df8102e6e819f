"""DBRX-132B — fine-grained MoE: 16 experts, top-4.

40 layers, d_model=6144, 48 heads (kv=8), expert d_ff=10752, vocab
100352, SwiGLU experts, LayerNorm. [hf:databricks/dbrx-base] Field for
field the reference's ``repro.configs.dbrx_132b``; its distribution
hints are kept for parity: the port serves it on one card cut in depth.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    layer_pattern=("attn",),
    n_experts=16,
    top_k=4,
    mlp_kind="swiglu",
    norm="layernorm",
    serve_fsdp=True,
    opt_state_dtype="bfloat16",
)
