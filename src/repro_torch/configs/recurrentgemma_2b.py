"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1:2 ratio.

26 layers, pattern (RG-LRU, RG-LRU, local-attn) with a 2048-token
sliding window on the attention layers; MQA (kv=1), head_dim=256,
GeGLU MLP. Sub-quadratic -> runs long_500k. [arXiv:2402.19427]
Field for field the reference's ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,                    # 8 full (R,R,A) periods + (R,R) remainder
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru_width=2560,
    mlp_kind="geglu",
    norm="rmsnorm",
    final_softcap=30.0,
    tie_embeddings=True,   # Gemma family ties in/out embeddings (2.7B total)
)
