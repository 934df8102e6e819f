"""Gemma2-27B — alternating local/global attention with logit softcaps.

46 layers, (local-4096, global) alternating, GQA kv=16, head_dim=128
(attention q-scale 1/sqrt(d_model/n_heads)=144^-0.5 per the paper),
attn softcap 50, final logit softcap 30, GeGLU. [arXiv:2408.00118]

CONFIG_SW is the reference's beyond-paper sliding-window variant for
long_500k: global layers windowed to 32768. Both field for field the
reference's ``repro.configs.gemma2_27b``.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    arch_type="dense",
    source="arXiv:2408.00118",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    layer_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    mlp_kind="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
)

# sliding-window variant for long-context decode (long_500k)
CONFIG_SW = dataclasses.replace(CONFIG, name="gemma2-27b@sw",
                                global_window=32768)
