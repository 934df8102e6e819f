"""Mamba2-370m — attention-free SSM with SSD (state-space duality).

48 Mamba-2 blocks, d_model=1024, expand=2 (d_inner=2048), head_dim=64
(32 heads), state N=128, 1 group. O(1) decode state -> runs long_500k.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=1,            # no attention heads; SSM heads derived below
    n_kv_heads=1,
    d_ff=0,               # attn-free, no separate MLP (Mamba2 block only)
    vocab_size=50280,
    head_dim=64,
    layer_pattern=("mamba2",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    use_rope=False,
    norm="rmsnorm",
    tie_embeddings=True,
)
