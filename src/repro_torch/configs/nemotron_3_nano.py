"""NVIDIA-Nemotron-3-Nano-30B-A3B — a Mamba-2 / expert / attention hybrid.

52 layers laid out by ``hybrid_override_pattern``, each one sublayer
behind its own RMSNorm (eps 1e-5) with a residual add: 23 Mamba-2
mixers ("M": 64 heads of 64, so an inner width of 4096, state 128, 8
groups, conv 4 with a bias, the gated norm rmsnorm(y * silu(z)) over 8
groups of 512), 23 expert layers ("E": a float32 sigmoid router over
128 relu² experts of width 1856 (``d_ff``: no layer has a dense MLP),
top 6 chosen on score + selection bias, the chosen scores normalised
and scaled by 2.5, a shared relu² expert of width 3712 added unscaled)
and 6 GQA layers ("*": 32 query and 2 key /
value heads of 128, no bias, no MLP). d_model 2688, vocabulary 131,072,
untied head. 31.58 B parameters, 3.23 B active beside the embedding.
The published modeling code applies no rotary embedding, although the
config carries ``rope_theta``: none here either.
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]
"""
from repro_torch.configs.base import ArchConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ArchConfig(
    name="nemotron-3-nano-30b-a3b",
    arch_type="hybrid",
    source="https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-"
           "BF16/blob/main/config.json",
    n_layers=52,
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    d_ff=1856,
    vocab_size=131072,
    head_dim=128,
    hybrid_pattern=PATTERN,
    mlp_kind="relu2",
    norm="rmsnorm",
    norm_eps=1e-5,
    n_experts=128,
    top_k=6,
    routed_scale=2.5,
    shared_d_ff=3712,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_heads=64,
    ssm_groups=8,
    conv_width=4,
    ssm_gate_first=True,
    use_rope=False,
    tie_embeddings=False,
)
