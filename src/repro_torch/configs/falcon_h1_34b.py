"""Falcon-H1-34B-Instruct — attention and Mamba-2 heads side by side.

72 layers, each of the ``"parallel_hybrid"`` kind: one RMSNorm (eps
1e-5), then on the same normed input a GQA attention (20 query and 4 key / value
heads of 128, no bias, rotary over the whole head at theta 1e11) and a
Mamba-2 mixer (32 heads of 128, so ``mamba_d_ssm`` 4096, state 256, 2
groups, conv 4 with a bias, the gated norm rmsnorm(y * silu(z)) over 2
groups of 2048), both added into the residual; then a second RMSNorm
and a SwiGLU MLP of width 21,504. d_model 5120, vocabulary 261,120,
untied head, bf16. 33.64 B parameters.

The published model scales nine places by muP multipliers
(``MULTIPLIERS``, as ``config.json`` gives them). Each scales a linear
map, or a product that a SiLU or the rotary embedding then reads
linearly, so ``repro_torch.convert.falcon_h1_params`` folds them into
the weights and the served model carries none; nothing else reads
them. ``mamba_use_mlp`` adds no weight (the published modeling code
does not read it).
[hf:tiiuae/Falcon-H1-34B-Instruct]
"""
from repro_torch.configs.base import ArchConfig

#: the published muP multipliers (``config.json``); ``ssm_multipliers``
#: scale the in_proj output's z, x, B, C and dt segments in that order,
#: ``mlp_multipliers`` the gate projection's output and the MLP's output
MULTIPLIERS = {
    "embedding_multiplier": 5.656854249492381,
    "lm_head_multiplier": 0.0078125,
    "attention_in_multiplier": 1.0,
    "key_multiplier": 0.011048543456039804,
    "attention_out_multiplier": 0.0375,
    "ssm_in_multiplier": 0.25,
    "ssm_multipliers": (0.3535533905932738, 0.25, 0.1767766952966369, 0.5,
                        0.3535533905932738),
    "ssm_out_multiplier": 0.08838834764831845,
    "mlp_multipliers": (0.1767766952966369, 0.011160714285714284),
}

CONFIG = ArchConfig(
    name="falcon-h1-34b-instruct",
    arch_type="hybrid",
    source="https://huggingface.co/tiiuae/Falcon-H1-34B-Instruct/blob/main/"
           "config.json",
    n_layers=72,
    d_model=5120,
    n_heads=20,
    n_kv_heads=4,
    d_ff=21504,
    vocab_size=261120,
    head_dim=128,
    layer_pattern=("parallel_hybrid",),
    mlp_kind="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=1e11,
    ssm_state=256,
    ssm_head_dim=128,
    ssm_expand=2,
    ssm_heads=32,
    ssm_groups=2,
    conv_width=4,
    ssm_gate_first=True,
    tie_embeddings=False,
)
