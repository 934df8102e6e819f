"""Architecture and input-shape configs of the port.

The port's own copy of the reference's ``repro.configs.base`` (plain
dataclasses, no framework): :class:`ArchConfig`, :data:`SHAPES` and
:func:`reduced` hold every field of the reference's, with the same
values for its architectures. Fields the reference lacks follow its
fields, under "hybrid stacks and their experts"; their defaults keep
every other architecture as the reference computes it. Every
architecture of the reference is ported: each is a module
``repro_torch/configs/<id>.py`` exposing ``CONFIG``, and ``WAITING``
(architectures not ported yet) is empty. ``REFERENCE_IDS`` are the
reference's architectures; ``ARCH_IDS`` adds the port's own
(NVIDIA-Nemotron-3-Nano-30B-A3B, a Mamba-2 / expert / attention
hybrid, and Falcon-H1-34B, whose every layer runs attention and a
Mamba-2 mixer side by side).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

#: the reference's architectures
REFERENCE_IDS = [
    "chameleon_34b", "mamba2_370m", "recurrentgemma_2b", "nemotron_4_340b",
    "gemma2_27b", "dbrx_132b", "stablelm_3b", "arctic_480b",
    "whisper_small", "phi3_medium_14b",
]
ARCH_IDS = REFERENCE_IDS + ["nemotron_3_nano", "falcon_h1_34b"]
#: architectures the port runs
PORTED = ("stablelm_3b", "mamba2_370m", "recurrentgemma_2b", "gemma2_27b",
          "phi3_medium_14b", "chameleon_34b", "nemotron_4_340b",
          "dbrx_132b", "arctic_480b", "whisper_small", "nemotron_3_nano",
          "falcon_h1_34b")
#: the layer kind of each character of ``ArchConfig.hybrid_pattern``
HYBRID_KINDS = {"M": "hybrid_mamba", "E": "hybrid_moe", "*": "hybrid_attn"}
#: architectures not ported yet -> where they wait in ROADMAP.md (none)
WAITING: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense|moe|ssm|hybrid|vlm|audio
    source: str                    # citation (paper/model card)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # layer pattern, cycled over layers; entries:
    #   "attn" (global), "local" (sliding window), "rglru", "mamba2",
    #   "parallel_hybrid" (attention and a Mamba-2 mixer on one normed
    #   input, then the MLP; the reference has no such layer)
    layer_pattern: tuple = ("attn",)
    window: int = 4096             # sliding-window size for "local" layers
    global_window: int = 0         # >0: window for "attn" layers too

    mlp_kind: str = "swiglu"       # swiglu|geglu|relu2|gelu
    norm: str = "rmsnorm"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    rglru_width: int = 0           # recurrent width (d_rnn); 0 -> d_model

    # attention extras
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    attn_scale: Optional[float] = None

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_decoder_len: int = 448

    # frontend: "tokens" (ids) or "embeddings" (stubbed modality frontend)
    frontend: str = "tokens"

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # distribution hints (kept for field parity with the reference)
    serve_fsdp: bool = False
    opt_state_dtype: str = "float32"
    remat: bool = True

    # hybrid stacks and their experts (fields the reference lacks)
    # one character a layer ("M" Mamba-2, "E" experts, "*" attention), each
    # layer one sublayer behind its own pre-norm; "" -> layer_pattern
    hybrid_pattern: str = ""
    norm_eps: float = 0.0          # 0 -> the norm's own: 1e-6 RMS, 1e-5 Layer
    routed_scale: float = 1.0      # an "E" layer's weights: scores x this
    shared_d_ff: int = 0           # >0: a shared expert of this width
    ssm_heads: int = 0             # 0 -> ssm_expand * d_model // ssm_head_dim
    # the gated norm: rmsnorm(y * silu(z)) over ssm_groups groups when
    # True, else rmsnorm(y) * silu(z) over the whole width
    ssm_gate_first: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.hybrid_pattern and len(self.hybrid_pattern) != self.n_layers:
            raise ValueError(f"{self.name}: hybrid_pattern has "
                             f"{len(self.hybrid_pattern)} layers, n_layers "
                             f"{self.n_layers}")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % self.period


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in PORTED:
        raise KeyError(f"unknown architecture {arch_id!r}; known: "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def reduced(cfg: ArchConfig, seq_hint: int = 128) -> ArchConfig:
    """The CPU smoke-test variant: same family, tiny dimensions.

    2 layers (rounded up to one full pattern period), d_model <= 256,
    <= 4 experts, vocab truncated, float32. A hybrid stack keeps its
    whole pattern, with at most 8 SSM heads and widths of at most 512; a
    stack of ``"parallel_hybrid"`` layers keeps at most 8 SSM heads too.
    """
    period = max(len(cfg.layer_pattern), 2)
    hybrid = {}
    if cfg.hybrid_pattern:
        period = len(cfg.hybrid_pattern)
        hybrid = dict(
            shared_d_ff=min(cfg.shared_d_ff, 512),
            ssm_heads=min(cfg.ssm_heads, 8),
            ssm_groups=math.gcd(cfg.ssm_groups, min(cfg.ssm_heads, 8)))
    elif "parallel_hybrid" in cfg.layer_pattern:
        hybrid = dict(
            ssm_heads=min(cfg.ssm_heads, 8),
            ssm_groups=math.gcd(cfg.ssm_groups, min(cfg.ssm_heads, 8)))
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    changes = dict(
        n_layers=period,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        window=min(cfg.window, seq_hint // 2) if cfg.window else 0,
        global_window=min(cfg.global_window, seq_hint // 2)
        if cfg.global_window else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        rglru_width=min(cfg.rglru_width, 256) if cfg.rglru_width else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        dtype="float32",
        opt_state_dtype="float32",
        name=cfg.name + "-reduced",
    )
    return dataclasses.replace(cfg, **changes, **hybrid)
