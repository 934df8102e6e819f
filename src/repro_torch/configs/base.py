"""Architecture and input-shape configs of the port.

The port's own copy of the reference's ``repro.configs.base`` (plain
dataclasses, no framework): :class:`ArchConfig`, :data:`SHAPES` and
:func:`reduced` are the same, field for field. Every ported architecture
is a module ``repro_torch/configs/<id>.py`` exposing ``CONFIG``;
:func:`get_config` of an architecture whose layers are not ported yet
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item where it
waits.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = [
    "chameleon_34b", "mamba2_370m", "recurrentgemma_2b", "nemotron_4_340b",
    "gemma2_27b", "dbrx_132b", "stablelm_3b", "arctic_480b",
    "whisper_small", "phi3_medium_14b",
]
#: architectures the port runs
PORTED = ("stablelm_3b", "mamba2_370m")
#: the others -> where they wait in ROADMAP.md
WAITING = {
    "dbrx_132b": "queue 1 item b (MoE layers)",
    "arctic_480b": "queue 1 item b (MoE layers)",
    "recurrentgemma_2b": "queue 1 item c (RG-LRU layers)",
    "whisper_small": "queue 1 item d (the encoder-decoder)",
    "chameleon_34b": "queue 1 item h (the other dense-decoder configs)",
    "gemma2_27b": "queue 1 item h (the other dense-decoder configs)",
    "nemotron_4_340b": "queue 1 item h (the other dense-decoder configs)",
    "phi3_medium_14b": "queue 1 item h (the other dense-decoder configs)",
}


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
    #   "attn" (global), "local" (sliding window), "rglru", "mamba2"
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

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

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
    if arch_id in WAITING:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it waits in ROADMAP.md "
            f"{WAITING[arch_id]}")
    if arch_id not in PORTED:
        raise KeyError(f"unknown architecture {arch_id!r}; known: "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def reduced(cfg: ArchConfig, seq_hint: int = 128) -> ArchConfig:
    """The CPU smoke-test variant: same family, tiny dimensions.

    2 layers (rounded up to one full pattern period), d_model <= 256,
    <= 4 experts, vocab truncated, float32.
    """
    period = max(len(cfg.layer_pattern), 2)
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
    return dataclasses.replace(cfg, **changes)
