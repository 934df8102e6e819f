"""The family of a Nemotron-H hybrid stack, such as
NVIDIA-Nemotron-3-Nano-30B-A3B: one layer per character of the
configuration's ``hybrid_pattern`` (the published
``hybrid_override_pattern``), each one sublayer behind its own pre-norm:
``M`` a grouped-gate Mamba-2 mixer (``hybrid_mamba``), ``E`` experts
(``hybrid_moe``), ``*`` attention alone (``hybrid_attn``). The weights,
references and counts are the three kinds' own."""
from __future__ import annotations

#: the layer kind of each character of the pattern
KINDS = {"M": "hybrid_mamba", "E": "hybrid_moe", "*": "hybrid_attn"}


def kinds(dims) -> list[str]:
    return [KINDS[c] for c in dims["hybrid_pattern"]]
