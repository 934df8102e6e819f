"""Plain float32 reference of a Nemotron-H stack, such as
NVIDIA-Nemotron-3-Nano-30B-A3B: ``model_ref.logits`` runs it layer by
layer, each by the reference of its kind (``families/nemotron_h.py``
lays them out by the pattern): ``hybrid_mamba``, ``hybrid_moe`` and
``hybrid_attn``, named here by kind. The embedding, the final norm and
the head are ``model_ref``'s. Nothing of the program is imported."""
from __future__ import annotations

from laimr_bench.reference import hybrid_attn, hybrid_mamba, hybrid_moe

#: the reference of each layer kind of the stack
KINDS = {"hybrid_mamba": hybrid_mamba, "hybrid_moe": hybrid_moe,
         "hybrid_attn": hybrid_attn}
