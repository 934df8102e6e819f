"""Model families: what the harness needs to know of a configuration's
layers, found by the configuration's ``layer_kind`` as cells, loops and
metrics are found by their names.

A stack is a list of layer kinds, one a layer: those that the family
module ``families/<layer_kind>.py`` gives by ``kinds(dims)``, or, where
it has no ``kinds``, every layer of the kind ``layer_kind`` itself. A
layer kind is a module here of the same form (``attn``, ``mamba2``),
which provides

- ``layer(cfg, path)``: (random leaves: path -> (shape, std), fixed
  leaves: [(path, (maker, shape, dtype kind))]) of one layer of the
  program's parameter tree, in the order ``replica.make_params`` draws
  them. A maker is ``"zeros"`` or ``"ones"`` (in float32, or in the
  model dtype where the dtype kind is ``"model"``) or a callable
  ``maker(generator, shape, device)`` that returns the tensor, in any
  dtype;
- ``layer_prefill_flops(dims, b, s)`` and ``layer_decode_flops(dims,
  pos)``: one layer's model FLOPs, which ``metrics/counts.py`` sums;
- ``KERNELS``: the kernels (``"flash_attention"``, ``"ssd_scan"``) that
  one such layer launches once a prefill;
- optionally ``check(cfg)``: raise ``ValueError`` where the port's
  ``ArchConfig`` gives this kind of layer a shape it does not describe;
- optionally ``fp8_in_dims(path, leaf)``: the dimensions that the fp8
  control's scale of one of its leaves (``path`` inside the layer)
  reduces, or None for the rule of ``reference/model_ref.quantize_fp8``.
  The family's own, where it has one, rules the embedding and the head;

and its plain reference is ``reference/<kind>.py``, whose ``layer(p,
dims, x)`` ``reference/model_ref.logits`` runs layer by layer (and,
where it has them, its ``check(dims)`` first and ``CHUNK``, a multiple
that the sequence is padded to). ``dims`` is the configuration under
the port's field names (``replica.dims``, or an ``ArchConfig``'s
fields). A stack that mixes kinds is a family
module with ``kinds`` alone; a new kind of layer (experts, say) is a new
module here and one under ``reference/``. Neither edits a file that
exists. Nothing here imports the program.
"""
from __future__ import annotations

import importlib


def get(kind: str):
    """The family module of layer kind ``kind``. Raises ``ValueError``,
    naming the kind, where there is none."""
    name = f"{__name__}.{kind}"
    if not kind.isidentifier():
        raise ValueError(f"no model family for layer kind {kind!r}")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no model family for layer kind {kind!r} "
                         f"(laimr_bench/families/{kind}.py)") from None


def kinds(family: str, dims) -> list[str]:
    """The layer kind of every layer of a stack of the family
    ``family``, in order."""
    fam = get(family)
    if hasattr(fam, "kinds"):
        return list(fam.kinds(dims))
    return [family] * dims["n_layers"]


def launches(family: str, dims, kernel: str) -> int:
    """How many layers of a stack of ``family`` launch ``kernel`` in one
    prefill."""
    return sum(kernel in get(k).KERNELS for k in kinds(family, dims))


def norm(cfg, path: tuple, d: int) -> list:
    """The fixed leaves of one of the port's norms of width ``d``."""
    if cfg.norm == "rmsnorm":
        return [(path + ("scale",), ("zeros", (d,), None))]
    return [(path + ("scale",), ("ones", (d,), None)),
            (path + ("bias",), ("zeros", (d,), None))]


def weights(family: str, cfg) -> tuple[dict, list]:
    """The random and fixed leaves of a stack of ``family`` (layer i
    those of its kind's ``layer``): the embedding first, the final norm,
    and the head where it is not tied."""
    d, v = cfg.d_model, cfg.vocab_size
    rand: dict = {("embed",): ((v, d), d ** -0.5)}
    fixed: list = []
    for i, kind in enumerate(kinds(family, vars(cfg))):
        r, f = get(kind).layer(cfg, ("layers", i))
        rand.update(r)
        fixed += f
    fixed += norm(cfg, ("final_norm",), d)
    if not cfg.tie_embeddings:
        rand[("lm_head",)] = ((d, v), d ** -0.5)
    return rand, fixed
