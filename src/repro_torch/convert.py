"""Carry state across from the JAX package's host arrays.

The routing layer's state is the candidate table (one row of
latency-law parameters per deployment) and the Erlang-C wait table:
:func:`candidate_table_from_numpy` takes them as plain numpy arrays —
e.g. the columns of a reference ``CandidateTable`` and a
``build_erlang_table`` output — and returns the port's device-resident
columns, ready for ``repro_torch.kernels.ops``. The model stack's state
is its weights: :func:`model_params_from_numpy` takes a reference
``init_params`` pytree with numpy leaves and returns the port's
parameters. Only numpy crosses the boundary, so this module imports
neither framework's package.
"""
from __future__ import annotations

import numpy as np
import torch

#: float32 candidate columns, each (I,)
F32_COLUMNS = ("alpha", "beta", "gamma", "mu", "rtt", "cost", "tau", "n")
#: optional float32 (I,) columns: the ``reliable`` policy's per-candidate
#: log-dispersion and delivery probability (``routing_attain``)
OPTIONAL_COLUMNS = ("sigma", "avail")


def candidate_table_from_numpy(cols: dict, erlang_table, device="cuda"
                               ) -> dict[str, torch.Tensor]:
    """Device-resident candidate table from numpy columns.

    ``cols`` maps ``alpha``, ``beta``, ``gamma``, ``mu``, ``rtt``,
    ``cost``, ``tau`` and ``n`` to (I,) arrays and ``upstream`` to an
    (I,) int array (-1 at the top tier), and may map ``sigma`` and
    ``avail`` to (I,) arrays (a reference ``ReliableSloPolicy``'s
    ``_sigma`` / ``_avail``); ``erlang_table`` is (I, T). Returns float32
    tensors for those columns, ``upstream`` as int32 and the table under
    ``"erlang_table"``, all contiguous on ``device`` and copied, so they
    never alias the caller's arrays.
    """
    n_cand = len(np.asarray(cols["alpha"]))
    out: dict[str, torch.Tensor] = {}
    for name in F32_COLUMNS + tuple(c for c in OPTIONAL_COLUMNS
                                    if c in cols):
        arr = np.ascontiguousarray(np.asarray(cols[name]), np.float32)
        if arr.shape != (n_cand,):
            raise ValueError(f"column {name!r}: shape {arr.shape}, "
                             f"expected ({n_cand},)")
        out[name] = torch.tensor(arr, device=device)
    up = np.ascontiguousarray(np.asarray(cols["upstream"]), np.int32)
    if up.shape != (n_cand,) or (up >= n_cand).any() or (up < -1).any():
        raise ValueError(f"upstream column {up!r} is not a column map "
                         f"over {n_cand} candidates")
    out["upstream"] = torch.tensor(up, device=device)
    table = np.ascontiguousarray(np.asarray(erlang_table), np.float32)
    if table.ndim != 2 or table.shape[0] != n_cand:
        raise ValueError(f"erlang_table shape {table.shape}, expected "
                         f"({n_cand}, T)")
    out["erlang_table"] = torch.tensor(table, device=device)
    return out


def _leaves(tree, prefix: str = "") -> dict:
    """Flatten nested dicts / lists to {"a/b/0/c": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_leaves(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten_like(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                                else str(i)) for i, v in enumerate(like)]
    return flat[prefix]


def _to_torch(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: carry the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype)


def model_params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """The port's parameters from a reference ``init_params`` pytree.

    ``tree`` has numpy leaves (``jax.tree.map(np.asarray, params)``):
    ``embed``, ``blocks`` (``layer{j}`` dicts stacked over the
    ``cfg.n_periods`` pattern periods), ``remainder`` (a list, when
    ``cfg.n_layers`` is not a multiple of the period), ``final_norm``
    and ``lm_head`` unless tied. Returns the layout of
    ``repro_torch.models.model.init_params(cfg)``: the per-period stacks
    unrolled into one dict per layer, in order, each leaf a copy on
    ``device`` in the port's dtype. A leaf that is missing, extra or of
    the wrong shape raises ``ValueError``.
    """
    from repro_torch.models import model
    shapes = model.init_params(cfg, device="meta")
    want = _leaves(shapes)
    layers = []
    blocks = tree.get("blocks", {})
    for p in range(cfg.n_periods):
        for j in range(cfg.period):
            block = blocks.get(f"layer{j}")
            if block is None:
                raise ValueError(f"params: blocks/layer{j} missing")
            stacked = _leaves(block)
            for path, arr in stacked.items():
                if np.ndim(arr) < 1 or np.shape(arr)[0] != cfg.n_periods:
                    raise ValueError(
                        f"params: blocks/layer{j}/{path} shape "
                        f"{np.shape(arr)}: not stacked over "
                        f"{cfg.n_periods} periods")
            layers.append({path: np.asarray(arr)[p]
                           for path, arr in stacked.items()})
    extra_blocks = set(blocks) - {f"layer{j}" for j in range(cfg.period)}
    if extra_blocks:
        raise ValueError(f"params: unexpected blocks {sorted(extra_blocks)}")
    for rem in tree.get("remainder", []):
        layers.append(_leaves(rem))
    got = {}
    for key, sub in tree.items():
        if key not in ("blocks", "remainder"):
            got.update(_leaves(sub, key))
    for i, layer in enumerate(layers):
        got.update({f"layers/{i}/{path}": arr for path, arr in layer.items()})
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"params: missing {missing}, unexpected {extra}")
    flat = {}
    for path, like in want.items():
        if tuple(np.shape(got[path])) != tuple(like.shape):
            raise ValueError(f"params: {path} shape {np.shape(got[path])}, "
                             f"expected {tuple(like.shape)}")
        flat[path] = _to_torch(got[path], like.dtype, device)
    return _unflatten_like(shapes, flat)
