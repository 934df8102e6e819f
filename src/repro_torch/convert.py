"""Carry routing state across from the JAX package's host arrays.

This system has no model weights: the candidate table (one row of
latency-law parameters per deployment) and the Erlang-C wait table are
its state. :func:`candidate_table_from_numpy` takes them as plain numpy
arrays — e.g. the columns of a reference ``CandidateTable`` and a
``build_erlang_table`` output — and returns the port's device-resident
columns, ready for ``repro_torch.kernels.ops``. Only numpy crosses the
boundary, so this module imports neither framework's package.
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
