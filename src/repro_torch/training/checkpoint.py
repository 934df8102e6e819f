"""Checkpoints of the port: a tree of tensors <-> a directory of ``.npy``
files, in the reference's on-disk format (``repro.training.checkpoint``),
so that a directory written by either package restores in the other:

* ``<directory>/step_%08d/`` per step, holding one ``<key>.npy`` per
  leaf and ``manifest.json`` = {"step": step, "dtypes": {key: dtype}};
* a leaf's key joins its path with ``__``: dict keys as they are, list
  indices as ``idx{n}``;
* bfloat16 (which numpy lacks) is stored as its ``uint16`` bits, its
  manifest tag ``"bfloat16"``;
* a step is written into a temporary directory and renamed into place,
  and only the last ``keep`` steps are kept.

Trees are the port's: nested dicts and lists of tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

_SEP = "__"


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """[(key, leaf)] in tree order."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, list):
        items = [(f"idx{i}", v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    return [kv for k, v in items for kv in _flatten(v, prefix + (k,))]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def _dtype_tag(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(tree, directory: str, step: int, keep: int = 3) -> str:
    """Write checkpoint ``step`` atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest = {}
    for key, leaf in _flatten(tree):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            arr = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = leaf.numpy()
        np.save(os.path.join(tmp, f"{key}.npy"), arr)
        manifest[key] = _dtype_tag(leaf.dtype)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "dtypes": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def restore(tree_like, directory: str, step: int | None = None,
            device=None):
    """Restore into the structure of ``tree_like`` (each leaf's shape
    must match, else ``ValueError``), in the dtypes the manifest names,
    on ``device`` or, when None, each ``tree_like`` leaf's device. The
    latest step unless ``step`` is given."""
    path = _resolve(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["dtypes"]
    leaves = []
    for key, like in _flatten(tree_like):
        arr = np.load(os.path.join(path, f"{key}.npy"))
        tag = manifest[key]
        if tag == "bfloat16":
            out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(arr).to(getattr(torch, tag))
        if tuple(out.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(out.shape)} vs {tuple(like.shape)}")
        leaves.append(out.to(like.device if device is None else device))
    return _unflatten(tree_like, iter(leaves))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _resolve(directory: str, step: int | None) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step:08d}")


def _gc(directory: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
