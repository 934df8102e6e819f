"""AdamW of the port, over its param trees (nested dicts and lists of
tensors): the reference's ``repro.training.optimizer`` with its
arithmetic kept step for step, in float32, cast back to the parameter's
and the state's dtypes:

* global-norm clipping by ``min(1, clip / max(norm, 1e-12))``, the norm
  a float32 sum of per-leaf float32 sums of squares;
* bias correction by division, ``delta = mhat / (sqrt(vhat) + eps)``;
* decoupled weight decay ``wd * p`` on matrices only (``ndim >= 2``),
  or on the leaves a ``decay`` tree names (``train.decay_mask`` gives
  the reference's own choice for a model);
* linear warmup then cosine decay to ``min_lr_ratio * lr``.

``torch.optim.AdamW`` is not used: it places the decay and eps
differently, which rounds differently. The state dtype is the config's
``opt_state_dtype`` (bf16 for the largest configs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts and
    lists; anything else is a leaf); the result has that structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *sub) for sub in zip(*trees)]
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves of a tree, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr; float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params: PyTree, cfg: AdamWConfig) -> dict:
    """{"m", "v": zeros like ``params`` in ``cfg.state_dtype``, "step": a
    0-d int32 tensor}."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: PyTree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def apply_updates(params: PyTree, grads: PyTree, opt_state: dict,
                  cfg: AdamWConfig, decay: PyTree | None = None
                  ) -> tuple[PyTree, dict, dict]:
    """One AdamW step with global-norm clipping and decoupled decay.
    ``decay`` is a tree of bools like ``params`` (which leaves decay),
    by default the matrices (``ndim >= 2``). Returns new trees (the
    inputs are not modified) and {"grad_norm", "lr"}."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = lr_schedule(cfg, step)
    dt = getattr(torch, cfg.state_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, decays):
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decays:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return p_new.to(p.dtype), m32.to(dt), v32.to(dt)

    if decay is None:  # decay matrices only (norms / biases exempt)
        decay = tree_map(lambda p: p.ndim >= 2, params)
    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"],
                   decay)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
