"""Training step of the port: loss, train state, one AdamW step.

The twin of the reference's ``repro.training.train``: forward ->
softmax cross-entropy (+ ``MOE_AUX_WEIGHT`` x the MoE load-balance loss)
-> backward -> AdamW. Gradients come from ``torch.autograd.grad`` over
the params' float leaves; under ``cfg.remat`` every layer is recomputed
in the backward (``transformer.remat``).

``kernels`` picks the attention / SSD path as in the model functions,
default ``"ref"`` (the reference's default impl), or ``"fused"`` (the
blocked attention with its hand-written backward and the chunked SSD
scan, ``repro_torch.kernels.fused``): the path to train on the card. The
hand-written CUDA kernels have no backward, so ``kernels="cuda"`` raises
before any work. The whole step (forward, backward with its recompute,
and the update) runs in one ``layers.float32_gemms`` scope: no TF32, bf16
GEMMs reduced in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers, model
from repro_torch.training import optimizer as opt

MOE_AUX_WEIGHT = 0.01
#: the model paths a training step may take
TRAIN_KERNELS = ("ref", "fused")


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    opt_cfg: opt.AdamWConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL. logits float32 (B, S, V); labels (B, S) ints."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = sharding.take_last(logits, labels)
    return torch.mean(logz - gold)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            kernels: str = "ref") -> tuple[torch.Tensor, dict]:
    """-> (loss, {"nll", "moe_aux"})."""
    logits, aux = model.forward(params, cfg, batch, kernels=kernels)
    nll = cross_entropy(logits, batch["labels"])
    return nll + MOE_AUX_WEIGHT * aux, {"nll": nll, "moe_aux": aux}


def _check_kernels(kernels: str) -> None:
    if kernels not in TRAIN_KERNELS:
        raise ValueError(f"train with kernels in {TRAIN_KERNELS}, got "
                         f"{kernels!r}: the hand-written kernels have no "
                         "backward; train with kernels='fused' or 'ref'")


def to_device(batch: dict, device) -> dict:
    """A batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(params: dict, cfg: ArchConfig, batch: dict,
                   kernels: str = "ref"):
    """(loss, {"nll", "moe_aux"}, grads): grads a tree like ``params``
    (zeros for a leaf the loss does not reach), each in its leaf's dtype.
    ``params`` are read, not modified; its float leaves are differentiated
    through views that require grad. ``batch`` holds numpy arrays or
    tensors; it is moved to the params' device."""
    _check_kernels(kernels)
    flat = opt.leaves(params)
    batch = to_device(batch, flat[0].device)
    with layers.float32_gemms():
        wrt = [p.detach().requires_grad_(True) for p in flat]
        it = iter(wrt)
        live = opt.tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss, extras = loss_fn(live, cfg, batch, kernels)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
    it = iter(grads)
    return loss.detach(), {k: v.detach() for k, v in extras.items()}, \
        opt.tree_map(lambda _: next(it), params)


def decay_mask(cfg: ArchConfig, params: dict) -> dict:
    """Which leaves AdamW decays, as the reference decides it: a leaf of
    ``ndim >= 2``, where the reference counts the axis it stacks its
    scanned layers over. So every leaf of a scanned layer with an axis
    of its own decays, norm scales and biases included: the decoder's
    first ``n_periods * period`` layers and every encoder and decoder
    layer of the encoder-decoder; remainder layers and the top-level
    leaves decay their matrices only. A tree of bools like ``params``."""
    mask = opt.tree_map(lambda p: p.ndim >= 2, params)
    scanned = {"enc_layers": cfg.n_encoder_layers,
               "dec_layers": cfg.n_layers} if cfg.is_encoder_decoder \
        else {"layers": cfg.n_periods * cfg.period}
    for key, n in scanned.items():
        mask[key][:n] = [opt.tree_map(lambda p: p.ndim >= 1, layer)
                         for layer in params[key][:n]]
    return mask


def make_train_state(cfg: ArchConfig, seed: int = 0, lr: float = 3e-4,
                     total_steps: int = 10_000, device="cuda"
                     ) -> TrainState:
    """Weights from ``model.init_params(cfg, seed)`` and a fresh AdamW
    state in ``cfg.opt_state_dtype``."""
    params = model.init_params(cfg, seed=seed, device=device)
    ocfg = opt.AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype,
                           total_steps=total_steps)
    return TrainState(params=params,
                      opt_state=opt.init_opt_state(params, ocfg),
                      opt_cfg=ocfg)


def make_functional_step(cfg: ArchConfig, ocfg: opt.AdamWConfig,
                         kernels: str = "ref"):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    step, returning new trees. Metrics: "loss", "nll", "moe_aux",
    "grad_norm", "lr" (0-d tensors)."""
    _check_kernels(kernels)

    def step(params, opt_state, batch):
        with layers.float32_gemms():
            loss, extras, grads = value_and_grad(params, cfg, batch,
                                                 kernels)
            new_params, new_opt, stats = opt.apply_updates(
                params, grads, opt_state, ocfg, decay_mask(cfg, params))
        return new_params, new_opt, {"loss": loss, **extras, **stats}
    return step


def train_step(state: TrainState, cfg: ArchConfig, batch: dict,
               kernels: str = "ref") -> tuple[TrainState, dict]:
    """One optimizer step: (new state, metrics). ``kernels="cuda"``
    raises ``ValueError`` before any work."""
    step = make_functional_step(cfg, state.opt_cfg, kernels)
    params, opt_state, metrics = step(state.params, state.opt_state, batch)
    return TrainState(params, opt_state, state.opt_cfg), metrics
