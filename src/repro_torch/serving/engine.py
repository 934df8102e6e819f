"""Batched serving engine of the port.

The prefill and decode functions plus a small continuous-batching
engine, as the reference ``repro.serving.engine``: requests join and
leave decode slots between steps, which is how the router's replica
pools map onto the card's batch slots. The engine runs on the card
unless the caller passes ``device="cpu"``; ``kernels`` picks the
hand-written kernels (``"cuda"``, default) or their plain versions
(``"ref"``). The cache is the model's: KV rings for attention layers,
conv buffers and SSM states for Mamba-2 layers; both paths of
``generate`` carry either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model


def make_prefill_fn(cfg: ArchConfig, kernels: str = "cuda"):
    """(params, batch) -> (last-token logits, cache)."""
    def fn(params, batch):
        return model.prefill(params, cfg, batch, kernels=kernels)
    return fn


def make_decode_fn(cfg: ArchConfig, kernels: str = "cuda"):
    """(params, tokens, cache, pos) -> (logits, cache): ONE new token per
    sequence against the cache."""
    def fn(params, tokens, cache, pos):
        return model.decode_step(params, cfg, tokens, cache, pos,
                                 kernels=kernels)
    return fn


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, steps)
    steps: int


class ServingEngine:
    """Greedy batched generation with slot-based continuous batching.

    The engine owns a fixed-size decode batch (``slots``); sequences are
    assigned to free slots after prefill and release them on completion.
    This is the data-plane object an LA-IMR 'replica' models: its service
    rate is one decode step across all active slots.
    """

    def __init__(self, cfg: ArchConfig, params: dict, slots: int,
                 max_len: int, device="cuda", kernels: str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.kernels = kernels
        self.cache = model.init_cache(cfg, slots, max_len, self.device)
        self.pos = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self.active = np.zeros((slots,), bool)
        self.current = torch.zeros(slots, dtype=torch.int32,
                                   device=self.device)
        self._decode = make_decode_fn(cfg, kernels)
        self._prefill = make_prefill_fn(cfg, kernels)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if not self.active[i]]

    def n_free(self) -> int:
        return int((~self.active).sum())

    def admit(self, slot: int, first_token: int, start_pos: int) -> None:
        self.active[slot] = True
        self.current[slot] = first_token
        self.pos[slot] = start_pos

    def admit_next(self, first_token: int = 0,
                   start_pos: int = 0) -> Optional[int]:
        """Occupy the first free slot (batch-router admission surface);
        None when the decode batch is full."""
        for i in range(self.slots):
            if not self.active[i]:
                self.admit(i, first_token, start_pos)
                return i
        return None

    def release(self, slot: int) -> None:
        """Free a decode slot. Double release is a loud error: with
        redundant dispatch (first-completion cancellation) a silent
        second release would leave the continuous-batching slot count
        permanently off by one."""
        if not 0 <= slot < self.slots:
            raise IndexError(f"ServingEngine.release({slot}): no such "
                             f"slot (0..{self.slots - 1})")
        if not self.active[slot]:
            raise RuntimeError(
                f"ServingEngine.release({slot}): slot already free — "
                "double release (e.g. of a cancelled duplicate)")
        self.active[slot] = False

    def step(self) -> np.ndarray:
        """One decode step for all slots; returns the new tokens (B,)."""
        logits, self.cache = self._decode(self.params, self.current,
                                          self.cache, self.pos)
        self.current = torch.argmax(logits, dim=-1).to(torch.int32)
        self.pos = self.pos + 1
        return self.current.cpu().numpy()

    def generate(self, prompts, steps: int) -> GenerationResult:
        """Prefill ``prompts`` (B <= slots, S) then greedy-decode
        ``steps`` tokens (the first from the prefill logits).

        With B == slots the engine adopts the prefill cache as it is, a
        ring S deep (``max_len`` unused), as the reference does; with
        B < slots the prefill cache is merged into the engine's
        ``max_len``-deep cache (``_merge_batch``)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s = prompts.shape[:2]
        if b > self.slots:
            raise ValueError(f"generate: {b} prompts for {self.slots} "
                             "slots")
        batch = {"tokens": prompts} if self.cfg.frontend == "tokens" else \
            {"embeddings": prompts}
        logits, cache = self._prefill(self.params, batch)
        if b == self.slots:
            self.cache = cache
        else:
            for full_layer, new_layer in zip(self.cache["layers"],
                                             cache["layers"]):
                for key in full_layer:
                    _merge_batch(full_layer[key], new_layer[key])
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        self.current = torch.zeros(self.slots, dtype=torch.int32,
                                   device=self.device)
        self.current[:b] = first
        self.pos = torch.zeros(self.slots, dtype=torch.int32,
                               device=self.device)
        self.pos[:b] = s
        self.active[:b] = True
        out = [self.current[:b].cpu().numpy()]
        for _ in range(steps - 1):
            out.append(self.step()[:b])
        return GenerationResult(tokens=np.stack(out, axis=1), steps=steps)


def _merge_batch(full: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` into ``full`` at the leading corner, in place.

    A prefilled cache tensor can be smaller than the engine's along BOTH
    the batch-slot axis (b < slots) and the cache-depth axis (prompt
    length < max_len), so every differing axis is sliced to ``new``'s
    extent — not just the first mismatch."""
    full[tuple(slice(0, ns) for ns in new.shape)] = new
