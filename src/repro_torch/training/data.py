"""Synthetic token pipeline: seeded, deterministic. The port's own copy
of the reference's ``repro.training.data`` (numpy only): the same
``default_rng`` draws in the same order, so a seed gives the same
tokens bit for bit in both packages. Batches are numpy; the trainer
moves them to the device.

No corpus ships with the repo: the stream is structured pseudo-text (a
Zipf-distributed token stream with local correlations), so the loss
actually decreases; a uniform stream has irreducible loss log(V) and
would hide optimizer bugs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticText:
    """Markov-ish synthetic stream: next = (prev * 31 + 7) % V with
    probability 0.7 (learnable structure), else a Zipf draw."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)

    def _zipf(self, size) -> np.ndarray:
        v = self.cfg.vocab_size
        z = self._rng.zipf(self.cfg.zipf_a, size=size)
        return np.minimum(z - 1, v - 1).astype(np.int32)

    def batch(self) -> dict:
        """{"tokens", "labels"}: (batch_size, seq_len) int32 each, the
        labels the tokens shifted by one."""
        c = self.cfg
        toks = np.empty((c.batch_size, c.seq_len + 1), np.int32)
        toks[:, 0] = self._zipf((c.batch_size,))
        noise = self._rng.uniform(size=(c.batch_size, c.seq_len)) < 0.3
        zipf_draws = self._zipf((c.batch_size, c.seq_len))
        for t in range(1, c.seq_len + 1):
            det = (toks[:, t - 1].astype(np.int64) * 31 + 7) % c.vocab_size
            toks[:, t] = np.where(noise[:, t - 1], zipf_draws[:, t - 1], det)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch()
