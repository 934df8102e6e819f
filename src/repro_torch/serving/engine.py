"""Batched serving engine of the port.

The prefill and decode functions plus a small continuous-batching
engine, as the reference ``repro.serving.engine``: requests join and
leave decode slots between steps, which is how the router's replica
pools map onto the card's batch slots. The engine runs on the card
unless the caller passes ``device="cpu"``; ``kernels`` picks the
hand-written kernels (``"cuda"``, default) or their plain versions
(``"ref"``). The cache is the model's: KV rings for attention layers,
conv buffers and SSM states for Mamba-2 layers, nothing for an expert
layer; both paths of ``generate`` carry any mix of them. ``generate``
prefills attention rings ``max_len`` deep (a prompt longer than
``max_len`` is refused where the cache holds a ring; Mamba-2 states
have no depth), so a full wave decodes past its prompt without
overwriting it, and a partial wave's merge overwrites every position a
previous wave left in its rows (their keys marked -1: never attended).

On a CUDA device the decode step is one CUDA graph: the first ``step``
runs eagerly on the engine's own stream, then captures the same work
(embedding, every layer, final norm and head, the greedy tokens into
``current``, ``pos`` advanced) on that stream, and every later step
replays it. The graph is bound to tensors the engine owns: ``current``,
``pos`` and one static cache, so none of them is ever rebound; the
tokens' read-back stays outside the graph. A CPU device, or params or a
cache of DTensors (collectives are not captured), step eagerly. A kernel
wrapper's ``launches`` counts its calls, so the first step's eager run
and its capture each count once and a replay, which calls no wrapper,
not at all: the kernels a replay runs are read from a device trace.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_structure

from repro_torch.configs.base import ArchConfig
from repro_torch.core.telemetry import TRACER
from repro_torch.distributed.sharding import _is_dtensor
from repro_torch.models import layers, model


def make_prefill_fn(cfg: ArchConfig, kernels: str = "cuda",
                    max_len: Optional[int] = None):
    """(params, batch) -> (last-token logits, cache): attention rings
    ``max_len`` deep, or as deep as the prompt when it is None."""
    def fn(params, batch):
        return model.prefill(params, cfg, batch, kernels=kernels,
                             max_len=max_len)
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
        self._prefill = make_prefill_fn(cfg, kernels, max_len)
        # the expert layers' routing counters, read with the tokens only
        # while TRACER is on (made here, before any graph is captured);
        # the last read on the host and the calls made by then
        self._experts = layers.expert_counters(self.device).phase \
            if "E" in cfg.hybrid_pattern else None
        self._experts_read = None
        self._shape_counts = cache_counts(self.cache, slots)
        self._calls = 0              # generate and step calls
        self._graphable = self.device.type == "cuda" \
            and not any_dtensor(params)
        self._graph = None           # torch.cuda.CUDAGraph of one step
        self._graph_logits = None    # its logits, written by each replay
        self._static = None          # the cache the graph reads and writes
        self._static_ok = False      # whether that cache can be captured
        self._stream = None
        self.graph_captures = 0
        self.graph_replays = 0

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
        sid = TRACER.open("engine.step") if TRACER.on else -1
        try:
            if sid >= 0:
                before = self._experts_before()
                TRACER.stage("engine.step.launch")
            self._calls += 1
            if not (self._graphable and self._bind_cache()):
                self._launch()
            elif self._graph is None:
                self._capture(sid)
            else:
                self._graph.replay()
                self.graph_replays += 1
                if sid >= 0:
                    TRACER.replayed()
            if sid >= 0:
                TRACER.stage("engine.step.readback")
            out = self.current.to("cpu", copy=True).numpy()
            if sid >= 0:
                self._trace_experts(before, 1)
                par, ssm_row, ring_row, _ = self._shape_counts
                TRACER.streams(par, 2 * self.slots * ssm_row,
                               self.slots * ring_row)
            return out
        finally:
            if sid >= 0:
                TRACER.close(sid)

    def _experts_before(self):
        """The expert counters at a traced span's start, on the host: the
        previous span's read when no call ran since, else (the first
        traced call after untraced ones) a copy of them, the one read
        that waits for the device; None without expert layers."""
        if self._experts is None:
            return None
        if self._experts_read is not None \
                and self._experts_read[1] == self._calls:
            return self._experts_read[0]
        return self._experts.to("cpu", copy=True)

    def _trace_experts(self, before, phase: int) -> None:
        """The expert counters' change since ``before``, of row
        ``phase`` (0 prefill, 1 decode), onto the open span: launches,
        rows, experts touched and most rows on one expert, summed. Read
        after the tokens' read-back, so the copy waits for nothing, and
        kept for the next span's start."""
        if before is not None:
            now = self._experts.to("cpu", copy=True)
            self._experts_read = (now, self._calls)
            TRACER.experts(*(now[phase] - before[phase]).tolist())

    def _launch(self) -> torch.Tensor:
        """The decode step's device work on the current stream: the model
        step, its greedy tokens into ``current`` and ``pos`` advanced, in
        place. Returns the float32 logits (slots, V)."""
        logits, self.cache = self._decode(self.params, self.current,
                                          self.cache, self.pos)
        self.current.copy_(torch.argmax(logits, dim=-1))
        self.pos.add_(1)
        return logits

    def _bind_cache(self) -> bool:
        """Point ``cache`` at the graph's static cache; False where the
        step runs eagerly (a cache of DTensors).

        ``generate`` with B == slots adopts the prefill cache. When every
        tensor of it has the static one's shape and dtype it is copied
        into the static tensors and dropped; otherwise (the first binding,
        or a cache of another layout) the graph is dropped and the adopted
        cache becomes the static one of the next capture."""
        if self.cache is self._static:
            return self._static_ok
        if self._static_ok and same_layout(self._static, self.cache):
            copy_into(self._static, self.cache)
            self.cache = self._static
            return True
        self._graph = self._graph_logits = None
        self._static = self.cache
        self._static_ok = not any_dtensor(self.cache)
        return self._static_ok

    def _capture(self, sid: int) -> None:
        """This step eagerly on the engine's own stream, which also makes
        the kernels' per-stream scratch there, then the same work captured
        on that stream as one CUDA graph (the capture runs nothing)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            self._launch()
        if sid >= 0:
            TRACER.stage("engine.step.capture")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            logits = self._launch()
        main.wait_stream(stream)
        self._graph, self._graph_logits = graph, logits
        self.graph_captures += 1

    def generate(self, prompts, steps: int) -> GenerationResult:
        """Prefill ``prompts`` (B <= slots, S; S <= max_len where the
        cache holds attention rings) then greedy-decode ``steps`` tokens
        (the first from the prefill logits).

        The prefill's attention rings are ``max_len`` deep: with B ==
        slots the engine adopts that cache, with B < slots it is merged
        into the engine's cache (``_merge_batch``), every position of the
        leading rows written.
        (The reference adopts an S-deep ring at B == slots, whose first
        decode step overwrites the prompt's first key.)"""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s = prompts.shape[:2]
        if b > self.slots:
            raise ValueError(f"generate: {b} prompts for {self.slots} "
                             "slots")
        if s > self.max_len and any("pos" in layer
                                    for layer in self.cache["layers"]):
            raise ValueError(f"generate: prompts of {s} positions; the "
                             f"attention rings hold max_len {self.max_len}")
        sid = TRACER.open("engine.generate", rows=b, steps=steps) \
            if TRACER.on else -1
        try:
            if sid >= 0:
                before = self._experts_before()
                TRACER.stage("engine.prefill")
            self._calls += 1
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
            self.current.zero_()
            self.current[:b] = first
            self.pos.zero_()
            self.pos[:b] = s
            self.active[:b] = True
            if sid >= 0:
                TRACER.stage("engine.readback")
            out = [self.current[:b].to("cpu", copy=True).numpy()]
            if sid >= 0:
                self._trace_experts(before, 0)
                par, ssm_row, ring_row, kv_pos = self._shape_counts
                TRACER.streams(par, b * ssm_row,
                               b * min(s, self.max_len) * kv_pos)
                # the decode steps nest in generate as engine.step spans
                TRACER.end_stage()
            for _ in range(steps - 1):
                out.append(self.step()[:b])
            return GenerationResult(tokens=np.stack(out, axis=1),
                                    steps=steps)
        finally:
            if sid >= 0:
                TRACER.close(sid)


def _merge_batch(full: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` into ``full`` at the leading corner, in place.

    A prefilled cache tensor can be smaller than the engine's along BOTH
    the batch-slot axis (b < slots) and the cache-depth axis (prompt
    length < max_len), so every differing axis is sliced to ``new``'s
    extent — not just the first mismatch."""
    full[tuple(slice(0, ns) for ns in new.shape)] = new


def cache_counts(cache: dict, slots: int) -> tuple[int, int, int, int]:
    """From a cache's shapes, no device read: (its layers that hold both
    an attention ring and a Mamba-2 state, the SSM state's bytes a row,
    the rings' key and value bytes a row, their bytes a position and
    row)."""
    par = ssm_row = ring_row = kv_pos = 0
    for layer in cache.get("layers", ()):
        if "ssm" in layer and "k" in layer:
            par += 1
        if "ssm" in layer:
            t = layer["ssm"]
            ssm_row += t.numel() // slots * t.element_size()
        if "k" in layer:
            kv = layer["k"].numel() // slots * layer["k"].element_size() \
                + layer["v"].numel() // slots * layer["v"].element_size()
            ring_row += kv
            kv_pos += kv // layer["k"].shape[1]
    return par, ssm_row, ring_row, kv_pos


def any_dtensor(tree) -> bool:
    """Whether a tensor of ``tree`` is a DTensor."""
    return any(_is_dtensor(t) for t in tree_leaves(tree))


def same_layout(a, b) -> bool:
    """Whether two caches have one structure, with tensors of one shape,
    dtype and device in each place."""
    return tree_structure(a) == tree_structure(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


def copy_into(dst, src) -> None:
    """Copy every tensor of cache ``src`` into ``dst``'s, in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)
