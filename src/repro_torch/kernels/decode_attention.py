"""``decode_attention``: one query per sequence against its KV cache.

Single-token attention against a ring-buffered cache whose absolute
positions arrive as ``kv_pos`` (-1 for a slot never written), with GQA,
sliding window and tanh soft-capping. On the card this is the
hand-written CUDA kernel ``decode_attention_kernel`` in
``csrc/attention.cu``: split-KV (flash-decoding), one block per split of
the cache, kv head and batch row, serving that head's query heads so each
cache row is read once; the last split of a (batch row, kv head) to
finish merges the splits' softmax states inside the same launch. It
replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.decode_attention_ref``. There is no
fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.flash_attention import DTYPE_CODE, check_heads
from repro_torch.kernels.routing_score import check_input, stream_ptr

#: cache slots a split spans at least (the kernel's bf16 tile)
SPLIT_TILE = 64
#: blocks per SM the split count aims for (two waves)
WAVES = 2


def split_plan(b: int, hkv: int, c: int, sms: int) -> tuple[int, int]:
    """(splits, slots per split) for a cache of ``c`` slots shared by
    ``b * hkv`` (batch row, kv head) pairs on a card of ``sms`` SMs.

    Enough splits that the grid holds ``WAVES * sms`` blocks, each split
    at least one tile and a whole number of tiles (the last may be
    ragged), none empty; one split when the pairs alone fill the card.
    Split ``s`` covers slots ``[s * per, min(c, (s + 1) * per))``.
    """
    pairs = max(b * hkv, 1)
    tiles = -(-c // SPLIT_TILE)
    want = 1 if pairs >= WAVES * sms else -(-WAVES * sms // pairs)
    per = -(-tiles // min(want, tiles))          # tiles per split
    return -(-tiles // per), per * SPLIT_TILE


_SMS: dict[int, int] = {}
_WORK: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, n_part: int,
               n_tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The split merge's scratch for one device and stream, kept across
    calls and grown by size: the float32 partials (m, l, acc per query
    head and split) and the int32 arrival tickets, zeroed once when made;
    every launch leaves them 0. Launches on one stream run in order, so a
    launch's partials are merged before the next launch writes them."""
    key = (dev.index, stream)
    part, tickets = _WORK.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                              device=dev)
    _WORK[key] = (part, tickets)
    return part, tickets


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None
                     ) -> torch.Tensor:
    """q: (B, H, D); k_cache, v_cache: (B, C, Hkv, D), float32 or
    bfloat16; kv_pos: (B, C) int32; q_pos: (B,) int32. Returns (B, H, D)
    in q's dtype."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_pos, q_pos,
                                        window=window, softcap=softcap,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}: expected (B, H, D) and "
                         f"(B, C, Hkv, D)")
    b, h, d = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    check_heads(q, h, hkv, d)
    dev = q.device
    # the kernel reads q and cache rows 16 bytes at a time
    check_input("q", q, ((b, h, d),), dev, q.dtype, align=16)
    check_input("k_cache", k_cache, ((b, c, hkv, d),), dev, q.dtype,
                align=16)
    check_input("v_cache", v_cache, ((b, c, hkv, d),), dev, q.dtype,
                align=16)
    check_input("kv_pos", kv_pos, ((b, c),), dev, torch.int32)
    check_input("q_pos", q_pos, ((b,),), dev, torch.int32)
    if c < 1 or window < 0:
        raise ValueError(f"decode_attention: C {c}, window {window}")
    scale = d ** -0.5 if scale is None else scale
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, per = split_plan(b, hkv, c, _SMS[dev.index])
    out = torch.empty_like(q)
    stream = stream_ptr(dev)
    part = tickets = None
    if splits > 1:
        part, tickets = _workspace(dev, stream, b * h * splits * (d + 2),
                                   b * hkv)
    from repro_torch.kernels._build import library
    lib = library("attention")
    rc = lib.lib.laimr_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        DTYPE_CODE[q.dtype], b, c, h, hkv, d, splits, per, float(scale),
        int(window), float(softcap), stream)
    lib.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
