"""``decode_attention``: one query per sequence against its KV cache.

Single-token attention against a ring-buffered cache whose absolute
positions arrive as ``kv_pos`` (-1 for a slot never written), with GQA,
sliding window and tanh soft-capping. On the card this is the
hand-written CUDA kernel ``decode_attention_kernel`` in
``csrc/attention.cu`` (one block per batch row and kv head, serving that
head's query heads, so each cache row is read once); it replaces the TPU
kernel ``src/repro/kernels/decode_attention.py:decode_attention``.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.decode_attention_ref``. There is no
fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import DTYPE_CODE, check_heads
from repro_torch.kernels.routing_score import check_input, stream_ptr


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     q_pos: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None
                     ) -> torch.Tensor:
    """q: (B, H, D); k_cache, v_cache: (B, C, Hkv, D), float32 or
    bfloat16; kv_pos: (B, C) int32; q_pos: (B,) int32. Returns (B, H, D)
    in q's dtype."""
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
    out = torch.empty_like(q)
    from repro_torch.kernels._build import library
    lib = library("attention")
    rc = lib.lib.laimr_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        DTYPE_CODE[q.dtype], b, c, h, hkv, d, float(scale), int(window),
        float(softcap), stream_ptr(dev))
    lib.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
