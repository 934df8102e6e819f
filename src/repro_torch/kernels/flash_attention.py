"""``flash_attention``: prefill attention in one launch.

Blocked online-softmax attention over a whole sequence with GQA, causal
and sliding-window masks and tanh logit soft-capping. On the card this
is the hand-written CUDA kernel ``flash_attention_kernel`` in
``csrc/attention.cu``: for bfloat16 (the served dtype) a tensor-core body
(bf16 ``wgmma`` fed by TMA, one or two warpgroups of 64 query rows per
block), for float32 (the parity dtype) a CUDA-core body; the dtype alone
picks the body. It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention``.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.flash_attention_ref``. There is no
fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.routing_score import check_input, stream_ptr

#: torch dtype -> the launchers' dtype code
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_heads(q: torch.Tensor, h: int, hkv: int, d: int) -> None:
    """The head layout and element types the attention kernels take."""
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"attention kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv {hkv}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernels take a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    segment_pos: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), float32 or bfloat16.
    Returns (B, Sq, H, D) in q's dtype.

    The kernel puts query i at position ``Skv - Sq + i`` (suffix
    alignment), as the TPU kernel does; ``segment_pos`` is accepted for
    parity with the plain version and is not read. With ``causal`` or a
    ``window`` it must hold those positions, as every self-attention
    caller passes them. Without either no mask depends on a position, so
    any ``segment_pos`` gives the same result: the encoder-decoder's
    cross-attention passes ``enc_len - 1`` for every query.
    """
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       segment_pos=segment_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: expected (B, S, H, D)")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    check_heads(q, h, hkv, d)
    dev = q.device
    # the kernels read q, k and v rows 16 bytes at a time
    check_input("q", q, ((b, sq, h, d),), dev, q.dtype, align=16)
    check_input("k", k, ((b, skv, hkv, d),), dev, q.dtype, align=16)
    check_input("v", v, ((b, skv, hkv, d),), dev, q.dtype, align=16)
    if sq < 1 or skv < 1 or window < 0:
        raise ValueError(f"flash_attention: Sq {sq}, Skv {skv}, window "
                         f"{window}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    from repro_torch.kernels._build import library
    lib = library("attention")
    rc = lib.lib.laimr_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODE[q.dtype], b, sq, skv, h, hkv, d, float(scale),
        int(bool(causal)), int(window), float(softcap), stream_ptr(dev))
    lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
