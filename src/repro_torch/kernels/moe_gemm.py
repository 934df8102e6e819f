"""``moe_gemm``: the grouped expert GEMM of a dropless mixture of experts.

Every routed (token, expert) row of one MoE layer times its expert's
weight matrix, in one launch: ``out[r] = act(a[rows[r]] @ w[e(r)])``,
the rows sorted by expert (``layers.sort_by_expert``), ``counts[e]`` of
them for expert e. On the card this is the hand-written CUDA kernel
``moe_gemm_kernel`` in ``csrc/moe.cu``: bfloat16 inputs take its
tensor-core body (wgmma fed by TMA), float32 its CUDA-core body. It
replaces no TPU kernel: the reference's mixture
(``repro.models.layers.moe``) runs batched einsums over every expert's
capacity rows, and Nemotron-H's dropless router has no counterpart there.
It was added because a decode step of NVIDIA-Nemotron-3-Nano routes 32
rows to 6 of 128 experts each, touching about 100 experts: the work is
reading the touched experts' weights (2 x 10 MB each a layer), and a
batched GEMM over all 128 experts reads every one, while a loop over the
touched ones needs their count on the host, which no CUDA graph allows.

The grid is static: ``plan`` cuts each expert's rows into tiles of
``BLOCK_M`` rows on the device (a cumulative sum of tiles per expert and
a ``searchsorted`` of the tile index into it, no sync), at most
``ceil(P / BLOCK_M) + E`` tiles for P rows; a block takes one tile and a
block of output columns, and a tile past the plan's count returns at
once. ``csrc/moe.cu`` says what bounds the kernel and what its design
does about it.

The wrapper launches the kernel for CUDA tensors and raises on anything
it does not take; for tensors on the CPU it runs the plain version
``repro_torch.kernels.ref.moe_gemm_ref``. There is no fallback from the
card to the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.flash_attention import DTYPE_CODE
from repro_torch.kernels.routing_score import stream_ptr

ACTS = {"none": 0, "relu2": 1}
#: sorted rows a tile (the kernel's; wgmma's 64 rows)
BLOCK_M = 64
#: above this many routed rows a bf16 launch takes 128 output columns a
#: block (each gathered row reused over two weight boxes), else 64
DECODE_ROWS = 1024


@dataclasses.dataclass
class Plan:
    """One MoE layer's rows cut into tiles, on the device: ``counts``
    rows per expert (E,) and their ``ends`` (cumulative, E,), each
    tile's expert and first sorted row (``max_tiles``,), the number of
    tiles in use (1,), all int32."""

    counts: torch.Tensor
    ends: torch.Tensor
    tile_expert: torch.Tensor
    tile_row0: torch.Tensor
    n_tiles: torch.Tensor
    rows: int
    block_m: int

    @property
    def max_tiles(self) -> int:
        return self.tile_expert.numel()


def plan(counts: torch.Tensor, rows: int) -> Plan:
    """The tiles of ``rows`` rows sorted by expert, ``counts`` (E,) int32
    of them per expert: expert e has ``ceil(counts[e] / BLOCK_M)`` tiles,
    in expert order; tile m's expert is the first whose cumulative tile
    count exceeds m. Device ops of static shapes only."""
    block_m = BLOCK_M
    e = counts.numel()
    dev = counts.device
    tiles = (counts + (block_m - 1)) // block_m
    cum = torch.cumsum(tiles, dim=0, dtype=torch.int32)
    max_tiles = -(-rows // block_m) + e
    m = torch.arange(max_tiles, dtype=torch.int32, device=dev)
    tile_expert = torch.searchsorted(cum, m, right=True, out_int32=True) \
        .clamp_max_(e - 1)
    ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
    first = (cum - tiles).gather(0, tile_expert.long())
    tile_row0 = (ends - counts).gather(0, tile_expert.long()) \
        + (m - first) * block_m
    return Plan(counts=counts, ends=ends, tile_expert=tile_expert,
                tile_row0=tile_row0, n_tiles=cum[-1:], rows=rows,
                block_m=block_m)


def moe_gemm(a: torch.Tensor, rows: Optional[torch.Tensor],
             w: torch.Tensor, pl: Plan, act: str = "none",
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: (T, K) float32 or bfloat16, contiguous; rows: (P,) int64, the
    row of ``a`` that each sorted row reads, or None (sorted row r is
    ``a[r]``, P = T); w: (E, K, N) of a's dtype, contiguous; ``pl``:
    ``plan(counts, P)``. K and N are multiples of 8. Returns (P, N) in
    ``out_dtype`` (default a's dtype; float32, or bfloat16 for bfloat16
    a): row r is act(a[rows[r]] @ w[e]) for the expert e whose sorted
    rows hold r."""
    refuse_grad("moe_gemm", a, w)
    if act not in ACTS:
        raise ValueError(f"moe_gemm: act {act!r}, not one of {list(ACTS)}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.moe_gemm_ref(a, rows, w, pl.counts, act, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for {a.device}")
    if a.dtype not in DTYPE_CODE or w.dtype != a.dtype \
            or out_dtype not in (torch.float32, a.dtype):
        raise TypeError(f"moe_gemm: a {a.dtype}, w {w.dtype}, out "
                        f"{out_dtype}: a and w both float32 or both "
                        "bfloat16, out float32 or a's")
    if a.ndim != 2 or w.ndim != 3 or w.shape[1] != a.shape[1]:
        raise ValueError(f"moe_gemm: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}: expected (T, K), (E, K, N)")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm: a and w must be contiguous")
    k, n = w.shape[1], w.shape[2]
    if k % 8 or n % 8 or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"moe_gemm: K {k} and N {n} must be multiples of "
                         "8, a and w 16-byte aligned")
    p = a.shape[0] if rows is None else rows.numel()
    if p != pl.rows or pl.counts.numel() != w.shape[0]:
        raise ValueError(f"moe_gemm: {p} rows, {w.shape[0]} experts; the "
                         f"plan is of {pl.rows} rows and "
                         f"{pl.counts.numel()} experts")
    if pl.block_m != BLOCK_M:
        raise ValueError(f"moe_gemm: the plan's tiles are of {pl.block_m} "
                         f"rows, the kernel's of {BLOCK_M}")
    if rows is not None and (rows.dtype != torch.int64
                             or rows.device != a.device
                             or not rows.is_contiguous()):
        raise ValueError("moe_gemm: rows must be contiguous int64 on a's "
                         "device")
    for name, x in (("tile_expert", pl.tile_expert),
                    ("tile_row0", pl.tile_row0), ("ends", pl.ends),
                    ("n_tiles", pl.n_tiles)):
        if x.dtype != torch.int32 or x.device != a.device \
                or not x.is_contiguous():
            raise ValueError(f"moe_gemm: the plan's {name} must be "
                             "contiguous int32 on a's device")
    out = torch.empty((p, n), dtype=out_dtype, device=a.device)
    from repro_torch.kernels._build import library
    lib = library("moe")
    rc = lib.lib.laimr_moe_gemm(
        a.data_ptr(), None if rows is None else rows.data_ptr(),
        w.data_ptr(), out.data_ptr(), pl.tile_expert.data_ptr(),
        pl.tile_row0.data_ptr(), pl.ends.data_ptr(), pl.n_tiles.data_ptr(),
        DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], ACTS[act], w.shape[0],
        k, n, pl.max_tiles, int(p > DECODE_ROWS), stream_ptr(a.device))
    lib.check(rc, "moe_gemm")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
