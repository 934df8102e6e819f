"""``routing_score``: a window of route_best decisions in one launch.

The paper's §IV-B hot path: for each request, evaluate the closed-form
latency law g_mi(lambda) over every candidate deployment, filter by SLO
and stability, and take the latency argmin with a cost tie-break. On the
card this is the hand-written CUDA kernel in ``csrc/routing.cu``
(``routing_score_kernel``: lanes per row fitted to I, each pair scored
once into a g cache); it replaces the TPU kernel
``src/repro/kernels/routing_score.py:routing_score``. :func:`row_plan`
lays out its launches and those of ``routing_topk_kernel`` and
``routing_attain_kernel``, which share its body.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for tensors on the CPU it runs the plain
version ``repro_torch.kernels.ref.routing_score_ref``. There is no
fallback from the card to the plain version.

``build_erlang_table`` is the host-side table builder both paths
consume: numpy over ``queueing.mmc_wait_np``, bit-identical to the
reference package's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.kernels import ref
from repro_torch.kernels._build import refuse_grad

#: threads per block of the three row kernels (routing_score_kernel,
#: routing_topk_kernel, routing_attain_kernel): rows of at most 32
#: candidates get lanes fitted to I in blocks of NARROW_THREADS; wider rows
#: a warp each, 16 to a block of WIDE_THREADS
NARROW_THREADS = 256
WIDE_THREADS = 512
#: candidates whose columns a block stages in shared memory at a time
TILE = 1024
#: column planes staged in shared memory by routing_score and routing_topk:
#: alpha, beta, gamma, max(n, 1), max(n mu, 1e-12), rtt and a shared (I,)
#: SLO row; routing_attain stages sigma and avail too
COLUMN_PLANES = 7
ATTAIN_PLANES = COLUMN_PLANES + 2
#: the row kernels' modes (routing.cu's Mode)
MODES = ("score", "topk", "attain")
#: dynamic shared memory a block of the card may opt in to
SMEM_MAX = 227 * 1024


class RowPlan(NamedTuple):
    """The layout of one launch of a row kernel."""
    lanes: int            # lanes deciding one request row
    group: int            # adjacent candidates a lane holds a group
    groups: int           # groups a lane scores and caches
    rows_per_block: int
    smem_bytes: int       # the staged columns (and attain's column lists),
    #                       then the cache unless it is in the scratch
    scratch: bool         # the g cache and flags are in device memory
    cache_floats: int = 1  # floats cached a column: g (attain: and p)

    @property
    def row_bytes(self) -> int:
        """A row's cache (``cache_floats`` floats a column) and flags (a
        byte a group and lane)."""
        return self.groups * self.lanes * (
            self.group * 4 * self.cache_floats + 1)


def _pow2_at_least(x: int) -> int:
    return 1 << (x - 1).bit_length()


@functools.cache
def row_plan(i: int, mode: str = "score") -> RowPlan:
    """The layout of a launch over I candidates of the row kernel of
    ``mode`` (one of MODES). A row of I <= 32 gets the power of two >= I
    lanes, a candidate each, in blocks of NARROW_THREADS; a wider row a
    warp whose lanes hold ceil(I / 128) groups of four adjacent
    candidates, 16 rows a block. Shared bytes: the column planes of a
    tile of up to TILE candidates (COLUMN_PLANES, attain ATTAIN_PLANES),
    for attain's wide rows a list of a group's columns a row (128
    ints), then the rows' cache (g, and for attain p) and flags, which go
    to a device scratch instead where they do not fit in SMEM_MAX (I >
    2944; attain I > 1408)."""
    if i < 1:
        raise ValueError(f"row_plan: I={i}")
    if mode not in MODES:
        raise ValueError(f"row_plan: mode {mode!r}")
    attain = mode == "attain"
    lanes = min(32, _pow2_at_least(i))
    group = 1 if i <= 32 else 4
    groups = -(-i // (lanes * group))
    threads = NARROW_THREADS if group == 1 else WIDE_THREADS
    rows = threads // lanes
    planes = ((ATTAIN_PLANES if attain else COLUMN_PLANES)
              * min(groups * lanes * group, TILE) * 4)
    if attain and group == 4:
        planes += rows * lanes * group * 4
    plan = RowPlan(lanes, group, groups, rows, planes, False,
                   2 if attain else 1)
    cache = rows * plan.row_bytes
    if planes + cache <= SMEM_MAX:
        return plan._replace(smem_bytes=planes + cache)
    return plan._replace(scratch=True)


_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """Device bytes for the g cache of rows too long for shared memory,
    kept per device and stream and grown by size. A launch writes every
    entry it reads, so nothing is zeroed; launches on one stream run in
    order."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8,
                                          device=dev)
    return buf


def plan_args(r: int, i: int, dev: torch.device,
              mode: str = "score") -> tuple:
    """The plan arguments of ``laimr_routing_score`` /
    ``laimr_routing_topk`` / ``laimr_routing_attain`` (``mode`` "score",
    "topk" or "attain"): lanes, rows per block, shared bytes, and the
    scratch (None unless the plan puts the cache there)."""
    p = row_plan(i, mode)
    if not p.scratch:
        return p.lanes, p.rows_per_block, p.smem_bytes, None
    # a slot per resident row: at most one per row of every row group
    rows = -(-r // p.rows_per_block) * p.rows_per_block
    buf = _scratch(dev, stream_ptr(dev), rows * p.row_bytes)
    return p.lanes, p.rows_per_block, p.smem_bytes, buf.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_input(name: str, x: torch.Tensor, shapes: tuple,
                   device: torch.device, dtype=torch.float32,
                   align: int = 0) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on ``device``
    whose shape is one of ``shapes`` (and, given ``align``, whose data
    starts on an ``align``-byte boundary)."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) not in shapes:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected one "
                         f"of {shapes}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align and x.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def row_strides(x: torch.Tensor) -> tuple[int, int]:
    """(row stride, column stride) of an (R,) shared or (R, I) row input."""
    return (1, 0) if x.ndim == 1 else (x.shape[1], 1)


def routing_score(lam: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                  n: torch.Tensor, rtt: torch.Tensor, slo: torch.Tensor,
                  cost: torch.Tensor, erlang_c_table: torch.Tensor):
    """Fused score + select for R requests over I candidates.

    lam: (R,) shared rates or (R, I) per-candidate rates; alpha, beta,
    gamma, mu, n, rtt, cost: (I,); slo: (I,) shared budgets or (R, I)
    rows with -1 as a lane exclusion; erlang_c_table: (I, T). All
    float32. Returns (idx (R,) int32, g at idx (R,) float32, feasible
    (R,) bool); a row with nothing feasible reports idx 0.
    """
    refuse_grad("routing_score", lam, alpha, beta, gamma, mu, n, rtt, slo,
                cost, erlang_c_table)
    if lam.device.type == "cpu":
        return ref.routing_score_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                     slo, cost, erlang_c_table)
    if lam.device.type != "cuda":
        raise ValueError(f"routing_score: no kernel for {lam.device}")
    dev = lam.device
    r = lam.shape[0]
    i, t = erlang_c_table.shape
    check_input("lam", lam, ((r,), (r, i)), dev)
    for name, col in (("alpha", alpha), ("beta", beta), ("gamma", gamma),
                      ("mu", mu), ("n", n), ("rtt", rtt), ("cost", cost)):
        check_input(name, col, ((i,),), dev)
    check_input("slo", slo, ((i,), (r, i)), dev)
    check_input("erlang_c_table", erlang_c_table, ((i, t),), dev)
    if i < 1 or t < 2:
        raise ValueError(f"routing_score: table shape {(i, t)}")
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    g = torch.empty(r, dtype=torch.float32, device=dev)
    ok = torch.empty(r, dtype=torch.uint8, device=dev)
    from repro_torch.kernels._build import library
    lib = library()
    lam_rs, lam_cs = row_strides(lam)
    rc = lib.lib.laimr_routing_score(
        lam.data_ptr(), lam_rs, lam_cs, alpha.data_ptr(), beta.data_ptr(),
        gamma.data_ptr(), mu.data_ptr(), n.data_ptr(), rtt.data_ptr(),
        slo.data_ptr(), 0 if slo.ndim == 1 else i, cost.data_ptr(),
        erlang_c_table.data_ptr(), r, i, t, *plan_args(r, i, dev),
        idx.data_ptr(), g.data_ptr(), ok.data_ptr(), stream_ptr(dev))
    lib.check(rc, "routing_score")
    routing_score.launches += 1
    return idx, g, ok.view(torch.bool)


routing_score.launches = 0


def build_erlang_table(mu, n, t: int = 65) -> np.ndarray:
    """Per-deployment M/M/c wait over rho = linspace(0, 1, t) — the
    'in-memory table pre-computed by the analytic model' (§IV-B).
    Returns an (I, t) float32 numpy array (waits capped at 1e6)."""
    mu = np.asarray(mu, np.float64)
    n = np.asarray(n, np.int64)
    rho = np.linspace(0.0, 1.0, t)
    out = np.zeros((len(mu), t), np.float32)
    for ii in range(len(mu)):
        lam = rho * n[ii] * mu[ii]
        for jj in range(t):
            w = queueing.mmc_wait_np(float(lam[jj]), np.array([n[ii]]),
                                     float(mu[ii]))[0]
            out[ii, jj] = min(float(w), 1e6) if np.isfinite(w) else 1e6
    return out
