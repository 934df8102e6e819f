#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LA-IMR (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, and
without ``src/repro_torch`` beside this file. Every phase that fails
raises, and the script then exits non-zero and prints no result line.
Each phase prints one JSON object per line:

0. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
1. the kernel build: one ``nvcc`` per source (``kernels/csrc/routing.cu``,
   ``kernels/csrc/attention.cu``, ``kernels/csrc/ssd.cu``), all started
   together, with their ptxas register and spill lines;
2. each routing kernel (``routing_score``, ``routing_guard``,
   ``routing_topk``, ``routing_attain``) against its plain PyTorch
   version on the card: the reference package's kernel sweeps and edge
   cases, per-request SLO rows with lane exclusions, the guard's
   boundary cases, full windows at the main path's shapes, and one
   fleet-scale shape whose Erlang table exceeds a block's shared
   memory. ``ok`` and ``offloaded`` must match exactly, ``idx`` exactly
   on feasible rows, g within ``rtol=1e-4`` (the reference's own
   kernel-vs-oracle bound);
3. serving: ``BatchRouter`` answering 2048 requests in windows of 256
   on two clusters, all five policies, ``backend="cuda"``, with
   conservation;
4. the simulator's pinned windowed golden digests, ``admission_backend=
   "cuda"``;
5. a flash-crowd stream through the simulator, all five policies,
   against the reference package's digests of the same stream;
6. the digests again through the default ``vmap`` backend, and a
   ``torch.profiler`` breakdown of one serving run per single-kernel
   policy (device time by kernel against the host's wall time);
7. both attention kernels (``flash_attention``, ``decode_attention``)
   against their plain versions: the reference's sweeps in float32 and
   bfloat16, head_dim 80, a 200-token sequence and an all-invalid decode
   row within ``2e-5`` (float32) and ``5e-2`` (bfloat16), the
   reference's own bounds; the model's shapes within ``2e-5`` in float32
   and ``MODEL_BF16_TOL`` in bfloat16;
8. StableLM-3B at full width in float32 (weights from generator seed
   0): prefill of 8 x 512 prompts and 16 decode steps with
   ``kernels="cuda"`` against ``kernels="ref"`` on the latter's tokens,
   every step's logits within ``LOGIT_BOUND`` x max |logit|; then
   ``ServingEngine.generate`` under both, greedy tokens equal except at
   a near-tie of the plain run (top-2 gap within twice that bound);
9. serving at full width in bf16: ``ServingEngine(slots=8,
   max_len=2048)`` with ``b == slots`` (8 x 512 prompts, 64 steps) and
   ``b < slots`` (4 prompts); exactly n_layers ``flash_attention``
   launches per prefill and n_layers ``decode_attention`` launches per
   decode step, prefill ms, decode ms per step, tokens/s delivered to
   the live requests, and a ``torch.profiler`` breakdown of one prefill
   and one decode step;
10. the attention kernels' times (CUDA events, medians of 100 launches)
   at the model's shapes, against their plain versions and
   ``scaled_dot_product_attention``;
11. ``ssd_scan`` against its plain version, y and the final state: the
   CPU tests' cases (the reference's sweep, groups 2 and 4, L = 1, 100
   and 200, initial states, a long-memory case) within ``5e-4`` in
   float32 (the reference's own bound) and ``MODEL_BF16_TOL`` in bf16,
   the served prefill shape (B 8, L 2048, 32 heads of 64, N 128) and one
   long prompt (B 1, L 32768) in both;
12. Mamba2-370m at full width in float32, as phase 8 (8 x 512 prompts,
   16 decode steps);
13. serving Mamba2-370m in bf16 as phase 9, with 8 x 2048 prompts:
   exactly 48 ``ssd_scan`` launches per prefill and none per decode step;
14. ``ssd_scan`` times at the served shape (100 launches) and the long
   prompt (20 launches) against its plain version (the mean wall time
   of ``PLAIN_RUNS`` runs: a Python loop over L) and its bound; then the
   routing kernels' times at the main path's shapes and at fleet scale.

Launch counters are set to 0 just before each policy's run in phases
3-5, each ``generate`` of phases 9 and 13 and one more decode step after
it, and read just after; a kernel that the path runs and that did not
launch exactly as often as it should fails the run (``hybrid`` must
launch both of its constituents' kernels on the flash stream). The line
before the last is the kernel table, the last line the device.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12         # non-tensor float32, SXM data sheet
G_RTOL = 1e-4                  # the reference's kernel-vs-oracle g bound
TABLE_T = 65                   # AdmissionConfig.erlang_table_size
FLOPS_PER_PAIR = 30            # f32 ops to score one (request, candidate)
# routing_topk adds the headroom gate (a subtract and a compare) to the
# score; routing_attain adds the attainment probability: two logf (~10
# ops each), one erff (~15), the z arithmetic and the avail product (~5)
TOPK_FLOPS_PER_PAIR = FLOPS_PER_PAIR + 2
ATTAIN_FLOPS_PER_PAIR = FLOPS_PER_PAIR + 40
TOPK_K = 2                     # AdmissionConfig.redundancy default
ATTAIN_MARGIN = 0.25           # AdmissionConfig.headroom_margin default

# GOLDEN_WINDOWED of the reference package's tests/test_control_plane.py:
# (trace, window, policy) -> (n, p50, p99, offload_fast)
GOLDEN_WINDOWED = {
    ("ramp", 0.1, "route_best"): (
        599, 0.3925731684935556, 1.0927808101906693, 78),
    ("ramp", 0.25, "route_best"): (
        599, 0.5300085553864164, 0.9411840016349101, 50),
    ("burst", 0.1, "route_best"): (
        626, 0.795859417435981, 3.526403180628132, 340),
    ("burst", 0.25, "route_best"): (
        626, 0.8333629397886924, 3.0015792708347693, 324),
    ("ramp", 0.1, "guarded_alg1"): (
        599, 0.6568781334853782, 1.3594035287551731, 300),
    ("burst", 0.1, "guarded_alg1"): (
        626, 1.0061975537910977, 3.5180977031426215, 399),
    ("ramp", 0.1, "safetail"): (
        599, 0.3878116168755241, 1.0596894136743895, 78),
    ("burst", 0.1, "safetail"): (
        626, 0.7315342838806309, 3.470679008271632, 340),
    ("ramp", 0.1, "reliable"): (
        599, 0.3925731684935556, 1.0927808101906693, 78),
    ("burst", 0.1, "reliable"): (
        626, 0.795859417435981, 3.526403180628132, 340),
}
# the reference package's run of the flash-crowd stream (phase 5):
# policy -> (n, p50, p99, offload_fast, hybrid switches)
STREAM_GOLDEN = {
    "route_best": (271, 9.665503173736184, 19.076171451721844, 210, None),
    "guarded_alg1": (271, 4.089996307045176, 16.973597590998185, 187, None),
    "safetail": (271, 9.645472497939949, 19.030009152777332, 212, None),
    "reliable": (271, 9.665503173736184, 19.076171451721844, 210, None),
    "hybrid": (271, 2.590345378773815, 14.154131343188576, 173, 2),
}
# cells the CPU tests mark xfail(strict=True) for a documented libm
# decision flip (ROADMAP queue 3) -> reason; none so far
DIGEST_SKIPS: dict = {}

POLICIES = ("route_best", "guarded_alg1", "safetail", "reliable", "hybrid")
# the kernels each policy decides through under backend="cuda"; hybrid
# launches routing_topk only while its burst detector is on
POLICY_KERNELS = {
    "route_best": ("routing_score",), "guarded_alg1": ("routing_guard",),
    "safetail": ("routing_topk",), "reliable": ("routing_attain",),
    "hybrid": ("routing_guard",),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- inputs --
def candidate_columns(rng, i: int) -> dict:
    """The reference kernel tests' seeded candidate table."""
    return dict(
        alpha=rng.uniform(0.1, 1.0, i).astype(np.float32),
        beta=rng.uniform(0.1, 2.0, i).astype(np.float32),
        gamma=rng.uniform(0.9, 1.8, i).astype(np.float32),
        mu=rng.uniform(0.5, 3.0, i).astype(np.float32),
        n=rng.integers(1, 8, i).astype(np.float32),
        rtt=rng.uniform(0, 0.1, i).astype(np.float32),
    )


def to_dev(arrs: dict, dev) -> dict:
    import torch
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in arrs.items()}


def score_case(i: int, r: int, seed: int, *, slo_rows: bool = False,
               lam_rows: bool = False) -> dict:
    """Inputs of ``routing_score``: the reference's ``_setup`` draws
    (seed i), optionally with (R, I) SLO rows carrying 20% lane
    exclusions and (R, I) per-candidate rates."""
    from repro_torch.kernels.routing_score import build_erlang_table
    rng = np.random.default_rng(seed)
    cols = candidate_columns(rng, i)
    cols["slo"] = rng.uniform(1.0, 4.0, i).astype(np.float32)
    cols["cost"] = rng.uniform(1, 3, i).astype(np.float32)
    lam = rng.uniform(0.0, 10.0, (r, i) if lam_rows else r)
    cols["lam"] = lam.astype(np.float32)
    if slo_rows:
        rng2 = np.random.default_rng(seed)
        rows = rng2.uniform(0.5, 4.0, (r, i)).astype(np.float32)
        rows[rng2.uniform(size=(r, i)) < 0.2] = -1.0
        cols["slo"] = rows
    cols["table"] = build_erlang_table(cols["mu"], cols["n"], t=TABLE_T)
    return cols


def guard_case(i: int, r: int, seed: int, *, lam_rows: bool = False) -> dict:
    """Inputs of ``routing_guard``: the reference's ``_routing_setup``
    draws (seed 20 + i) plus tau/home/up columns."""
    from repro_torch.kernels.routing_score import build_erlang_table
    rng = np.random.default_rng(seed)
    cols = candidate_columns(rng, i)
    lam = rng.uniform(0.0, 10.0, (r, i) if lam_rows else r)
    cols["lam"] = lam.astype(np.float32)
    cols["table"] = build_erlang_table(cols["mu"], cols["n"], t=TABLE_T)
    cols["tau"] = rng.uniform(0.1, 3.0, r).astype(np.float32)
    cols["home"] = rng.integers(0, i, r).astype(np.int32)
    cols["up"] = rng.integers(-1, i, r).astype(np.int32)
    return cols


def topk_case(op: str, i: int, r: int, seed: int, *, slo_rows: bool = False,
              lam_rows: bool = False) -> dict:
    """Inputs of ``routing_topk`` (op "topk": the reference's
    ``TestRoutingTopK`` draws, slo then cost) or ``routing_attain`` (op
    "attain": ``TestRoutingAttain``, slo, sigma, avail), optionally with
    (R, I) SLO rows carrying 20% lane exclusions and (R, I) rates."""
    from repro_torch.kernels.routing_score import build_erlang_table
    rng = np.random.default_rng(seed)
    cols = candidate_columns(rng, i)
    cols["lam"] = rng.uniform(0.0, 10.0, r).astype(np.float32)
    cols["table"] = build_erlang_table(cols["mu"], cols["n"], t=TABLE_T)
    cols["slo"] = rng.uniform(1.0, 4.0, i).astype(np.float32)
    if op == "topk":
        cols["cost"] = rng.uniform(1, 3, i).astype(np.float32)
    else:
        cols["sigma"] = rng.uniform(0.05, 0.8, i).astype(np.float32)
        cols["avail"] = rng.uniform(0.7, 1.0, i).astype(np.float32)
    if slo_rows:
        rows = rng.uniform(0.5, 4.0, (r, i)).astype(np.float32)
        rows[rng.uniform(size=(r, i)) < 0.2] = -1.0
        cols["slo"] = rows
    if lam_rows:
        cols["lam"] = rng.uniform(0.0, 10.0, (r, i)).astype(np.float32)
    return cols


def topk_edge_cases() -> list:
    """The reference's pinned top-k / attainment edge cases, as
    (label, op, inputs, k, margin): all rows infeasible, k above the
    feasible count, bit-identical clones (cost tie-break, then duplicates
    by index), sigma = 0 as a step, uniform sigma degrading to argmin g."""
    from repro_torch.kernels.routing_score import build_erlang_table
    out = []
    c = topk_case("topk", 4, 32, seed=9)
    c["slo"] = np.full(4, 1e-6, np.float32)
    out.append(("all_infeasible", "topk", c, 3, 0.0))
    c = topk_case("topk", 5, 32, seed=13)
    rows = np.full((32, 5), -1.0, np.float32)
    rows[:, 1] = rows[:, 3] = 100.0
    c["slo"] = rows
    out.append(("k_exceeds_feasible", "topk", c, 5, 0.0))
    one = lambda v: np.full(4, v, np.float32)
    clones = dict(alpha=one(0.2), beta=one(0.3), gamma=one(1.2), mu=one(2.0),
                  n=one(2.0), rtt=one(0.01), slo=one(5.0),
                  lam=np.linspace(0.0, 3.0, 32).astype(np.float32))
    clones["table"] = build_erlang_table(clones["mu"], clones["n"], t=TABLE_T)
    out.append(("clones", "topk",
                dict(clones, cost=np.asarray([2, 1, 1, 2], np.float32)),
                4, 0.0))
    out.append(("clones", "attain",
                dict(clones, sigma=one(0.3), avail=one(1.0)), 4, 0.0))
    c = topk_case("attain", 4, 64, seed=91)
    c.update(sigma=np.zeros(4, np.float32),
             avail=np.asarray([0.9, 0.99, 0.99, 0.7], np.float32))
    out.append(("sigma_zero", "attain", c, 2, 0.0))
    c = topk_case("attain", 5, 64, seed=88)
    c.update(slo=np.full(5, 3.0, np.float32),
             sigma=np.full(5, 0.3, np.float32), avail=np.ones(5, np.float32))
    out.append(("uniform", "attain", c, 2, 0.0))
    c = topk_case("attain", 3, 32, seed=17)
    c.update(slo=np.full(3, 1e-6, np.float32),
             sigma=np.full(3, 0.2, np.float32), avail=np.ones(3, np.float32))
    out.append(("all_infeasible", "attain", c, 2, 0.0))
    return out


SCORE_ARGS = ("lam", "alpha", "beta", "gamma", "mu", "n", "rtt", "slo",
              "cost", "table")
GUARD_ARGS = ("lam", "alpha", "beta", "gamma", "mu", "n", "rtt", "tau",
              "home", "up", "table")
TOPK_ARGS = {"topk": SCORE_ARGS,
             "attain": ("lam", "alpha", "beta", "gamma", "mu", "n", "rtt",
                        "slo", "sigma", "avail", "table")}


def fragile_rows(op: str, case: dict, dev, k: int,
                 margin: float) -> np.ndarray:
    """Rows whose decision two float32 evaluations of g ~1e-6 apart
    could decide differently: a candidate within 1e-5 (relative) of the
    SLO cut or of the headroom gate, two of the k + 1 lowest feasible g
    within 1e-5 of each other (the duplicate order), and for
    ``routing_topk`` (and ``routing_score``, its k = 1 case) a feasible
    candidate other than the g minimum at the near-band edge. At fleet
    scale (a thousand candidates a row) such near-ties occur by chance;
    the fleet cases redraw those rows' rates. For
    ``routing_attain``: a feasible candidate other than the argmax whose
    attainment probability p lies within reach of the band edge ``pmax -
    1e-6``, where a 1e-6 relative shift of g moves p by
    ``avail * exp(-z^2) / sqrt(pi) * 1e-6 / (sigma * sqrt2)`` (the
    derivative of Phi) and ``erff`` and ``torch.erf`` differ by a few
    ulp (1e-7). Such rows test the last bits of exp/log/erf, not the
    kernel."""
    import torch

    from repro_torch.kernels.ref import _table_scores
    t = to_dev({k_: case[k_] for k_ in TOPK_ARGS[op]}, dev)
    g, rho = _table_scores(t["lam"], t["alpha"], t["beta"], t["gamma"],
                           t["mu"], t["n"], t["rtt"], t["table"])
    slo = t["slo"] if t["slo"].ndim == 2 else t["slo"][None, :]
    feas = (rho < 1.0) & (g <= slo)
    big = torch.full_like(g, 1e30)
    gate = slo - margin
    tight = ((g - slo).abs() <= 1e-5 * slo.abs()) \
        | ((g - gate).abs() <= 1e-5 * gate.abs())
    low = torch.sort(torch.where(feas, g, big), dim=1).values[:, :k + 1]
    close = (low[:, 1:] - low[:, :-1]) <= 1e-5 * low[:, 1:].abs()
    bad = tight.any(dim=1) | (close & (low[:, 1:] < 1e29)).any(dim=1)
    cols = torch.arange(g.shape[1], device=g.device)[None, :]
    if op == "topk":
        g_feas = torch.where(feas, g, big)
        edge = g_feas.amin(1, True) * (1.0 + 1e-5) + 1e-9
        others = cols != g_feas.argmin(dim=1, keepdim=True)
        bad |= (feas & others & ((g - edge).abs() <= 1e-5 * edge)).any(dim=1)
    else:
        sig = t["sigma"][None, :]
        avail = t["avail"][None, :]
        z = ((torch.log(slo.clamp_min(1e-20)) - torch.log(g.clamp_min(1e-20))
              ) / (sig.clamp_min(1e-20) * 1.4142135623730951)).clamp(-10, 10)
        p = avail * torch.where(sig > 0, 0.5 * (1 + torch.erf(z)),
                                (g <= slo).float())
        dp = torch.where(sig > 0, avail * torch.exp(-z * z) / 1.7724538509
                         * 1e-6 / (sig.clamp_min(1e-20) * 1.4142135623730951),
                         torch.zeros_like(p))
        p = torch.where(feas, p, torch.full_like(p, -1.0))
        top = p.argmax(dim=1, keepdim=True)
        edge = torch.gather(p, 1, top) - 1e-6
        reach = dp + torch.gather(dp, 1, top) + 1e-7
        bad |= (feas & (cols != top) & ((p - edge).abs() <= reach)).any(dim=1)
    return bad.cpu().numpy()


def fleet_topk_case(op: str, dev, r: int = 4096, i: int = 1024):
    """The fleet-scale case of ``routing_topk`` / ``routing_attain`` at
    the defaults k = 2 (margin 0 for topk, 0.25 for attain), with
    fragile rows redrawn. Returns (case, k, margin, rows redrawn)."""
    k, margin = TOPK_K, (0.0 if op == "topk" else ATTAIN_MARGIN)
    case = topk_case(op, i, r, seed=4096 + (op == "attain"), slo_rows=True,
                     lam_rows=True)
    rng = np.random.default_rng(4098)
    redrawn = 0
    for _ in range(50):
        bad = fragile_rows(op, case, dev, k, margin)
        if not bad.any():
            return case, k, margin, redrawn
        redrawn += int(bad.sum())
        case["lam"][bad] = rng.uniform(0.0, 10.0, (int(bad.sum()), i))
    fail(f"could not draw a fleet {op} case free of near-ties")


def fleet_score_case(dev, r: int = 4096, i: int = 1024) -> dict:
    case = score_case(i, r, seed=4096, slo_rows=True, lam_rows=True)
    rng = np.random.default_rng(4097)
    for _ in range(50):
        bad = fragile_rows("topk", case, dev, 1, 0.0)
        if not bad.any():
            return case
        case["lam"][bad] = rng.uniform(0.0, 10.0, (int(bad.sum()), i))
    fail("could not draw a fleet case free of near-ties")


# ----------------------------------------------------------- phase 2 -----
def compare_score(name: str, case: dict, dev) -> float:
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_score import routing_score
    t = to_dev({k: case[k] for k in SCORE_ARGS}, dev)
    args = [t[k] for k in SCORE_ARGS]
    ki, kg, kok = (x.cpu().numpy() for x in routing_score(*args))
    ri, rg, rok = (x.cpu().numpy() for x in ref.routing_score_ref(*args))
    if not np.array_equal(kok, rok):
        fail(f"routing_score {name}: ok differs on "
             f"{int((kok != rok).sum())} rows")
    feas = rok
    bad = np.flatnonzero(ki[feas] != ri[feas])
    if bad.size:
        fail(f"routing_score {name}: idx differs on {bad.size} feasible "
             f"rows (first {np.flatnonzero(feas)[bad[:3]].tolist()})")
    err = np.abs(kg[feas].astype(np.float64) - rg[feas])
    if feas.any() and not np.all(err <= G_RTOL * np.abs(rg[feas])):
        fail(f"routing_score {name}: g beyond rtol {G_RTOL}")
    max_abs = float(err.max()) if err.size else 0.0
    emit({"phase": "parity", "kernel": "routing_score", "case": name,
          "rows": int(len(ki)), "feasible_rows": int(feas.sum()),
          "max_abs_err": max_abs})
    return max_abs


def compare_guard(name: str, case: dict, dev, want_off=None) -> float:
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_decide import routing_guard
    t = to_dev({k: case[k] for k in GUARD_ARGS}, dev)
    args = [t[k] for k in GUARD_ARGS]
    ki, kg, koff = (x.cpu().numpy() for x in routing_guard(*args))
    ri, rg, roff = (x.cpu().numpy() for x in ref.routing_guard_ref(*args))
    if not np.array_equal(koff, roff):
        fail(f"routing_guard {name}: offloaded differs on "
             f"{int((koff != roff).sum())} rows")
    if want_off is not None and not np.array_equal(koff, want_off):
        fail(f"routing_guard {name}: offloaded {koff} != pinned {want_off}")
    if not np.array_equal(ki, ri):
        fail(f"routing_guard {name}: idx differs on "
             f"{int((ki != ri).sum())} rows")
    err = np.abs(kg.astype(np.float64) - rg)
    if not np.all(err <= G_RTOL * np.abs(rg)):
        fail(f"routing_guard {name}: g beyond rtol {G_RTOL}")
    emit({"phase": "parity", "kernel": "routing_guard", "case": name,
          "rows": int(len(ki)), "offloaded_rows": int(koff.sum()),
          "max_abs_err": float(err.max())})
    return float(err.max())


def compare_topk(op: str, name: str, case: dict, dev, k: int,
                 margin: float, redrawn: int = 0) -> float:
    """``routing_topk`` / ``routing_attain`` against the plain version:
    ``ok`` exact, every idx column exact on feasible rows and -1 on
    infeasible ones, g within ``G_RTOL``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_decide import routing_attain, \
        routing_topk
    kern, plain = ((routing_topk, ref.routing_topk_ref) if op == "topk"
                   else (routing_attain, ref.routing_attain_ref))
    t = to_dev({k_: case[k_] for k_ in TOPK_ARGS[op]}, dev)
    args = [t[k_] for k_ in TOPK_ARGS[op]]
    ki, kg, kok = (x.cpu().numpy() for x in kern(*args, k=k, margin=margin))
    ri, rg, rok = (x.cpu().numpy() for x in plain(*args, k=k, margin=margin))
    what = f"{kern.__name__} {name}"
    if not np.array_equal(kok, rok):
        fail(f"{what}: ok differs on {int((kok != rok).sum())} rows")
    bad = np.flatnonzero((ki != ri).any(axis=1))
    if bad.size:
        fail(f"{what}: idx differs on {bad.size} rows (first "
             f"{bad[:3].tolist()}: {ki[bad[:3]].tolist()} vs "
             f"{ri[bad[:3]].tolist()})")
    err = np.abs(kg.astype(np.float64) - rg)
    if not np.all(err <= G_RTOL * np.abs(rg)):
        fail(f"{what}: g beyond rtol {G_RTOL}")
    emit({"phase": "parity", "kernel": kern.__name__, "case": name,
          "rows": int(len(ki)), "k": k, "margin": margin,
          "feasible_rows": int(rok.sum()),
          "duplicates": int((ki[:, 1:] >= 0).sum()),
          "fragile_rows_redrawn": redrawn, "max_abs_err": float(err.max())})
    return float(err.max())


def guard_boundary_cases() -> list:
    """The reference's pinned guard edges: tau == g_inst must not
    offload (strict >), one f32 ulp below must; up = -1 never offloads;
    an unstable home carries the 1e9 sentinel with no RTT stripped."""
    from repro_torch.kernels.routing_score import build_erlang_table
    i, r = 3, 8
    base = guard_case(i, r, seed=5)
    base["lam"] = np.zeros(r, np.float32)
    base["home"] = (np.arange(r) % i).astype(np.int32)
    base["up"] = ((np.arange(r) + 1) % i).astype(np.int32)
    h = base["home"]
    g_inst = base["alpha"][h] + base["rtt"][h] - base["rtt"][h]
    out = []
    for label, tau, want in (
            ("tau_equal", g_inst, False),
            ("tau_one_ulp_below", np.nextafter(g_inst, np.float32(-1)),
             True)):
        out.append((label, dict(base, tau=tau.astype(np.float32)),
                    np.full(r, want)))
    top = dict(
        alpha=np.array([0.1, 0.1], np.float32),
        beta=np.array([0.1, 0.1], np.float32),
        gamma=np.array([1.0, 1.0], np.float32),
        mu=np.array([0.01, 100.0], np.float32),
        n=np.array([1.0, 1.0], np.float32),
        rtt=np.array([0.01, 0.02], np.float32),
        lam=np.full(r, 5.0, np.float32),
        home=np.zeros(r, np.int32),
        up=np.array([1, -1] * (r // 2), np.int32),
        tau=np.array([0.5, 0.5, 1e9, 1e9] * (r // 4), np.float32))
    top["table"] = build_erlang_table(top["mu"], top["n"], t=TABLE_T)
    out.append(("top_tier_unstable", top,
                np.array([True, False, False, False] * (r // 4))))
    return out


def phase_parity(dev) -> dict:
    errs = {"routing_score": 0.0, "routing_guard": 0.0, "routing_topk": 0.0,
            "routing_attain": 0.0}

    def score(name, case):
        errs["routing_score"] = max(errs["routing_score"],
                                    compare_score(name, case, dev))

    def guard(name, case, want=None):
        errs["routing_guard"] = max(errs["routing_guard"],
                                    compare_guard(name, case, dev, want))

    for i, r in ((2, 64), (6, 256), (11, 128)):
        score(f"sweep_i{i}_r{r}", score_case(i, r, seed=i))
        guard(f"sweep_i{i}_r{r}", guard_case(i, r, seed=20 + i))
    for i, r in ((3, 64), (6, 128)):
        score(f"slo_rows_i{i}_r{r}",
              score_case(i, r, seed=100 + i, slo_rows=True))
    for label, case, want in guard_boundary_cases():
        guard(label, case, want)
    for i in (2, 4):   # a full window at the main path's shapes
        score(f"window_r256_i{i}", main_path_case(i))
        guard(f"window_r256_i{i}", main_path_guard_case(i))
    score("fleet_r4096_i1024", fleet_score_case(dev))
    guard("fleet_r4096_i1024", guard_case(1024, 4096, seed=4096,
                                          lam_rows=True))

    def topk(op, name, case, k, margin, redrawn=0):
        key = f"routing_{op}"
        errs[key] = max(errs[key], compare_topk(op, name, case, dev, k,
                                                margin, redrawn))

    for i, r in ((2, 64), (6, 256), (11, 128)):
        for k in (1, 2, 4):
            topk("topk", f"sweep_i{i}_r{r}_k{k}",
                 topk_case("topk", i, r, seed=40 + i), k, 0.0)
        for k in (1, 3):
            topk("attain", f"sweep_i{i}_r{r}_k{k}",
                 topk_case("attain", i, r, seed=60 + i), k, 0.1)
    for margin in (0.0, 0.5, 2.0):
        topk("topk", f"margin_{margin}", topk_case("topk", 5, 64, seed=77),
             3, margin)
    for label, op, case, k, margin in topk_edge_cases():
        topk(op, label, case, k, margin)
    for op in ("topk", "attain"):
        margin = 0.0 if op == "topk" else ATTAIN_MARGIN
        for i, r in ((3, 64), (6, 128)):
            topk(op, f"slo_rows_i{i}_r{r}",
                 topk_case(op, i, r, seed=100 + i, slo_rows=True,
                           lam_rows=True), 3, 0.25)
        for i in (2, 4):   # a full window at the main path's shapes
            topk(op, f"window_r256_i{i}", main_path_topk_case(op, i),
                 TOPK_K, margin)
        case, k, margin, redrawn = fleet_topk_case(op, dev)
        topk(op, "fleet_r4096_i1024", case, k, margin, redrawn)
    return errs


# ----------------------------------------------------------- phase 3-5 ---
def experiment_cluster():
    """Two-tier robot-fleet cluster of the reference benchmarks (edge
    RTT 1.0 s; cloud RTT 1.036 s at speed-up 2.0)."""
    from repro_torch.core.catalogue import Cluster, Deployment
    from repro_torch.core.latency_model import CLOUD, PI4_EDGE, YOLOV5M
    from repro_torch.core.scheduler import QualityClass
    edge = dataclasses.replace(PI4_EDGE, net_rtt=1.0)
    cloud = dataclasses.replace(CLOUD, net_rtt=1.036, speedup=2.0)
    return Cluster([
        Deployment(YOLOV5M, edge, QualityClass.BALANCED, n_replicas=3,
                   n_max=6),
        Deployment(YOLOV5M, cloud, QualityClass.BALANCED, n_replicas=1,
                   n_max=2),
    ])


def golden_two_tier():
    """The golden-digest cluster of the reference's test_sim_golden."""
    from repro_torch.core.catalogue import Cluster, Deployment
    from repro_torch.core.latency_model import CLOUD, PI4_EDGE, YOLOV5M
    from repro_torch.core.scheduler import QualityClass
    edge = dataclasses.replace(PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(CLOUD, net_rtt=0.086)
    return Cluster([
        Deployment(YOLOV5M, edge, QualityClass.BALANCED, n_replicas=2,
                   n_max=6),
        Deployment(YOLOV5M, cloud, QualityClass.BALANCED, n_replicas=2,
                   n_max=16),
    ])


def golden_trace(name: str):
    from repro_torch.core.workload import bounded_pareto_bursts, \
        ramp_arrivals
    if name == "ramp":
        return ramp_arrivals([1, 2, 3, 4], 60.0, "yolov5m", seed=11)
    return bounded_pareto_bursts(3.0, 120.0, "yolov5m", seed=11)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cname: str, policy: str, dev, backend: str, n_req: int = 2048):
    """``BatchRouter`` answering ``n_req`` requests in windows of 256 on
    one cluster; conservation checked, one primary decision per request
    (redundant copies come as extra ``DUPLICATE`` decisions). Returns
    (router, seconds)."""
    from repro_torch.control.admission import DUPLICATE
    from repro_torch.core.catalogue import paper_cluster
    from repro_torch.core.scheduler import QualityClass, Request
    from repro_torch.serving.batch_router import (AdmissionConfig,
                                                  BatchRouter)
    cl = paper_cluster() if cname == "paper_cluster" \
        else experiment_cluster()
    br = BatchRouter(cl, config=AdmissionConfig(
        backend=backend, device=str(dev), max_batch=256, window=1e9,
        policy=policy))
    models = sorted({d.model.name for d in cl})
    qualities = list(QualityClass) \
        if cname == "paper_cluster" else [QualityClass.BALANCED]
    reqs = [Request(model=models[k % len(models)],
                    quality=qualities[k % len(qualities)],
                    arrival=0.001 * k) for k in range(n_req)]
    sync(dev)
    t0 = time.perf_counter()
    decided = 0
    for rq in reqs:
        decided += sum(d.outcome != DUPLICATE
                       for d in br.submit(rq, rq.arrival) or ())
    sync(dev)
    seconds = time.perf_counter() - t0
    br.check_conservation()
    if br.decided != n_req or decided != n_req:
        fail(f"serving {cname}/{policy}: decided {br.decided}")
    return br, seconds


def phase_serving(dev, backend: str, policies=POLICIES) -> None:
    for cname in ("paper_cluster", "experiment_cluster"):
        for policy in policies:
            br, seconds = serve(cname, policy, dev, backend)
            emit({"phase": "serving", "cluster": cname, "policy": policy,
                  "backend": backend, "requests": br.decided,
                  "flushes": br.flushes, "outcomes": dict(br.outcomes),
                  "decisions_per_s": br.decided / seconds})


def phase_profile(dev) -> None:
    """Where one serving run's time goes: ``torch.profiler`` over the
    paper cluster with each policy, device time by kernel name against
    the host's wall time. Prints ``device_busy_ms: null`` when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for policy in ("route_best", "guarded_alg1", "safetail", "reliable"):
        serve("paper_cluster", policy, dev, "cuda", n_req=256)   # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            br, seconds = serve("paper_cluster", policy, dev, "cuda")
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and ev.self_device_time_total > 0:
                by_name[ev.key] = (ev.count, ev.self_device_time_total / 1e3)
        busy = sum(ms for _, ms in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        wall_ms = seconds * 1e3
        emit({"phase": "profile", "cell": f"serving/paper_cluster/{policy}",
              "requests": br.decided, "flushes": br.flushes,
              "wall_ms": wall_ms,
              "device_busy_ms": busy if by_name else None,
              "idle_share": 1.0 - busy / wall_ms if by_name else None,
              "device_ms_by_name": {k: {"count": c, "ms": ms}
                                    for k, (c, ms) in top}})


def phase_digests(dev, backend: str, policies=POLICIES) -> None:
    """The pinned windowed digests through ``backend`` on ``dev``."""
    from repro_torch.core.simulator import ClusterSimulator, SimConfig
    for (trace, window, policy), want in sorted(GOLDEN_WINDOWED.items()):
        if policy not in policies:
            continue
        key = f"{trace}/{window}/{policy}"
        if key in DIGEST_SKIPS:
            emit({"phase": "digest", "cell": key, "skipped": True,
                  "reason": DIGEST_SKIPS[key]})
            continue
        arr = golden_trace(trace)
        sim = ClusterSimulator(golden_two_tier(), SimConfig(
            mode="laimr", seed=11, slo=1.0, admission_window=window,
            policy=policy, admission_backend=backend,
            admission_device=str(dev)))
        res = sim.run(arr, horizon=500.0)
        s = res.summary()
        got = (int(s["n"]), s["p50"], s["p99"], res.offload_fast)
        ok = (got[0] == want[0] and got[3] == want[3]
              and abs(got[1] - want[1]) <= 1e-9 * abs(want[1])
              and abs(got[2] - want[2]) <= 1e-9 * abs(want[2]))
        emit({"phase": "digest", "backend": backend, "cell": key,
              "n": got[0], "p50": got[1],
              "p99": got[2], "offload_fast": got[3], "match": ok,
              "flushes": sim.plane.flushes})
        if not ok:
            fail(f"digest {key}: got {got}, pinned {want}")


def phase_stream(dev, backend: str, policies=POLICIES) -> dict:
    """The flash-crowd stream of ``benchmarks/bench_window_sweep.py``
    through the simulator, each policy held to the reference package's
    digest of the same run. Returns policy -> p99."""
    from repro_torch.core.simulator import ClusterSimulator, SimConfig
    from repro_torch.core.workload import flash_crowd_arrivals
    p99 = {}
    for policy in policies:
        arr = flash_crowd_arrivals(2.0, 12.0, 60.0, "yolov5m", seed=7,
                                   t_start=15.0, duration=12.0, ramp=5.0)
        sim = ClusterSimulator(experiment_cluster(), SimConfig(
            mode="laimr", seed=7, slo=1.8, jitter_sigma=0.2,
            admission_window=0.1, policy=policy, pods_per_deployment=1,
            admission_backend=backend, admission_device=str(dev)))
        t0 = time.perf_counter()
        res = sim.run(arr, horizon=None)
        seconds = time.perf_counter() - t0
        s = res.summary()
        if len(res.completed) != len(arr) or sim.plane.decided != len(arr):
            fail(f"stream {policy}: completed {len(res.completed)}, "
                 f"decided {sim.plane.decided}, arrivals {len(arr)}")
        sim.plane.check_conservation()
        switches = getattr(sim.plane.policy, "switches", None)
        got = (int(s["n"]), s["p50"], s["p99"], res.offload_fast, switches)
        want = STREAM_GOLDEN[policy]
        match = (got[0] == want[0] and got[3:] == want[3:]
                 and abs(got[1] - want[1]) <= 1e-9 * abs(want[1])
                 and abs(got[2] - want[2]) <= 1e-9 * abs(want[2]))
        emit({"phase": "stream", "cell": "flash/experiment_cluster/w0.1",
              "policy": policy, "backend": backend, "arrivals": len(arr),
              "p50": s["p50"], "p99": s["p99"],
              "offload_rate": res.offload_fast / len(arr),
              "switches": switches, "match": match,
              "flushes": sim.plane.flushes,
              "decisions_per_s": len(arr) / seconds})
        if not match:
            fail(f"stream {policy}: got {got}, reference {want}")
        p99[policy] = s["p99"]
    return p99


# ----------------------------------------------------------- phase 6 -----
def time_launches(fn, dev, n: int = 200, chunk: int = 20) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, in ms.
    A sleep kernel holds the stream while each chunk of calls is
    enqueued, so every event pair brackets the device work of one call
    and not the host's enqueue time. A chunk whose enqueue outlasted the
    sleep (the device went idle waiting for the host) is discarded and
    retried with half the calls and twice the sleep: a plain version
    made of many small kernels can fill the stream's queue of pending
    launches within one chunk, and the host then waits for the device
    whatever the sleep."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize(dev)
    times = []
    cycles = 20_000_000
    while len(times) < n:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(chunk)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        covered = not slept.query()   # the sleep still ran at the end
        torch.cuda.synchronize(dev)
        if covered:
            times += [a.elapsed_time(b) for a, b in pairs]
        elif cycles >= 2_000_000_000 and chunk == 1:
            fail("time_launches: the sleep never covered one call's "
                 "enqueue")
        else:
            cycles = min(cycles * 2, 2_000_000_000)
            chunk = max(1, chunk // 2)
    return statistics.median(times)


def time_host(fn, dev, n: int = 200, warm: int = 5) -> float:
    """Wall time of one call of ``fn`` issued back to back, in ms: the
    host's enqueue or the device's work, whichever is slower."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n * 1e3


def score_bytes_ops(case: dict) -> tuple[int, int]:
    """Bytes the function must move (each input once, each output once)
    and its f32 operations, for routing_score on this case."""
    r = case["lam"].shape[0]
    i, t = case["table"].shape
    pairs = r * i
    nbytes = (case["lam"].nbytes + case["slo"].nbytes + 7 * i * 4
              + min(pairs * 2, i * t) * 4 + r * (4 + 4 + 1))
    return nbytes, pairs * FLOPS_PER_PAIR


def topk_bytes_ops(case: dict, k: int) -> tuple[int, int]:
    """As :func:`score_bytes_ops` for routing_topk: the (R,) or (R, I)
    rates and SLO rows, seven (I,) columns (six of the latency law plus
    cost), the table entries the pairs need, and (R, k) idx and g plus
    (R,) ok out; ``TOPK_FLOPS_PER_PAIR`` f32 operations a pair."""
    r = case["lam"].shape[0]
    i, t = case["table"].shape
    pairs = r * i
    nbytes = (case["lam"].nbytes + case["slo"].nbytes + 7 * i * 4
              + min(pairs * 2, i * t) * 4 + r * (8 * k + 1))
    return nbytes, pairs * TOPK_FLOPS_PER_PAIR


def attain_bytes_ops(case: dict, k: int) -> tuple[int, int]:
    """As :func:`topk_bytes_ops` for routing_attain: eight (I,) columns
    (six of the latency law, sigma and avail) and
    ``ATTAIN_FLOPS_PER_PAIR`` f32 operations a pair."""
    r = case["lam"].shape[0]
    i, t = case["table"].shape
    pairs = r * i
    nbytes = (case["lam"].nbytes + case["slo"].nbytes + 8 * i * 4
              + min(pairs * 2, i * t) * 4 + r * (8 * k + 1))
    return nbytes, pairs * ATTAIN_FLOPS_PER_PAIR


def guard_bytes_ops(case: dict, off: np.ndarray) -> tuple[int, int]:
    """As :func:`score_bytes_ops` for routing_guard, counting what this
    data needs: the home column of every row, the upstream column only
    where the guard fired."""
    r = case["lam"].shape[0]
    i, t = case["table"].shape
    pairs = r + int(off.sum())
    nbytes = (pairs * 4 + r * 12 + 6 * min(pairs, i) * 4
              + min(pairs * 2, i * t) * 4 + r * (4 + 4 + 1))
    return nbytes, pairs * FLOPS_PER_PAIR


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_case(i: int, r: int = 256) -> dict:
    """A full window at the main path's shapes: (R, I) rates and SLO rows
    as the policies hand them to the kernels."""
    return score_case(i, r, seed=300 + i, slo_rows=True, lam_rows=True)


def main_path_guard_case(i: int, r: int = 256) -> dict:
    """A full guarded window at the main path's shapes: (R, I) rates."""
    return guard_case(i, r, seed=400 + i, lam_rows=True)


def main_path_topk_case(op: str, i: int, r: int = 256) -> dict:
    """A full top-k / attainment window at the main path's shapes: (R, I)
    rates and SLO rows."""
    return topk_case(op, i, r, seed=(500 if op == "topk" else 600) + i,
                     slo_rows=True, lam_rows=True)


def phase_times(dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_decide import (routing_attain,
                                                    routing_guard,
                                                    routing_topk)
    from repro_torch.kernels.routing_score import routing_score
    out = {"routing_score": {}, "routing_guard": {}, "routing_topk": {},
           "routing_attain": {}}
    shapes = (("r256_i2", main_path_case(2), main_path_guard_case(2)),
              ("r256_i4", main_path_case(4), main_path_guard_case(4)),
              ("r4096_i1024", fleet_score_case(dev),
               guard_case(1024, 4096, seed=4096, lam_rows=True)))
    for label, sc, gc in shapes:
        t = to_dev({k: sc[k] for k in SCORE_ARGS}, dev)
        a = [t[k] for k in SCORE_ARGS]
        nbytes, ops = score_bytes_ops(sc)
        bms, by = bound_ms(nbytes, ops)
        out["routing_score"][label] = row = dict(
            ms=time_launches(lambda: routing_score(*a), dev),
            plain_ms=time_launches(lambda: ref.routing_score_ref(*a), dev),
            host_ms=time_host(lambda: routing_score(*a), dev),
            plain_host_ms=time_host(lambda: ref.routing_score_ref(*a), dev),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "routing_score", "shape": label,
              **row})
        t = to_dev({k: gc[k] for k in GUARD_ARGS}, dev)
        a2 = [t[k] for k in GUARD_ARGS]
        off = routing_guard(*a2)[2].cpu().numpy()
        nbytes, ops = guard_bytes_ops(gc, off)
        bms, by = bound_ms(nbytes, ops)
        out["routing_guard"][label] = row = dict(
            ms=time_launches(lambda: routing_guard(*a2), dev),
            plain_ms=time_launches(lambda: ref.routing_guard_ref(*a2), dev),
            host_ms=time_host(lambda: routing_guard(*a2), dev),
            plain_host_ms=time_host(lambda: ref.routing_guard_ref(*a2),
                                    dev),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "routing_guard", "shape": label,
              **row})
    for op, kern, plain, bytes_ops in (
            ("topk", routing_topk, ref.routing_topk_ref, topk_bytes_ops),
            ("attain", routing_attain, ref.routing_attain_ref,
             attain_bytes_ops)):
        name = f"routing_{op}"
        margin = 0.0 if op == "topk" else ATTAIN_MARGIN
        for label, case in (("r256_i2", main_path_topk_case(op, 2)),
                            ("r256_i4", main_path_topk_case(op, 4)),
                            ("r4096_i1024", fleet_topk_case(op, dev)[0])):
            t = to_dev({k_: case[k_] for k_ in TOPK_ARGS[op]}, dev)
            a = [t[k_] for k_ in TOPK_ARGS[op]]
            kw = dict(k=TOPK_K, margin=margin)
            nbytes, ops = bytes_ops(case, TOPK_K)
            bms, by = bound_ms(nbytes, ops)
            out[name][label] = row = dict(
                ms=time_launches(lambda: kern(*a, **kw), dev),
                plain_ms=time_launches(lambda: plain(*a, **kw), dev),
                host_ms=time_host(lambda: kern(*a, **kw), dev),
                plain_host_ms=time_host(lambda: plain(*a, **kw), dev),
                bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                k=TOPK_K, margin=margin)
            emit({"phase": "times", "kernel": name, "shape": label, **row})
    return out


# ------------------------------------------------- model stack: phases --
H100_BF16_FLOPS = 989e12       # dense tensor-core bf16, SXM data sheet
ATTN_TOL = {"float32": 2e-5, "bfloat16": 5e-2}   # the reference's bounds
# bf16 at the model's shapes, where 5e-2 is as large as a typical output:
# kernel and plain version accumulate in float32 and differ by ~1e-6
# before the output's bf16 rounding, so they may land one bf16 step
# apart (at most 2^-7 of the value), never more
MODEL_BF16_TOL = dict(atol=1e-3, rtol=1e-2)
# full-width float32 model parity (phase 10), stated before the first chip
# run: each step's logits within LOGIT_BOUND x max |logit| of the plain
# run's; a greedy token may flip only where the plain run's top-2 gap is
# within twice that (each of the two logits may move by the bound)
LOGIT_BOUND = 1e-4
SERVE = dict(slots=8, max_len=2048, prompt=512, steps=64, partial=4)
PARITY = dict(batch=8, prompt=512, steps=16)
FLASH_MAIN = dict(b=8, s=512, h=32, d=80)      # prefill at the served shape
DECODE_MAIN = dict(b=8, c=2048, h=32, d=80)    # decode at max_len
# (b, sq, skv, h, hkv, d, kwargs): the reference's flash sweep and
# extras, head_dim 80 and a 200-token sequence among them
FLASH_CASES = [
    (1, 128, 128, 1, 1, 64, {}), (2, 256, 256, 4, 2, 64, {}),
    (2, 128, 128, 4, 1, 32, {}), (1, 512, 512, 2, 2, 128, {}),
    (2, 96, 96, 4, 4, 80, {}), (1, 200, 200, 2, 1, 80, {}),
    (2, 256, 256, 2, 2, 32, dict(window=32)),
    (2, 256, 256, 2, 2, 32, dict(window=64)),
    (2, 256, 256, 2, 2, 32, dict(window=100)),
    (1, 128, 128, 2, 2, 64, dict(softcap=30.0, scale=0.1)),
    (2, 128, 128, 2, 2, 32, dict(causal=False)),
    (2, 40, 100, 4, 2, 16, dict(window=30)),
    (1, 70, 70, 1, 1, 256, {}),
]
# (b, h, hkv, d, c, kwargs): the reference's decode sweep and extras
DECODE_CASES = [
    (1, 1, 1, 32, 128, {}), (3, 4, 2, 64, 256, {}), (2, 8, 1, 64, 512, {}),
    (2, 4, 4, 80, 200, {}), (2, 4, 2, 32, 256, dict(window=128)),
    (2, 4, 2, 32, 64, dict(softcap=30.0, scale=0.5)),
]


def attention_kernels():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention, decode_attention


def randn(gen, shape, dev, dtype):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_inputs(seed, b, sq, skv, h, hkv, d, dtype, dev, mult=1.0):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (randn(gen, (b, sq, h, d), dev, dtype) * mult,
            randn(gen, (b, skv, hkv, d), dev, dtype) * mult,
            randn(gen, (b, skv, hkv, d), dev, dtype))


def decode_inputs(seed, b, h, hkv, d, c, dtype, dev, full=False):
    """Random q and caches. ``full``: every slot holds a position before
    the query's (a cache filled to C); else the reference sweep's draws,
    kv_pos in [-1, 300) and q_pos in [100, 300], with row 0 all -1."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = randn(gen, (b, h, d), dev, dtype)
    k = randn(gen, (b, c, hkv, d), dev, dtype)
    v = randn(gen, (b, c, hkv, d), dev, dtype)
    if full:
        kv_pos = torch.arange(c, dtype=torch.int32, device=dev)[None] \
            .repeat(b, 1)
        q_pos = torch.full((b,), c, dtype=torch.int32, device=dev)
    else:
        kv_pos = torch.randint(-1, 300, (b, c), generator=gen, device=dev,
                               dtype=torch.int32)
        kv_pos[0] = -1                   # a row with no valid slot
        q_pos = torch.randint(100, 301, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
    return q, k, v, kv_pos, q_pos


def compare_attention(kernel: str, label: str, got, want, dtype,
                      tol: dict | None = None,
                      phase: str = "attention_parity") -> float:
    """Hold ``got`` to ``want`` within ``tol`` (atol, rtol; the
    reference's bound for ``dtype`` when None)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = tol or dict(atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    ok = bool(torch.allclose(got.float(), want.float(), **tol))
    emit({"phase": phase, "kernel": kernel, "case": label,
          "dtype": dtype, "max_abs_err": err,
          "max_abs_want": want.float().abs().max().item(), **tol, "ok": ok})
    if not ok or not torch.isfinite(got.float()).all():
        fail(f"{kernel} {label} {dtype}: max_abs_err {err} above {tol}")
    return err


def phase_attention_parity(dev) -> dict:
    """Both attention kernels against their plain versions on the card:
    the reference sweeps in float32 and bfloat16, head_dim 80, a
    200-token sequence, an all-invalid decode row, and the model's own
    shapes in both dtypes (decode with the sweep's mask draws and with a
    full cache). Returns kernel -> max_abs_err at the model's shapes in
    bf16, the served dtype."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models.layers import float32_gemms
    flash, decode = attention_kernels()
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    with float32_gemms():                 # float32 plain versions exact
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for n, (b, sq, skv, h, hkv, d, kw) in enumerate(FLASH_CASES):
                mult = 3.0 if "softcap" in kw else 1.0
                t = flash_inputs(700 + n, b, sq, skv, h, hkv, d, dt, dev,
                                 mult)
                compare_attention(
                    "flash_attention", f"b{b}_sq{sq}_skv{skv}_h{h}_hkv{hkv}"
                    f"_d{d}" + "".join(f"_{k}{v}" for k, v in kw.items()),
                    flash(*t, **kw), ref.flash_attention_ref(*t, **kw),
                    dtype)
            for n, (b, h, hkv, d, c, kw) in enumerate(DECODE_CASES):
                t = decode_inputs(800 + n, b, h, hkv, d, c, dt, dev)
                compare_attention(
                    "decode_attention", f"b{b}_h{h}_hkv{hkv}_d{d}_c{c}"
                    + "".join(f"_{k}{v}" for k, v in kw.items()),
                    decode(*t, **kw), ref.decode_attention_ref(*t, **kw),
                    dtype)
            tol = MODEL_BF16_TOL if dtype == "bfloat16" else None
            m = FLASH_MAIN
            t = flash_inputs(900, m["b"], m["s"], m["s"], m["h"], m["h"],
                             m["d"], dt, dev)
            err = compare_attention("flash_attention",
                                    "model_b8_s512_h32_d80", flash(*t),
                                    ref.flash_attention_ref(*t), dtype, tol)
            if dtype == "bfloat16":
                errs["flash_attention"] = err
            m = DECODE_MAIN
            for full in (False, True):
                t = decode_inputs(901, m["b"], m["h"], m["h"], m["d"],
                                  m["c"], dt, dev, full=full)
                err = compare_attention(
                    "decode_attention", "model_b8_c2048_h32_d80"
                    + ("_full" if full else ""), decode(*t),
                    ref.decode_attention_ref(*t), dtype, tol)
                if dtype == "bfloat16":
                    errs["decode_attention"] = max(
                        errs["decode_attention"], err)
    return errs


def full_width(arch: str, dtype: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype=dtype)


def prompts(seed: int, b: int, s: int, vocab: int, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device=dev,
                         dtype=torch.int32)


def greedy_logits(params, cfg, tokens, steps: int, kernels: str,
                  feed=None):
    """Prefill + ``steps`` decode steps; each step feeds ``feed[i]`` (or
    this run's own argmax). Returns (logits per step, tokens fed)."""
    import torch
    from repro_torch.models import model
    logits, cache = model.prefill(params, cfg, {"tokens": tokens},
                                  kernels=kernels)
    out, fed = [logits], []
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    for i in range(steps):
        tok = feed[i] if feed is not None else \
            torch.argmax(logits, -1).to(torch.int32)
        fed.append(tok)
        logits, cache = model.decode_step(params, cfg, tok, cache, pos,
                                          kernels=kernels)
        out.append(logits)
        pos = pos + 1
    return out, fed


def phase_model_parity(dev, cfg, batch: int, prompt: int, steps: int,
                       kernels=("cuda", "ref")) -> dict:
    """The model at ``cfg``'s widths, weights from generator seed 0:
    prefill and ``steps`` decode steps under ``kernels[0]`` against
    ``kernels[1]`` on the latter's tokens, every step's logits within
    LOGIT_BOUND x max |logit|; then ``ServingEngine.generate`` under both,
    greedy tokens equal except at a near-tie of the plain run."""
    import torch
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    params = model.init_params(cfg, seed=0, device=dev)
    tokens = prompts(1, batch, prompt, cfg.vocab_size, dev)
    kern, plain = kernels
    want, fed = greedy_logits(params, cfg, tokens, steps, plain)
    got, _ = greedy_logits(params, cfg, tokens, steps, kern, feed=fed)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale)
        emit({"phase": "model_parity", "arch": cfg.name,
              "dtype": cfg.dtype, "step": i,
              "max_abs_err": err, "max_abs_logit": scale,
              "bound": LOGIT_BOUND * scale})
        if not err <= LOGIT_BOUND * scale:
            fail(f"model parity step {i}: logits differ by {err}, bound "
                 f"{LOGIT_BOUND * scale}")
    plain_tokens = torch.stack(
        [torch.argmax(w, -1) for w in want], 1).cpu().numpy()
    runs = {}
    for k in kernels:
        eng = ServingEngine(cfg, params, slots=batch, max_len=prompt,
                            device=dev, kernels=k)
        runs[k] = eng.generate(tokens, steps=steps + 1).tokens
        del eng
    if not (runs[plain] == plain_tokens).all():
        fail("model parity: the engine's plain run differs from prefill + "
             "decode_step on the same tokens")
    flips = []
    for row in range(batch):
        diff = np.nonzero(runs[kern][row] != runs[plain][row])[0]
        if len(diff):
            step = int(diff[0])
            top2 = torch.topk(want[step][row], 2).values
            gap = (top2[0] - top2[1]).item()
            bound = 2 * LOGIT_BOUND * want[step].abs().max().item()
            flips.append({"row": row, "step": step, "top2_gap": gap,
                          "bound": bound})
            if gap > bound:
                fail(f"engine token flip at row {row} step {step}: top-2 "
                     f"gap {gap} above {bound}")
    emit({"phase": "model_parity_engine", "arch": cfg.name,
          "dtype": cfg.dtype,
          "steps": steps + 1, "tokens_equal": not flips, "flips": flips,
          "max_rel_logit_err": worst})
    return {"max_rel_logit_err": worst, "flips": flips}


def counted(fn, kernels, dev):
    """Run ``fn`` with every launch counter of ``kernels`` set to 0
    just before; returns (result, seconds, {name: launches})."""
    for k in kernels:
        k.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    seconds = time.perf_counter() - t0
    return out, seconds, {k.__name__: k.launches for k in kernels}


def profile_call(fn, dev, label: str) -> dict:
    """``torch.profiler`` over one call of ``fn`` (after one unprofiled
    call): device busy and idle share against its wall time, top device
    ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            by_name[ev.key] = (ev.count, ev.self_device_time_total / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    row = {"phase": "profile", "cell": label, "wall_ms": wall_ms,
           "device_busy_ms": busy if by_name else None,
           "idle_share": 1.0 - busy / wall_ms if by_name else None,
           "device_ms_by_name": {k: {"count": c, "ms": ms}
                                 for k, (c, ms) in top}}
    emit(row)
    return row


def path_kernels(cfg) -> tuple:
    """The kernels ``cfg``'s layers launch: the attention pair for
    attention layers, ``ssd_scan`` for Mamba-2 layers."""
    from repro_torch.models.transformer import layer_kinds
    kinds = set(layer_kinds(cfg))
    out = attention_kernels() if kinds & {"attn", "local"} else ()
    return out + ((ssd_kernel(),) if "mamba2" in kinds else ())


def expected_launches(cfg, steps: int) -> tuple[dict, dict]:
    """(launches of one ``generate`` of ``steps`` tokens, launches of one
    decode step): one flash_attention per attention layer and prefill,
    one decode_attention per attention layer and decode step, one
    ssd_scan per Mamba-2 layer and prefill and none in a decode step."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ("attn", "local") for k in kinds)
    n_ssm = kinds.count("mamba2")
    gen = {"flash_attention": n_attn,
           "decode_attention": n_attn * (steps - 1), "ssd_scan": n_ssm}
    step = {"flash_attention": 0, "decode_attention": n_attn,
            "ssd_scan": 0}
    names = [k.__name__ for k in path_kernels(cfg)]
    return ({k: gen[k] for k in names}, {k: step[k] for k in names})


def phase_engine(dev, cfg, slots: int, max_len: int, prompt: int,
                 steps: int, partial: int, kernels: str = "cuda") -> dict:
    """``ServingEngine`` at ``cfg``'s widths, weights from generator seed
    0: ``b == slots`` (prompts adopt the prefill cache: an S-deep ring,
    or the Mamba-2 states) and ``b = partial < slots`` (merged into the
    engine's cache), ``steps`` greedy tokens each. The path's kernel
    counters, set to 0 just before each ``generate`` and just before one
    more decode step and read just after, must show exactly the launches
    of ``expected_launches``. Prefill and one decode step are profiled."""
    import torch
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    counters = path_kernels(cfg) if kernels == "cuda" else ()
    params = model.init_params(cfg, seed=0, device=dev)
    out = {"launches": {k.__name__: 0 for k in path_kernels(cfg)}}
    for label, b in (("b_eq_slots", slots), ("b_lt_slots", partial)):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        eng = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                            device=dev, kernels=kernels)
        eng.generate(prompts(2, b, 16, cfg.vocab_size, dev), steps=2)
        eng = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                            device=dev, kernels=kernels)      # warm, fresh
        tokens = prompts(3 + b, b, prompt, cfg.vocab_size, dev)
        res, seconds, counts = counted(
            lambda: eng.generate(tokens, steps=steps), counters, dev)
        if res.tokens.shape != (b, steps) or (res.tokens < 0).any() \
                or (res.tokens >= cfg.vocab_size).any():
            fail(f"engine {label}: tokens {res.tokens.shape} out of range")
        want, want_step = expected_launches(cfg, steps)
        if counters and counts != want:
            fail(f"engine {label}: launches {counts}, expected {want} "
                 "(one kernel launch per layer and pass)")
        _, _, step_counts = counted(eng.step, counters, dev)
        if counters and step_counts != want_step:
            fail(f"engine {label}: one decode step launched {step_counts}, "
                 f"expected {want_step}")
        for k, c in counts.items():
            out["launches"][k] += c
        # the same work split: prefill alone, then decode steps
        batch = {"tokens": tokens}
        prefill_ms = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            eng._prefill(params, batch)
            sync(dev)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms = []
        for _ in range(16):
            t0 = time.perf_counter()
            eng.step()                     # ends in a device-to-host copy
            step_ms.append((time.perf_counter() - t0) * 1e3)
        first = eng.cache["layers"][0]
        cache_len = first["k"].shape[1] if "k" in first else None
        depth = f"C{cache_len}" if cache_len else "state"
        prof_prefill = profile_call(lambda: eng._prefill(params, batch),
                                    dev, f"prefill/{label}/S{prompt}")
        prof = profile_call(eng.step, dev, f"decode/{label}/{depth}")
        row = {"phase": "engine", "arch": cfg.name, "cell": label,
               "dtype": cfg.dtype,
               "batch": b, "slots": slots, "prompt": prompt,
               "steps": steps, "cache_len": cache_len,
               "generate_s": seconds, "launches": counts,
               "step_launches": step_counts,
               "prefill_ms": statistics.median(prefill_ms),
               "decode_ms_per_step": statistics.median(step_ms),
               # tokens delivered to the b live requests (an idle slot's
               # token is computed and dropped)
               "decode_tokens_per_s": b * 1e3 / statistics.median(step_ms),
               "generate_tokens_per_s": b * steps / seconds,
               "idle_share": prof["idle_share"],
               "prefill_idle_share": prof_prefill["idle_share"],
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None}
        emit(row)
        out[label] = row
        del eng
    return out


def flash_bytes_ops(b, s, h, d, elem=2) -> tuple[int, int]:
    """q, k, v read once and out written once; causal QK^T and PV, 2
    FLOP per multiply-add over the s(s+1)/2 visible pairs."""
    return 4 * b * s * h * d * elem, 4 * b * h * d * (s * (s + 1) // 2)


def decode_bytes_ops(b, c, h, d, elem=2) -> tuple[int, int]:
    """q and out, the K and V caches, kv_pos and q_pos; every slot of
    this run's cache is valid, so every one is needed."""
    nbytes = 2 * b * h * d * elem + 2 * b * c * h * d * elem + b * c * 4 \
        + b * 4
    return nbytes, 4 * b * h * c * d


def bf16_bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_attention_times(dev) -> dict:
    """Kernel, plain version and the one PyTorch call computing the same
    function (``scaled_dot_product_attention``: causal on pre-transposed
    (B, H, S, D) tensors; for decode with a boolean mask from kv_pos made
    outside the timed region), at the model's shapes in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    flash, decode = attention_kernels()
    m = FLASH_MAIN
    q, k, v = flash_inputs(910, m["b"], m["s"], m["s"], m["h"], m["h"],
                           m["d"], torch.bfloat16, dev)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes, ops = flash_bytes_ops(m["b"], m["s"], m["h"], m["d"])
    bms, by = bf16_bound_ms(nbytes, ops)
    out = {"flash_attention": dict(
        shape="b8_s512_h32_d80_bf16_causal",
        ms=time_launches(lambda: flash(q, k, v), dev, n=100),
        plain_ms=time_launches(lambda: ref.flash_attention_ref(q, k, v),
                               dev, n=100),
        library_ms=time_launches(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), dev, n=100),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)}
    m = DECODE_MAIN
    q, kc, vc, kv_pos, q_pos = decode_inputs(911, m["b"], m["h"], m["h"],
                                             m["d"], m["c"], torch.bfloat16,
                                             dev, full=True)
    qd = q[:, :, None, :]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    mask = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, None, :]
    nbytes, ops = decode_bytes_ops(m["b"], m["c"], m["h"], m["d"])
    bms, by = bf16_bound_ms(nbytes, ops)
    out["decode_attention"] = dict(
        shape="b8_c2048_h32_d80_bf16",
        ms=time_launches(lambda: decode(q, kc, vc, kv_pos, q_pos), dev,
                         n=100),
        plain_ms=time_launches(lambda: ref.decode_attention_ref(
            q, kc, vc, kv_pos, q_pos), dev, n=100),
        library_ms=time_launches(lambda: F.scaled_dot_product_attention(
            qd, kt, vt, attn_mask=mask), dev, n=100),
        bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
    for name, row in out.items():
        emit({"phase": "times", "kernel": name, **row})
    return out


# --------------------------------------------------- SSD scan: phases --
SSD_TOL = dict(atol=5e-4, rtol=5e-4)   # float32: the reference's own bound
MAMBA_PARITY = dict(batch=8, prompt=512, steps=16)
MAMBA_SERVE = dict(slots=8, max_len=2048, prompt=2048, steps=64, partial=4)
SSD_MAIN = dict(b=8, l=2048, h=32, p=64, g=1, n=128)   # served prefill
SSD_LONG = dict(b=1, l=32768, h=32, p=64, g=1, n=128)  # one long prompt
SSD_CHUNK = 64
PLAIN_RUNS = 3      # wall-timed runs of the plain version (a Python loop)
# (b, l, h, p, g, n, kwargs): the CPU tests' cases (the reference's
# sweep, groups 2 and 4, L = 1, 100, 200, initial states, long memory)
SSD_CASES = [
    (1, 64, 1, 16, 1, 8, {}), (2, 128, 4, 32, 2, 16, {}),
    (2, 128, 4, 32, 4, 16, {}), (1, 256, 2, 64, 1, 32, {}),
    (2, 1, 4, 16, 2, 8, dict(h0=True)), (2, 100, 4, 16, 2, 8, dict(h0=True)),
    (2, 200, 4, 16, 2, 8, dict(h0=True)),
    (1, 200, 2, 64, 1, 128, dict(h0=True)),
    (1, 640, 2, 32, 1, 16, dict(h0=True, dt_scale=0.005, bc_scale=1.0,
                                skip=False)),
]


def ssd_kernel():
    from repro_torch.kernels.ssd_scan import ssd_scan
    return ssd_scan


def ssd_inputs(seed, b, l, h, p, g, n, dtype, dev, h0=False, dt_scale=1.0,
               bc_scale=0.3, skip=True, model_a=False):
    """x ~ N(0, 1); dt = softplus(N(0, 1)) * dt_scale; a = -exp(N(0, 1)
    / 2), or the model's -linspace(1, 16, H) with ``model_a``; b, c ~
    N(0, 1) * bc_scale; d_skip ~ N(0, 1), or zero; h0 ~ N(0, 1) when
    asked. x, b and c in ``dtype``. Returns ([x, dt, a, b, c, d_skip,
    h0 or None], dt * a)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = normal(b, l, h, p).to(dtype)
    dt = F.softplus(normal(b, l, h)) * dt_scale
    a = -torch.linspace(1.0, 16.0, h, device=dev) if model_a \
        else -torch.exp(normal(h) * 0.5)
    bb = (normal(b, l, g, n) * bc_scale).to(dtype)
    cc = (normal(b, l, g, n) * bc_scale).to(dtype)
    d_skip = normal(h) if skip else torch.zeros(h, device=dev)
    init = normal(b, h, p, n) if h0 else None
    return [x, dt, a, bb, cc, d_skip, init], dt * a[None, None, :]


def phase_ssd_parity(dev) -> float:
    """``ssd_scan`` against its plain version on the card, y and the
    final state: the CPU tests' cases in float32 within ``SSD_TOL`` and
    in bf16 within ``MODEL_BF16_TOL``, then the served prefill shape (B 8,
    L 2048, 32 heads of 64, N 128, the model's a) and one long prompt
    (B 1, L 32768) in both. The long-memory case must keep at least a
    tenth of its state through every chunk, or it tests no carry.
    Returns the largest error at the served shape in bf16."""
    import torch
    from repro_torch.kernels import ref
    kernel = ssd_kernel()
    cases = [(f"b{b}_l{l}_h{h}_p{p}_g{g}_n{n}"
              + "".join(f"_{k}{v}" for k, v in kw.items()),
              dict(b=b, l=l, h=h, p=p, g=g, n=n, **kw), 1000 + i)
             for i, (b, l, h, p, g, n, kw) in enumerate(SSD_CASES)]
    cases += [("served_b8_l2048_h32_p64_n128", dict(**SSD_MAIN,
                                                    model_a=True), 1100),
              ("long_b1_l32768_h32_p64_n128", dict(**SSD_LONG,
                                                   model_a=True), 1101)]
    err_main = 0.0
    for dtype in ("float32", "bfloat16"):
        tol = SSD_TOL if dtype == "float32" else MODEL_BF16_TOL
        for label, kw, seed in cases:
            args, dta = ssd_inputs(seed, dtype=getattr(torch, dtype),
                                   dev=dev, **kw)
            if kw.get("dt_scale", 1.0) < 1.0:
                full = kw["l"] // SSD_CHUNK * SSD_CHUNK
                kept = torch.exp(dta[:, :full].reshape(
                    kw["b"], -1, SSD_CHUNK, kw["h"]).sum(2)).min().item()
                if kept < 0.1:
                    fail(f"ssd {label}: a chunk keeps {kept} of its state")
            got = kernel(*args[:6], initial_state=args[6],
                         return_final_state=True)
            want = ref.ssd_scan_ref(*args[:6], initial_state=args[6],
                                    return_final_state=True)
            errs = [compare_attention("ssd_scan", f"{label}_{out}", g, w,
                                      dtype, tol, phase="ssd_parity")
                    for out, g, w in zip(("y", "h_final"), got, want)]
            if dtype == "bfloat16" and label.startswith("served"):
                err_main = max(errs)
            del args, got, want
    return err_main


def ssd_bytes_ops(b, l, h, p, g, n, elem=2) -> tuple[int, int]:
    """x read and y written (``elem`` bytes each), dt (float32), b and c
    (``elem``), a and d_skip read once, the float32 final state written;
    the chunked algorithm's FLOPs, 2 per multiply-add: per (row, head,
    chunk of Q = 64) C B^T (Q Q N), C H^T (Q P N), the masked product
    with x (Q Q P) and the state update (Q P N)."""
    q = SSD_CHUNK
    chunks = b * h * (-(-l // q))
    nbytes = 2 * b * l * h * p * elem + b * l * h * 4 \
        + 2 * b * l * g * n * elem + 2 * h * 4 + b * h * p * n * 4
    return nbytes, chunks * 2 * (q * q * n + 2 * q * p * n + q * q * p)


def phase_ssd_times(dev) -> dict:
    """``ssd_scan`` at the served prefill shape and at one long prompt,
    bf16, against its plain version (a Python loop over L, so the mean
    wall time of ``PLAIN_RUNS`` runs after one warm run: no sleep kernel
    covers its thousands of launches) and its bound; no single PyTorch
    call computes the scan."""
    import torch
    from repro_torch.kernels import ref
    kernel = ssd_kernel()
    out = {}
    for key, shape, n in (("main", SSD_MAIN, 100), ("long", SSD_LONG, 20)):
        args, _ = ssd_inputs(1200, dtype=torch.bfloat16, dev=dev,
                             model_a=True, **shape)
        nbytes, ops = ssd_bytes_ops(**shape)
        bms, by = bf16_bound_ms(nbytes, ops)
        out[key] = dict(
            shape="b{b}_l{l}_h{h}_p{p}_g{g}_n{n}_bf16".format(**shape),
            ms=time_launches(lambda: kernel(*args[:6],
                                            return_final_state=True),
                             dev, n=n),
            plain_ms=time_host(lambda: ref.ssd_scan_ref(
                *args[:6], return_final_state=True), dev, n=PLAIN_RUNS,
                warm=1),
            plain_runs=PLAIN_RUNS, library_ms=None, bound_ms=bms,
            bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "ssd_scan", **out[key]})
        del args
    return out


# ------------------------------------------------------------------ main --
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script drives the port on a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port package at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    from repro_torch.kernels import _build
    for name, (path, seconds, log) in _build.build_all().items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "library": name, "seconds": seconds,
              "so": str(path), "flags": " ".join(_build.NVCC_FLAGS),
              "ptxas": ptxas})

    errs = phase_parity(dev)

    from repro_torch.kernels.routing_decide import (routing_attain,
                                                    routing_guard,
                                                    routing_topk)
    from repro_torch.kernels.routing_score import routing_score
    kernels = (routing_score, routing_guard, routing_topk, routing_attain)
    launches = {k.__name__: 0 for k in kernels}
    p99 = {}
    pinned = tuple(p for p in POLICIES
                   if any(key[2] == p for key in GOLDEN_WINDOWED))
    for name, phase, policies in (("serving", phase_serving, POLICIES),
                                  ("digests", phase_digests, pinned),
                                  ("stream", phase_stream, POLICIES)):
        for policy in policies:
            for k in kernels:
                k.launches = 0
            out = phase(dev, "cuda", (policy,))
            torch.cuda.synchronize(dev)
            counts = {k.__name__: k.launches for k in kernels}
            emit({"phase": "launches", "path": name, "policy": policy,
                  **counts})
            want = POLICY_KERNELS[policy]
            if name == "stream":
                p99.update(out)
                if policy == "hybrid":
                    want += ("routing_topk",)   # the flash crowd bursts
            for k in want:
                if counts[k] == 0:
                    fail(f"main path {name}/{policy}: kernel {k} never "
                         f"launched")
            for k, c in counts.items():
                launches[k] += c
    emit({"phase": "stream_p99", "policy_p99_s": {
        p: p99[p] for p in ("guarded_alg1", "safetail", "hybrid")}})
    for k, c in launches.items():
        if c == 0:
            fail(f"main path: kernel {k} never launched")

    # the default backend (the batched torch scorer) on the card, too
    phase_digests(dev, "vmap")
    phase_profile(dev)

    # the model stack: attention kernels, full-width parity, serving
    errs.update(phase_attention_parity(dev))
    parity = phase_model_parity(dev, full_width("stablelm_3b", "float32"),
                                **PARITY)
    emit({"phase": "model_parity_summary", "arch": "stablelm_3b",
          **parity})
    torch.cuda.empty_cache()
    serving = phase_engine(dev, full_width("stablelm_3b", "bfloat16"),
                           **SERVE)
    torch.cuda.empty_cache()
    attn_times = phase_attention_times(dev)

    # Mamba-2: the SSD kernel, full-width parity, serving
    errs["ssd_scan"] = phase_ssd_parity(dev)
    torch.cuda.empty_cache()
    parity = phase_model_parity(dev, full_width("mamba2_370m", "float32"),
                                **MAMBA_PARITY)
    emit({"phase": "model_parity_summary", "arch": "mamba2_370m",
          **parity})
    torch.cuda.empty_cache()
    mamba = phase_engine(dev, full_width("mamba2_370m", "bfloat16"),
                         **MAMBA_SERVE)
    torch.cuda.empty_cache()
    ssd_times = phase_ssd_times(dev)

    times = phase_times(dev)
    main_shape = "r256_i4"
    replaces = {
        "routing_score": "src/repro/kernels/routing_score.py:82",
        "routing_guard": "src/repro/kernels/routing_decide.py:246",
        "routing_topk": "src/repro/kernels/routing_decide.py:272",
        "routing_attain": "src/repro/kernels/routing_decide.py:297",
    }
    rows = []
    for k in kernels:
        tm = times[k.__name__][main_shape]
        rows.append({
            "name": k.__name__, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/routing.cu",
            "replaces": replaces[k.__name__],
            "launches": launches[k.__name__],
            "max_abs_err": errs[k.__name__], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None,
            "shape": main_shape,
            "fleet_ms": times[k.__name__]["r4096_i1024"]["ms"],
            "fleet_plain_ms": times[k.__name__]["r4096_i1024"]["plain_ms"],
            "fleet_bound_ms": times[k.__name__]["r4096_i1024"]["bound_ms"],
        })
    sources = {"flash_attention": "src/repro/kernels/flash_attention.py:84",
               "decode_attention": "src/repro/kernels/decode_attention.py:72"}
    for k in attention_kernels():
        tm = attn_times[k.__name__]
        rows.append({
            "name": k.__name__, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": sources[k.__name__],
            "launches": serving["launches"][k.__name__],
            "max_abs_err": errs[k.__name__], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
            "shape": tm["shape"]})
    tm, long = ssd_times["main"], ssd_times["long"]
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:85",
        "launches": mamba["launches"]["ssd_scan"],
        "max_abs_err": errs["ssd_scan"], "ms": tm["ms"],
        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
        "shape": tm["shape"], "plain_runs": tm["plain_runs"],
        "long_ms": long["ms"], "long_plain_ms": long["plain_ms"],
        "long_bound_ms": long["bound_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
