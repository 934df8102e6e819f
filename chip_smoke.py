#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LA-IMR (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, and
without ``src/repro_torch`` beside this file. Every phase that fails
raises, and the script then exits non-zero and prints no result line.
Each phase prints one JSON object per line:

0. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
1. the kernel build (``nvcc`` of ``kernels/csrc/routing.cu``);
2. each CUDA kernel (``routing_score``, ``routing_guard``,
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
7. kernel and plain-version times (CUDA events) at the main path's
   shapes and at fleet scale.

Launch counters are set to 0 just before each policy's run in phases
3-5 and read just after; a kernel that the policy decides through and
that did not launch fails the run (``hybrid`` must launch both of its
constituents' kernels on the flash stream). The line before the last is
the kernel table, the last line the device.
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


def time_host(fn, dev, n: int = 200) -> float:
    """Wall time of one call of ``fn`` issued back to back, in ms: the
    host's enqueue or the device's work, whichever is slower."""
    import torch
    for _ in range(5):
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
    lib = _build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": lib.build_seconds,
          "so": str(lib.path), "flags": " ".join(_build.NVCC_FLAGS),
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
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
