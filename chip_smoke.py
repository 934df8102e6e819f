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
   together, with their ptxas register and spill lines (``ssd_step``'s
   among ``ssd.cu``'s), and per body of
   ``ssd_scan`` (float32, bf16) and of the routing kernels (a narrow and
   a wide body each of ``routing_score`` / ``routing_topk`` /
   ``routing_attain``, the staged and unstaged body of ``routing_guard``)
   its registers, spills and dynamic shared memory;
2. each routing kernel (``routing_score``, ``routing_guard``,
   ``routing_topk``, ``routing_attain``) against its plain PyTorch
   version on the card: the reference package's kernel sweeps and edge
   cases, per-request SLO rows with lane exclusions, the guard's
   boundary cases, full windows at the main path's shapes, and one
   fleet-scale shape whose Erlang table exceeds a block's shared
   memory; then ``routing_score``, ``routing_topk`` and
   ``routing_attain`` at the edges of their layout (``layout_cases``: I
   of 1 to 2945 around every lanes, groups and scratch step, R = 300, (R,)
   shared rates, a misaligned rate row, k from 1 to 8 with a margin), and
   ``routing_guard`` at its staging cap and past it. ``ok`` and
   ``offloaded`` must
   match exactly, ``idx`` exactly on feasible rows, g within
   ``rtol=1e-4`` (the reference's own kernel-vs-oracle bound);
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
   row, the model's shapes, and the served heads of phase 16 (h 10 / hkv
   1 / d 256 with a binding 2048 window, decode on a wrapped ring; h 32 /
   hkv 16 / d 128 with softcap 50 and scale 144^-0.5, windowed and
   global; h 96 / hkv 8 / d 192) and of phases 16 and 17 at the served
   batch of 8 (DBRX's rep 6 and Arctic's rep 7 at d 128; Whisper's
   non-causal encoder over 1500 frames, its non-causal cross-attention
   at Sq 4 and Sq 1 against 1500 keys, its 448-slot self ring), within
   ``2e-5`` in float32 (the reference's own bound) and
   ``MODEL_BF16_TOL`` in bfloat16 (inside the reference's ``5e-2``);
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
   at the model's shapes and the served heads of phase 16
   (``ATTN_TIME_SHAPES``), against their plain versions and
   ``scaled_dot_product_attention`` (none with a softcap, which it
   lacks), and each wrapper's host time per call
   (``time_launches(host=True)``);
11. ``ssd_scan`` against its plain version, y and the final state: the
   CPU tests' cases (the reference's sweep, groups 2 and 4, L = 1, 100
   and 200, initial states, a long-memory case), P of 64, 40 and 24 at
   B 1 with initial states, N of 8, 12, 24 and 72, L of 1, 65 and 127,
   and B 5 x 32 heads (P 64, 50, 40, 20) within ``5e-4`` in float32
   (the reference's own bound) and ``MODEL_BF16_TOL`` in bf16, the served
   prefill shape (B 8, L 2048, 32 heads of 64, N 128) and one long prompt
   (B 1, L 32768) in both;
12. Mamba2-370m at full width in float32, as phase 8 (8 x 512 prompts,
   16 decode steps); then one bf16 prefill of 8 x 2048 prompts under
   ``kernels="cuda"`` and ``"ref"``: the last position's logits within
   ``PREFILL_REL`` x max |logit|, greedy first tokens equal except at a
   near-tie (``NEAR_TIE``);
13. serving Mamba2-370m in bf16 as phase 9, with 8 x 2048 prompts:
   exactly 48 ``ssd_scan`` launches per prefill and none per decode
   step, 48 ``ssd_step`` launches per decode step and none per prefill;
14. ``ssd_scan`` times at the served shape (100 launches) and the long
   prompt (20 launches) against its plain version (the mean wall time
   of ``PLAIN_RUNS`` runs: a Python loop over L), its bound and the
   earlier CUDA-core design's times (``SSD_EARLIER_MS``); ``ssd_step``
   against its plain version (the state bit for bit, y within its
   sum-order bound) and its times at both served decode steps (B 64 x
   32 heads, B 32 x 64 heads) beside its plain version, its bound and
   the launch floor; then the
   routing kernels' times at the main path's shapes and at fleet scale
   (``routing_topk`` and ``routing_attain`` also at k = 8, their most
   duplicate passes; ``routing_guard`` also at its staging cap, I = 32,
   and past it), beside the launch floor: a one-element ``fill_`` timed
   the same way;
15. the bucketed simulator twin (``SimConfig.backend="jax"``,
   ``core/jaxsim.py``) on the card, its buckets replayed from CUDA
   graphs: the seven smoke cells of ``tests/test_jaxsim.py`` against the
   twin on the CPU (every latency sample within ``TWIN_TRACE_RTOL``,
   ``offload_fast`` exact) and the event loop (``jaxsim.TOLERANCES``);
   the 1M-arrival flash trace of ``benchmarks/bench_sim_throughput.py``
   on its fleet cluster (scalar Algorithm 1; about 815,000 arrivals,
   10,060 buckets) and ``guarded_alg1`` at a 0.1 s window at 200,000,
   each against the event loop on the same trace (conservation exact,
   ``TOLERANCES``), with both wall times and arrivals/s, graph replays
   and the replays' device span; a profiled 20,000-arrival run in a
   process of its own (device ops per bucket, kernel time against the
   replays' span), the same trace eager on the card and with graphs of
   1 and 16 buckets, and the 1M trace with graphs of 1 and 16;
16. the other decoders at full width (``DECODERS``), weights from
   generator seed 0, after ``phase_moe_gemm`` (the bf16 experts'
   float32-output gate GEMM against per-expert upcast GEMMs):
   RecurrentGemma-2B whole (26 layers, 8 of them local attention) in
   float32 parity as phase 8 with 8 x 2048 prompts, then
   in bf16 ``phase_prefill_logits`` and serving as phase 9 with 8 x 2048
   prompts and 64 steps, every decode step wrapping the local layers'
   2048-slot ring (8 ``flash_attention`` per prefill, 8
   ``decode_attention`` per step); Phi-3-medium-14B, Gemma2-27B,
   Chameleon-34B and Nemotron-4-340B in float32 parity at one pattern
   period (Gemma2's ``@sw`` variant too), then in bf16 at the most
   layers whose weights and caches fit the card (``served_depth``, from
   the meta-device ``param_count``): ``phase_prefill_logits`` and serving
   with 8 x 512 prompts and 32 steps; DBRX-132B and Arctic-480B the same
   way, their float32 parity also holding every layer's expert choices
   under both routes (a flip only at a near-tie, ``MOE_NEAR_TIE``, which
   excuses that step's logits) and the bf16 runs printing each layer's
   routing and dropped tokens at a prefill and a decode step. Every depth
   run is printed against the published one (``phase: depth``);
17. Whisper-small whole (12 + 12 layers, ``phase_whisper``): float32
   parity of 8 x 1500 frames, a 4-token prompt and 16 decode steps as
   phase 8, then in bf16 ``phase_prefill_logits`` and a prefill plus 64
   greedy decode steps through ``model.prefill`` / ``model.decode_step``
   (36 ``flash_attention`` per prefill; 12 ``decode_attention`` and 12
   ``flash_attention`` at Sq 1 per decode step), prefill ms, decode ms
   per step and a profiled prefill and decode step;
18. the trainer (``phase_train``, before phase 15): float32 loss and
   gradients under ``kernels="fused"`` against ``"ref"`` at full width
   (StableLM-3B at 2 of 32 layers, B 2 x S 1024; Mamba2-370m at 2 of 48,
   B 2 x L 512), the loss within ``TRAIN_LOSS_REL``, every gradient leaf
   within ``TRAIN_GRAD_REL`` x its largest |gradient|, no hand-written
   kernel launched; ``examples/train_small.py``'s 100M model for 300
   steps on ``SyntheticText``, whose last-20 mean loss must fall more
   than 0.2 below its first-20; its params saved with the port's
   ``checkpoint``, restored bit for bit and served in float32 through
   ``ServingEngine`` under ``"cuda"`` and ``"ref"`` on both slot paths
   (greedy tokens equal, exact launches); StableLM-3B whole (bf16,
   float32 AdamW state, remat) at B 2 x S 4096 and Mamba2-370m whole at
   B 4 x L 2048, a few steps each with loss, step ms, tokens/s, peak
   memory and a profiled step, params moving, ``kernels="cuda"``
   refused;
19. the launch layer's dry run (``phase_dryrun``; started at the
   beginning, a child process running CPU work on meta tensors beside
   the card's phases, read after phase 17): every architecture's
   decode_32k step on the fake 16 x 16 mesh and StableLM-3B's train_4k
   step on the 2 x 16 x 16 one, each record ``ok`` with its per-device
   FLOPs, HBM and collective bytes (accounting, not measured);
20. the H100 fleet (``phase_fleet``): ``h100_catalogue`` from those
   records, ``examples/route_h100_fleet.py``'s requests routed and its
   burst trace simulated under all five policies through
   ``backend="cuda"``, equal to the plain route (``backend="ref"``):
   decisions, predicted latencies within ``G_RTOL``, P50 / P99,
   offloads and scale events; one routing launch per admission window;
21. the op analysis against the card (``phase_cost_check``): the bound
   of StableLM-3B's and Mamba2-370m's served prefill and decode step
   (``served_costs``, on meta tensors) no more than the device busy time
   that phases 9 and 13 profiled.

Launch counters are set to 0 just before each policy's run in phases
3-5, each ``generate`` of phases 9, 13 and 16 and one more decode step
after it, phase 17's prefill and decode steps and one more step, phase
18's parity runs and each ``generate`` of its served checkpoint, phase
15 and each cuda run of phase 20, and read just after; a kernel that the
path runs and that did not launch exactly as often as it should fails
the run (``hybrid`` must launch both of its constituents' kernels on the
flash stream). The line
before the last is the kernel table, the last line the device.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
TOPK_K_MAX = 8                 # routing_decide.K_MAX
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


def redraw_fragile(op: str, case: dict, dev, k: int, margin: float,
                   rng) -> int:
    """Redraw the rates of ``case``'s fragile rows (:func:`fragile_rows`)
    until none is left; returns the rows redrawn."""
    i = case["table"].shape[0]
    redrawn = 0
    for _ in range(50):
        bad = fragile_rows(op, case, dev, k, margin)
        if not bad.any():
            return redrawn
        redrawn += int(bad.sum())
        shape = (int(bad.sum()),) + ((i,) if case["lam"].ndim == 2 else ())
        case["lam"][bad] = rng.uniform(0.0, 10.0, shape)
    fail(f"could not draw a {op} case free of near-ties")


def fleet_topk_case(op: str, dev, r: int = 4096, i: int = 1024,
                    k: int = TOPK_K):
    """The fleet-scale case of ``routing_topk`` / ``routing_attain`` at
    k (default 2; margin 0 for topk, 0.25 for attain), with fragile rows
    redrawn. Returns (case, k, margin, rows redrawn)."""
    margin = 0.0 if op == "topk" else ATTAIN_MARGIN
    case = topk_case(op, i, r, seed=4096 + (op == "attain"), slo_rows=True,
                     lam_rows=True)
    redrawn = redraw_fragile(op, case, dev, k, margin,
                             np.random.default_rng(4098))
    return case, k, margin, redrawn


def fleet_score_case(dev, r: int = 4096, i: int = 1024) -> dict:
    case = score_case(i, r, seed=4096, slo_rows=True, lam_rows=True)
    redraw_fragile("topk", case, dev, 1, 0.0, np.random.default_rng(4097))
    return case


# the row kernels' layout edges (routing_score.row_plan): I around every
# lanes-per-row, body, staged-tile and scratch step
LAYOUT_I = (1, 2, 3, 4, 5, 16, 31, 32, 33, 1023, 1024, 1025, 2945)
ATTAIN_SCRATCH_I = 1409   # the first I whose attain cache is in the scratch
# routing_guard's staging cap (routing_decide.GUARD_STAGE_MAX; pinned here
# so that --turns can time a checkout that predates the constant)
GUARD_STAGE_I = 32
LAYOUT_R = 300          # a multiple of no plan's rows per block
LAYOUT_MARGIN = 0.25


def layout_cases(dev) -> list:
    """(label, op, case, k, margin, misalign, redrawn) for
    ``routing_score`` ("score"), ``routing_topk`` ("topk") and
    ``routing_attain`` ("attain"): every ``LAYOUT_I`` (attain also
    ``ATTAIN_SCRATCH_I``) with (R, I) rates and SLO rows, R =
    ``LAYOUT_R``; (R,) shared rates and (I,) SLOs at I 4, 33 and 1024; a
    lam whose rows start one float past a 16-byte boundary at I 4 and
    1024; and k from 1 to 8 with a margin at I 5, 1024 and 1025 (topk and
    attain). Fragile rows redrawn."""
    out = []
    rows = dict(slo_rows=True, lam_rows=True)

    def add(label, op, case, k, margin, misalign=False):
        rng = np.random.default_rng(len(out) + 900)
        redrawn = redraw_fragile("attain" if op == "attain" else "topk",
                                 case, dev, k, margin, rng)
        out.append((label, op, case, k, margin, misalign, redrawn))

    # attain's seeds are topk's + 50 (topk_case draws sigma/avail instead
    # of cost)
    for i in LAYOUT_I + (ATTAIN_SCRATCH_I,):
        if i != ATTAIN_SCRATCH_I:
            add(f"layout_i{i}_r{LAYOUT_R}", "score",
                score_case(i, LAYOUT_R, seed=700 + i, **rows), 1, 0.0)
            add(f"layout_i{i}_r{LAYOUT_R}", "topk",
                topk_case("topk", i, LAYOUT_R, seed=800 + i, **rows), TOPK_K,
                LAYOUT_MARGIN)
        add(f"layout_i{i}_r{LAYOUT_R}", "attain",
            topk_case("attain", i, LAYOUT_R, seed=850 + i, **rows), TOPK_K,
            LAYOUT_MARGIN)
    for i in (4, 33, 1024):
        add(f"shared_rates_i{i}", "score", score_case(i, LAYOUT_R,
                                                      seed=1700 + i), 1, 0.0)
        for op, seed in (("topk", 1800), ("attain", 1850)):
            add(f"shared_rates_i{i}", op, topk_case(op, i, LAYOUT_R,
                                                    seed=seed + i),
                TOPK_K, LAYOUT_MARGIN)
    for i in (4, 1024):
        add(f"misaligned_lam_i{i}", "score",
            score_case(i, LAYOUT_R, seed=2700 + i, **rows), 1, 0.0,
            misalign=True)
        for op, seed in (("topk", 2800), ("attain", 2850)):
            add(f"misaligned_lam_i{i}", op,
                topk_case(op, i, LAYOUT_R, seed=seed + i, **rows), TOPK_K,
                LAYOUT_MARGIN, misalign=True)
    for i in (5, 1024, 1025):
        for k in range(1, TOPK_K_MAX + 1):
            for op, seed in (("topk", 3800), ("attain", 3850)):
                add(f"k_sweep_i{i}", op,
                    topk_case(op, i, LAYOUT_R, seed=seed + 10 * i + k,
                              **rows), k, LAYOUT_MARGIN)
    return out


def misaligned(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary, so the row kernels take their scalar loads."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    if out.data_ptr() % 16 != 4:
        fail(f"misaligned: data at {out.data_ptr()} mod 16 is not 4")
    return out


# ----------------------------------------------------------- phase 2 -----
def compare_score(name: str, case: dict, dev, misalign: bool = False,
                  redrawn: int = 0) -> float:
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_score import routing_score
    t = to_dev({k: case[k] for k in SCORE_ARGS}, dev)
    if misalign:
        t["lam"] = misaligned(t["lam"])
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
          "fragile_rows_redrawn": redrawn, "max_abs_err": max_abs})
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
                 margin: float, redrawn: int = 0,
                 misalign: bool = False) -> float:
    """``routing_topk`` / ``routing_attain`` against the plain version:
    ``ok`` exact, every idx column exact on feasible rows and -1 on
    infeasible ones, g within ``G_RTOL``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_decide import routing_attain, \
        routing_topk
    kern, plain = ((routing_topk, ref.routing_topk_ref) if op == "topk"
                   else (routing_attain, ref.routing_attain_ref))
    t = to_dev({k_: case[k_] for k_ in TOPK_ARGS[op]}, dev)
    if misalign:
        t["lam"] = misaligned(t["lam"])
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


def guard_layout_cases() -> list:
    """(label, case, pinned offloaded or None) for ``routing_guard`` on
    both sides of its staging cap (``GUARD_STAGE_MAX`` candidates staged
    in shared memory), R 300: (R, I) and (R,) rates, every seventh row at
    the top tier (up = -1), and the pinned edges tau == g_inst (held) and
    one ulp below (offloaded) on the home column."""
    import torch

    from repro_torch.kernels.ref import _table_scores
    from repro_torch.kernels.routing_decide import GUARD_STAGE_MAX
    if GUARD_STAGE_MAX != GUARD_STAGE_I:
        fail(f"routing_guard stages up to {GUARD_STAGE_MAX} candidates, "
             f"chip_smoke's cases assume {GUARD_STAGE_I}")
    out = []
    for i in (GUARD_STAGE_I, GUARD_STAGE_I + 1):
        for lam_rows in (True, False):
            c = guard_case(i, LAYOUT_R, seed=5000 + i + 7 * lam_rows,
                           lam_rows=lam_rows)
            c["up"][::7] = -1
            out.append((f"stage_i{i}_r{LAYOUT_R}_"
                        f"{'rows' if lam_rows else 'shared'}", c, None))
        # tau at g_inst of the home column (strict >: held) and one ulp
        # below (offloaded where up >= 0); a zero home rate makes g_home
        # alpha + rtt + 0 in both versions, with no exp/log in it
        c = guard_case(i, LAYOUT_R, seed=5100 + i, lam_rows=True)
        c["lam"][np.arange(LAYOUT_R), c["home"]] = 0.0
        t = {k: torch.as_tensor(c[k]) for k in
             ("lam", "alpha", "beta", "gamma", "mu", "n", "rtt", "table")}
        g, rho = _table_scores(t["lam"], t["alpha"], t["beta"], t["gamma"],
                               t["mu"], t["n"], t["rtt"], t["table"])
        h = c["home"].astype(np.int64)
        g_home = g.numpy()[np.arange(LAYOUT_R), h]
        stable = rho.numpy()[np.arange(LAYOUT_R), h] < 1.0
        g_inst = np.where(stable, g_home - c["rtt"][h], np.float32(1e9))
        g_inst = g_inst.astype(np.float32)
        c["tau"] = np.where(np.arange(LAYOUT_R) % 2 == 0, g_inst,
                            np.nextafter(g_inst, np.float32(-1))
                            ).astype(np.float32)
        c["up"][::7] = -1
        want = (np.arange(LAYOUT_R) % 2 == 1) & (c["up"] >= 0)
        out.append((f"stage_i{i}_tau_edges", c, want))
    return out


def routing_bodies(log: str) -> list:
    """Registers, spills and dynamic shared memory of each body of
    ``routing.cu`` from ptxas's lines in the build log: the narrow (a
    candidate a lane, group 1) and wide (group 4) body of each row kernel,
    with ``row_plan``'s shared bytes at I 32 and at the fleet's I 1024,
    and the staged and unstaged guard bodies (the staged one's bytes at
    its cap, I 32, and T 65)."""
    import re

    from repro_torch.kernels.routing_score import row_plan
    out, row = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(routing_[a-z]+_kernel)"
                      r"IL([ib])(\d+)E", ln)
        if m:
            kernel, kind, arg = m.group(1), m.group(2), int(m.group(3))
            if kind == "i":
                mode = kernel.removeprefix("routing_").removesuffix("_kernel")
                row = {"kernel": kernel, "group": arg, "dynamic_smem_bytes":
                       row_plan(32 if arg == 1 else 1024, mode).smem_bytes}
            else:
                row = {"kernel": kernel, "staged": bool(arg),
                       "dynamic_smem_bytes":
                       GUARD_STAGE_I * (TABLE_T + 6) * 4 if arg else 0}
            continue
        if row is None:
            continue
        if "spill stores" in ln:
            row["spills"] = ln.strip()
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(dict(row, registers=int(m.group(1))))
            row = None
    return out


def phase_parity(dev) -> dict:
    errs = {"routing_score": 0.0, "routing_guard": 0.0, "routing_topk": 0.0,
            "routing_attain": 0.0}

    def score(name, case, misalign=False, redrawn=0):
        errs["routing_score"] = max(errs["routing_score"],
                                    compare_score(name, case, dev, misalign,
                                                  redrawn))

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

    def topk(op, name, case, k, margin, redrawn=0, misalign=False):
        key = f"routing_{op}"
        errs[key] = max(errs[key], compare_topk(op, name, case, dev, k,
                                                margin, redrawn, misalign))

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
    for label, op, case, k, margin, misalign, redrawn in layout_cases(dev):
        if op == "score":
            score(label, case, misalign, redrawn)
        else:
            topk(op, f"{label}_k{k}", case, k, margin, redrawn, misalign)
    for label, case, want in guard_layout_cases():
        guard(label, case, want)
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
def time_launches(fn, dev, n: int = 200, chunk: int = 20,
                  host: bool = False) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, in ms;
    with ``host``, the median host time of one call instead (the
    wrapper's checks, allocations and enqueue, with no wait on the
    device). A sleep kernel holds the stream while each chunk of calls is
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
        walls = []
        for a, b in pairs:
            a.record()
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
            b.record()
        covered = not slept.query()   # the sleep still ran at the end
        torch.cuda.synchronize(dev)
        if covered:
            times += walls if host else [a.elapsed_time(b) for a, b in pairs]
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
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.routing_decide import (routing_attain,
                                                    routing_guard,
                                                    routing_topk)
    from repro_torch.kernels.routing_score import routing_score
    out = {"routing_score": {}, "routing_guard": {}, "routing_topk": {},
           "routing_attain": {}}

    def guard_times(label, gc):
        t = to_dev({k: gc[k] for k in GUARD_ARGS}, dev)
        a2 = [t[k] for k in GUARD_ARGS]
        off = routing_guard(*a2)[2].cpu().numpy()
        nbytes, ops = guard_bytes_ops(gc, off)
        bms, by = bound_ms(nbytes, ops)
        out["routing_guard"][label] = row = dict(
            ms=time_launches(lambda: routing_guard(*a2), dev),
            plain_ms=time_launches(lambda: ref.routing_guard_ref(*a2), dev),
            host_ms=time_host(lambda: routing_guard(*a2), dev),
            call_host_ms=time_launches(lambda: routing_guard(*a2), dev,
                                       n=1000, host=True),
            plain_host_ms=time_host(lambda: ref.routing_guard_ref(*a2),
                                    dev),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "routing_guard", "shape": label,
              **row})

    # the launch floor: the least a launch takes, timed the same way
    one = torch.zeros(1, device=dev)
    out["launch_floor"] = {"ms": time_launches(lambda: one.fill_(1.0), dev)}
    emit({"phase": "times", "kernel": "launch_floor",
          "what": "one-element in-place fill_", **out["launch_floor"]})
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
            call_host_ms=time_launches(lambda: routing_score(*a), dev,
                                       n=1000, host=True),
            plain_host_ms=time_host(lambda: ref.routing_score_ref(*a), dev),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "routing_score", "shape": label,
              **row})
        guard_times(label, gc)
    # the guard at its staging cap (staged) and one past it (not)
    for i in (GUARD_STAGE_I, GUARD_STAGE_I + 1):
        guard_times(f"r256_i{i}", main_path_guard_case(i))
    for op, kern, plain, bytes_ops in (
            ("topk", routing_topk, ref.routing_topk_ref, topk_bytes_ops),
            ("attain", routing_attain, ref.routing_attain_ref,
             attain_bytes_ops)):
        name = f"routing_{op}"
        margin = 0.0 if op == "topk" else ATTAIN_MARGIN
        shapes = [("r256_i2", main_path_topk_case(op, 2), TOPK_K),
                  ("r256_i4", main_path_topk_case(op, 4), TOPK_K),
                  ("r4096_i1024", fleet_topk_case(op, dev)[0], TOPK_K)]
        shapes.append(   # the most duplicate passes
            ("r4096_i1024_k8", fleet_topk_case(op, dev, k=TOPK_K_MAX)[0],
             TOPK_K_MAX))
        for label, case, k in shapes:
            t = to_dev({k_: case[k_] for k_ in TOPK_ARGS[op]}, dev)
            a = [t[k_] for k_ in TOPK_ARGS[op]]
            kw = dict(k=k, margin=margin)
            nbytes, ops = bytes_ops(case, k)
            bms, by = bound_ms(nbytes, ops)
            out[name][label] = row = dict(
                ms=time_launches(lambda: kern(*a, **kw), dev),
                plain_ms=time_launches(lambda: plain(*a, **kw), dev),
                host_ms=time_host(lambda: kern(*a, **kw), dev),
                call_host_ms=time_launches(lambda: kern(*a, **kw), dev,
                                           n=400, host=True),
                plain_host_ms=time_host(lambda: plain(*a, **kw), dev),
                bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                k=k, margin=margin)
            emit({"phase": "times", "kernel": name, "shape": label, **row})
    return out


# ------------------------------------------------- model stack: phases --
H100_BF16_FLOPS = 989e12       # dense tensor-core bf16, SXM data sheet
ATTN_TOL = {"float32": 2e-5, "bfloat16": 5e-2}   # the reference's bounds
# bf16 at every attention case (5e-2 is as large as a typical output, and
# this bound lies inside it):
# kernel and plain version accumulate in float32 and differ by ~1e-5
# before the output's bf16 rounding (the flash kernel's P in two bf16
# parts: 6.4e-6 in a plain emulation at the served shape; P in one bf16
# part would be 4e-3 and miss), so they may land one bf16 step apart (at
# most 2^-7 of the value), never more
MODEL_BF16_TOL = dict(atol=1e-3, rtol=1e-2)
# full-width float32 model parity (phase 10), stated before the first chip
# run: each step's logits within LOGIT_BOUND x max |logit| of the plain
# run's; a greedy token may flip only where the plain run's top-2 gap is
# within twice that (each of the two logits may move by the bound)
LOGIT_BOUND = 1e-4
SERVE = dict(slots=8, max_len=2048, prompt=512, steps=64, partial=4)
PARITY = dict(batch=8, prompt=512, steps=16)
FLASH_MAIN = dict(b=8, s=512, h=32, d=80)      # prefill at the served shape
GEMMA2_SCALE = (4608 / 32) ** -0.5             # Gemma2's q-scale, 144^-0.5
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
    # every head_dim bucket of the tensor-core body, Sq not a multiple of
    # the 64-row q-tile; head_dims that are no multiple of 16 (zero
    # chunks); rep 4; Sq > Skv (leading rows see no key); a window edge
    # inside a tile
    *[(1, 130, 130, 2, 1, d, {}) for d in (16, 32, 64, 80, 128, 256)],
    *[(1, 97, 97, 2, 2, d, {}) for d in (8, 24, 40, 72, 200)],
    (2, 192, 192, 8, 2, 80, {}),
    (2, 100, 40, 4, 2, 80, {}),
    (1, 300, 300, 2, 2, 80, dict(window=97)),
    # the served heads of the expert-free decoders: RecurrentGemma (MQA,
    # rep 10, head_dim 256) with its 2048 window binding; Gemma2's
    # softcap 50 and scale 144^-0.5 at head_dim 128, windowed and global;
    # Nemotron's head_dim 192 (the 16-chunk body, a quarter of it zeros)
    (1, 2560, 2560, 10, 1, 256, dict(window=2048)),
    (1, 4352, 4352, 32, 16, 128, dict(window=4096, softcap=50.0,
                                      scale=GEMMA2_SCALE)),
    (2, 512, 512, 32, 16, 128, dict(softcap=50.0, scale=GEMMA2_SCALE)),
    (2, 512, 512, 96, 8, 192, {}),
    # the served heads of slice 7, at the served batch of 8 where it
    # serves: Whisper's encoder (non-causal, S 1500, no multiple of a
    # key tile) and its cross-attention (non-causal, Sq 4 at prefill and
    # Sq 1 at a decode step, against 1500 keys); DBRX (rep 6) and Arctic
    # (rep 7: 56 query heads over 8)
    (8, 1500, 1500, 12, 12, 64, dict(causal=False)),
    (8, 4, 1500, 12, 12, 64, dict(causal=False)),
    (8, 1, 1500, 12, 12, 64, dict(causal=False)),
    (2, 512, 512, 48, 8, 128, {}),
    (2, 512, 512, 56, 8, 128, {}),
]
# (b, h, hkv, d, c, kwargs, mask): the reference's decode sweep and
# extras; mask as in decode_inputs
DECODE_CASES = [
    (1, 1, 1, 32, 128, {}, "sweep"), (3, 4, 2, 64, 256, {}, "sweep"),
    (2, 8, 1, 64, 512, {}, "sweep"), (2, 4, 4, 80, 200, {}, "sweep"),
    (2, 4, 2, 32, 256, dict(window=128), "sweep"),
    (2, 4, 2, 32, 64, dict(softcap=30.0, scale=0.5), "sweep"),
    # one slot; a ragged last split (4 splits of 64, 64, 64, 8); a full
    # cache of 2048; whole splits with no valid slot beside valid ones
    (2, 4, 4, 80, 1, {}, "sweep"), (2, 32, 32, 80, 200, {}, "sweep"),
    (2, 8, 2, 80, 2048, {}, "full"), (2, 8, 8, 80, 1024, {}, "tail"),
    # the served heads, as FLASH_CASES: RecurrentGemma's 2048-slot ring
    # after it wrapped; Gemma2 windowed (wrapped, and the sweep's draws
    # at a window that binds) and global; Nemotron full
    (2, 10, 1, 256, 2048, dict(window=2048), "ring"),
    (2, 32, 16, 128, 2048, dict(window=4096, softcap=50.0,
                                scale=GEMMA2_SCALE), "ring"),
    (2, 32, 16, 128, 512, dict(window=128, softcap=50.0,
                               scale=GEMMA2_SCALE), "sweep"),
    (2, 32, 16, 128, 2048, dict(softcap=50.0, scale=GEMMA2_SCALE), "full"),
    (2, 96, 8, 192, 2048, {}, "full"),
    # slice 7 at the served batch: DBRX and Arctic full; Whisper's
    # 448-slot self ring with the sweep's draws
    (8, 48, 8, 128, 2048, {}, "full"), (8, 56, 8, 128, 2048, {}, "full"),
    (8, 12, 12, 64, 448, {}, "sweep"),
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


def decode_inputs(seed, b, h, hkv, d, c, dtype, dev, mask="sweep"):
    """Random q and caches. ``mask``: "full", every slot holds a position
    before the query's (a cache filled to C); "ring", a ring of C slots
    that has wrapped, as a decode step leaves it: row r's query at
    position C + 37 (r + 1), written into its slot, and every slot j
    holding the newest position p <= q_pos with p = j mod C; "sweep", the
    reference sweep's draws, kv_pos in [-1, 300) and q_pos in [100,
    300], with row 0 all -1; "tail", as "sweep" with every slot but the
    last 5 set to -1 (every split before the last has no valid slot)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = randn(gen, (b, h, d), dev, dtype)
    k = randn(gen, (b, c, hkv, d), dev, dtype)
    v = randn(gen, (b, c, hkv, d), dev, dtype)
    if mask == "full":
        kv_pos = torch.arange(c, dtype=torch.int32, device=dev)[None] \
            .repeat(b, 1)
        q_pos = torch.full((b,), c, dtype=torch.int32, device=dev)
        return q, k, v, kv_pos, q_pos
    if mask == "ring":
        q_pos = c + 37 * torch.arange(1, b + 1, dtype=torch.int32,
                                      device=dev)
        slot = torch.arange(c, dtype=torch.int32, device=dev)[None]
        kv_pos = q_pos[:, None] - (q_pos[:, None] - slot) % c
        return q, k, v, kv_pos.to(torch.int32), q_pos
    kv_pos = torch.randint(-1, 300, (b, c), generator=gen, device=dev,
                           dtype=torch.int32)
    q_pos = torch.randint(100, 301, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    if mask == "tail":
        kv_pos[:, :-5] = -1
    kv_pos[0] = -1                       # a row with no valid slot
    return q, k, v, kv_pos, q_pos


def compare_attention(kernel: str, label: str, got, want, dtype,
                      tol: dict | None = None,
                      phase: str = "attention_parity") -> float:
    """Hold ``got`` to ``want`` within ``tol`` (atol, rtol; when None,
    the reference's bound in float32 and ``MODEL_BF16_TOL`` in bf16)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = tol or (MODEL_BF16_TOL if dtype == "bfloat16" else
                  dict(atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype]))
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
    full cache), in bf16 all within ``MODEL_BF16_TOL``. Returns kernel ->
    max_abs_err at the model's shapes in bf16, the served dtype."""
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
            for n, (b, h, hkv, d, c, kw, mask) in enumerate(DECODE_CASES):
                t = decode_inputs(800 + n, b, h, hkv, d, c, dt, dev, mask)
                compare_attention(
                    "decode_attention", f"b{b}_h{h}_hkv{hkv}_d{d}_c{c}_{mask}"
                    + "".join(f"_{k}{v}" for k, v in kw.items()),
                    decode(*t, **kw), ref.decode_attention_ref(*t, **kw),
                    dtype)
            m = FLASH_MAIN
            t = flash_inputs(900, m["b"], m["s"], m["s"], m["h"], m["h"],
                             m["d"], dt, dev)
            err = compare_attention("flash_attention",
                                    "model_b8_s512_h32_d80", flash(*t),
                                    ref.flash_attention_ref(*t), dtype)
            if dtype == "bfloat16":
                errs["flash_attention"] = err
            m = DECODE_MAIN
            for mask in ("sweep", "full"):
                t = decode_inputs(901, m["b"], m["h"], m["h"], m["d"],
                                  m["c"], dt, dev, mask)
                err = compare_attention(
                    "decode_attention", "model_b8_c2048_h32_d80"
                    + ("_full" if mask == "full" else ""), decode(*t),
                    ref.decode_attention_ref(*t), dtype)
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


def moe_recorded(cfg, fn):
    """(fn(), the MoE layers' routing records of the call: one per layer,
    ``layers.MOE_RECORD``'s; [] without experts)."""
    from repro_torch.models import layers
    layers.MOE_RECORD = [] if cfg.n_experts else None
    try:
        out = fn()
    finally:
        records, layers.MOE_RECORD = layers.MOE_RECORD, None
    return out, records or []


def greedy_logits(params, cfg, batch: dict, steps: int, kernels: str,
                  feed=None):
    """Prefill of ``batch`` ({"tokens"}, with "frames" for the
    encoder-decoder) + ``steps`` decode steps; each step feeds ``feed[i]``
    (or this run's own argmax). Returns (logits per step, tokens fed, MoE
    routing records per step)."""
    import torch
    from repro_torch.models import model
    (logits, cache), recs = moe_recorded(
        cfg, lambda: model.prefill(params, cfg, batch, kernels=kernels))
    out, fed, records = [logits], [], [recs]
    tokens = batch["tokens"]
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    for i in range(steps):
        tok = feed[i] if feed is not None else \
            torch.argmax(logits, -1).to(torch.int32)
        fed.append(tok)
        (logits, cache), recs = moe_recorded(
            cfg, lambda: model.decode_step(params, cfg, tok, cache, pos,
                                           kernels=kernels))
        out.append(logits)
        records.append(recs)
        pos = pos + 1
    return out, fed, records


# A float32 router's top-k choice may differ between the kernel route and
# the plain one only at a near-tie: the routes' attention outputs differ
# by ~1e-6 of themselves (the float32 attention cases hold them within
# 2e-5), so their router probabilities by ~1e-6. An expert choice that
# differs where the plain route's k-th and (k+1)-th probabilities are more
# than MOE_NEAR_TIE apart fails the run; one within it is printed, and
# only that step's logits are excused from LOGIT_BOUND (a flipped choice
# moves its token's output, and through the capacity another token's
# drop).
MOE_NEAR_TIE = 1e-4


def moe_routes(got: list, want: list) -> dict:
    """Per MoE layer of one call under two routes (records in layer
    order): the plain route's smallest k-th minus (k+1)-th probability
    gap; whether each token's set of experts and the kept masks are
    equal (an order swap inside the top k routes the same); the tokens
    whose sets differ, and among those whose sets agreed in every earlier
    layer (a token flipped once has a changed state from then on) the
    largest plain-route gap (None where there is none); each route's
    dropped (token, choice) count. "flipped" is the (T,) mask of tokens
    whose set differed in some layer."""
    import torch
    out = {"min_gap": [], "assign_equal": [], "keep_equal": [],
           "flipped_tokens": [], "first_flip_gap": [], "dropped": [],
           "dropped_plain": []}
    flipped = None
    for g, w in zip(got, want):
        gap = w["top"][:, -2] - w["top"][:, -1]
        diff = (g["gate_idx"].sort(dim=1).values
                != w["gate_idx"].sort(dim=1).values).any(dim=1)
        first = diff if flipped is None else diff & ~flipped
        flipped = diff if flipped is None else flipped | diff
        out["min_gap"].append(gap.min().item())
        out["assign_equal"].append(not bool(diff.any()))
        out["keep_equal"].append(bool(torch.equal(g["keep"], w["keep"])))
        out["flipped_tokens"].append(int(diff.sum()))
        out["first_flip_gap"].append(gap[first].max().item() if first.any()
                                     else None)
        out["dropped"].append(int((~g["keep"]).sum()))
        out["dropped_plain"].append(int((~w["keep"]).sum()))
    out["flipped"] = flipped
    return out


def hold_logits(cfg, got, want, got_recs, want_recs) -> tuple[float, set]:
    """Every step's logits within LOGIT_BOUND x max |logit| of the plain
    run's, except a step where an expert choice flipped at a near-tie
    (``MOE_NEAR_TIE``); a flip above it fails. Returns (worst relative
    error over the held steps, the excused steps)."""
    worst, excused = 0.0, set()
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        row = {"phase": "model_parity", "arch": cfg.name,
               "dtype": cfg.dtype, "step": i, "max_abs_err": err,
               "max_abs_logit": scale, "bound": LOGIT_BOUND * scale}
        if cfg.n_experts:
            routes = moe_routes(got_recs[i], want_recs[i])
            del routes["flipped"]
            flips = [x for x in routes["first_flip_gap"] if x is not None]
            row["moe"] = routes
            if flips and max(flips) > MOE_NEAR_TIE:
                emit(row)
                fail(f"{cfg.name} step {i}: an expert choice differs at a "
                     f"probability gap {max(flips)} above {MOE_NEAR_TIE}")
            if flips:
                excused.add(i)
        row["excused"] = i in excused
        emit(row)
        if i in excused:
            continue
        worst = max(worst, err / scale)
        if not err <= LOGIT_BOUND * scale:
            fail(f"model parity step {i}: logits differ by {err}, bound "
                 f"{LOGIT_BOUND * scale}")
    return worst, excused


def phase_model_parity(dev, cfg, batch: int, prompt: int, steps: int,
                       kernels=("cuda", "ref")) -> dict:
    """The model at ``cfg``'s widths, weights from generator seed 0:
    prefill and ``steps`` decode steps under ``kernels[0]`` against
    ``kernels[1]`` on the latter's tokens, every step's logits within
    LOGIT_BOUND x max |logit| (``hold_logits``: with experts, each step's
    routing under both routes printed per layer, a step with an expert
    flip at a near-tie excused); then ``ServingEngine.generate`` under
    both, greedy tokens equal except at a near-tie of the plain run or at
    an excused step."""
    import torch
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    params = model.init_params(cfg, seed=0, device=dev)
    tokens = prompts(1, batch, prompt, cfg.vocab_size, dev)
    kern, plain = kernels
    want, fed, want_recs = greedy_logits(params, cfg, {"tokens": tokens},
                                         steps, plain)
    got, _, got_recs = greedy_logits(params, cfg, {"tokens": tokens}, steps,
                                     kern, feed=fed)
    worst, excused = hold_logits(cfg, got, want, got_recs, want_recs)
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
                          "bound": bound, "expert_flip": step in excused})
            if gap > bound and step not in excused:
                fail(f"engine token flip at row {row} step {step}: top-2 "
                     f"gap {gap} above {bound}")
    emit({"phase": "model_parity_engine", "arch": cfg.name,
          "dtype": cfg.dtype,
          "steps": steps + 1, "tokens_equal": not flips, "flips": flips,
          "max_rel_logit_err": worst, "excused_steps": sorted(excused)})
    return {"max_rel_logit_err": worst, "flips": flips,
            "excused_steps": sorted(excused)}


# The bf16 8 x 2048 prefill's last-position logits under kernels="cuda"
# against kernels="ref": max |delta| / max |logit| within PREFILL_REL
# (the CUDA-core scan measured 0.0423 and the tensor-core one 0.0445 on
# an H100 80GB HBM3 at 700 W: the bf16 model's own rounding through 48
# layers), and a greedy first token may flip only where the plain run's
# top-2 gap is within NEAR_TIE x max |logit| (about two bf16 steps of the
# largest logit).
PREFILL_REL = 0.06
NEAR_TIE = 0.01


def phase_prefill_logits(dev, cfg, batch: int, prompt: int,
                         params=None, inputs=None) -> dict:
    """One prefill of ``batch`` x ``prompt`` tokens (or of ``inputs``, a
    model batch) at ``cfg``'s widths (``params``, or weights from
    generator seed 0) under ``kernels="cuda"`` and ``"ref"``: the last
    position's logits finite, within ``PREFILL_REL`` x max |logit| of the
    plain run, and the greedy first tokens equal except at a near-tie
    (``NEAR_TIE``). With experts, each layer's routing under both routes
    is printed (``moe_routes``), and a row whose last token's set of
    experts differs between the routes in some layer is printed and left
    out of the bound: in bf16 the routes' router probabilities differ by
    far more than in float32, so near-ties flip choices, and a flipped
    choice moves that token's output by a whole expert's share."""
    import torch
    from repro_torch.models import model
    if params is None:
        params = model.init_params(cfg, seed=0, device=dev)
    if inputs is None:
        inputs = {"tokens": prompts(5, batch, prompt, cfg.vocab_size, dev)}
    (got, _), got_recs = moe_recorded(
        cfg, lambda: model.prefill(params, cfg, inputs, kernels="cuda"))
    (want, _), want_recs = moe_recorded(
        cfg, lambda: model.prefill(params, cfg, inputs, kernels="ref"))
    excused = []
    if cfg.n_experts:
        routes = moe_routes(got_recs, want_recs)
        flipped = routes.pop("flipped").view(batch, -1)[:, -1]
        excused = [r for r in range(batch) if bool(flipped[r])]
        emit({"phase": "moe_routing", "arch": cfg.name, "dtype": cfg.dtype,
              "call": f"prefill_{batch}x{prompt}", **routes,
              "excused_rows": excused})
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"prefill logits {cfg.name}: shape {tuple(got.shape)} or not "
             "finite")
    held = [r for r in range(got.shape[0]) if r not in excused]
    if not held:
        fail(f"prefill logits {cfg.name}: every row's last token changed "
             "its experts between the routes")
    got_all, want_all = got, want
    got, want = got[held], want[held]
    scale = want.abs().max().item()
    delta = (got - want).abs()
    rel = delta.max().item() / scale
    if not rel <= PREFILL_REL:
        fail(f"prefill logits {cfg.name}: max |delta| / max |logit| {rel} "
             f"above {PREFILL_REL}")
    near = NEAR_TIE * scale
    flips = []
    for row in torch.nonzero(got.argmax(-1) != want.argmax(-1)).flatten():
        row = held[int(row)]
        top2 = torch.topk(want_all[row], 2).values
        gap = (top2[0] - top2[1]).item()
        flips.append({"row": int(row), "top2_gap": gap, "bound": near})
        if gap > near:
            fail(f"prefill logits {cfg.name}: row {int(row)} flips its first "
                 f"token with a top-2 gap {gap} above {near}")
    row = {"phase": "prefill_logits", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "batch": batch, "prompt": prompt,
           "max_abs_delta": delta.max().item(), "max_abs_logit": scale,
           "rel": rel, "rel_bound": PREFILL_REL,
           "first_tokens_equal": not flips, "flips": flips,
           "excused_rows": excused, "rel_all_rows": (
               got_all - want_all).abs().max().item()
           / want_all.abs().max().item()}
    emit(row)
    return row


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


def profile_call(fn, dev, label: str, warm: bool = True,
                 host_ops: bool = True, kernels=()) -> dict:
    """``torch.profiler`` over one call of ``fn`` (after one unprofiled
    call unless ``warm`` is False): device busy and idle share against
    its wall time, top device ops, and in ``kernel_launches`` how many
    device ops each wrapper of ``kernels`` ran (``kernel_name``, inside a
    replayed CUDA graph too). ``host_ops=False`` traces the
    device alone (a call of ~10^5 host ops takes minutes to summarise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    sync(dev)
    activities = [ProfilerActivity.CUDA]
    if host_ops or dev.type != "cuda":
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
                                 for k, (c, ms) in top},
           "kernel_launches": {k.__name__: sum(
               c for name, (c, _) in by_name.items()
               if kernel_name(k) in name) for k in kernels}}
    emit(row)
    return row


ATTN_KINDS = ("attn", "local", "hybrid_attn", "parallel_hybrid")
SSM_KINDS = ("mamba2", "hybrid_mamba", "parallel_hybrid")


def scan_slices(cfg) -> int:
    """The ``ssd_scan`` launches of one Mamba-2 layer's prefill: one a
    slice of the state that the kernel's tiles hold (Falcon-H1's N 256:
    two)."""
    from repro_torch.kernels.ssd_scan import MAX_STATE
    return max(1, cfg.ssm_state // MAX_STATE)


def path_kernels(cfg) -> tuple:
    """The kernels ``cfg``'s layers launch: the attention pair for
    attention layers (and the encoder-decoder), ``ssd_scan`` and the
    decode mixer's three for Mamba-2 layers, ``moe_gemm`` for a hybrid
    stack's expert layers."""
    from repro_torch.models.transformer import layer_kinds
    if cfg.is_encoder_decoder:
        return attention_kernels()
    kinds = set(layer_kinds(cfg))
    out = attention_kernels() if kinds & set(ATTN_KINDS) else ()
    out += (ssd_kernel(), *mixer_kernels()) if kinds & set(SSM_KINDS) \
        else ()
    return out + ((expert_kernel(),) if "hybrid_moe" in kinds else ())


def expected_launches(cfg, steps: int) -> tuple[dict, dict]:
    """(launches of one ``generate`` of ``steps`` tokens, launches of one
    decode step): one flash_attention per attention layer and prefill,
    one decode_attention per attention layer and decode step, one
    ssd_scan per Mamba-2 layer, slice of its state (``scan_slices``) and
    prefill and none in a decode step,
    one of each of the decode mixer's three kernels per Mamba-2 layer and
    decode step and none in a prefill, two moe_gemm (up, down) per
    expert layer and pass.
    The encoder-decoder's prefill runs flash_attention in every encoder
    layer and twice in every decoder layer (self, cross), each decode
    step decode_attention (self) and flash_attention at Sq 1 (cross) in
    every decoder layer."""
    from repro_torch.models.transformer import layer_kinds
    if cfg.is_encoder_decoder:
        n = cfg.n_layers
        return ({"flash_attention": cfg.n_encoder_layers + 2 * n
                 + n * (steps - 1), "decode_attention": n * (steps - 1)},
                {"flash_attention": n, "decode_attention": n})
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_ssm = sum(k in SSM_KINDS for k in kinds)
    n_moe = 2 * kinds.count("hybrid_moe")
    mixer = [k.__name__ for k in mixer_kernels()]
    gen = {"flash_attention": n_attn,
           "decode_attention": n_attn * (steps - 1),
           "ssd_scan": n_ssm * scan_slices(cfg),
           "moe_gemm": n_moe * steps,
           **dict.fromkeys(mixer, n_ssm * (steps - 1))}
    step = {"flash_attention": 0, "decode_attention": n_attn,
            "ssd_scan": 0, "moe_gemm": n_moe, **dict.fromkeys(mixer, n_ssm)}
    names = [k.__name__ for k in path_kernels(cfg)]
    return ({k: gen[k] for k in names}, {k: step[k] for k in names})


def engine_launch_calls(cfg, steps: int) -> dict:
    """The kernel wrappers' calls in one ``generate`` of ``steps`` tokens
    on a fresh CUDA engine: the prefill's launches, then the first decode
    step's twice (run eagerly, then recorded into the engine's CUDA
    graph); the later steps replay the graph and call no wrapper."""
    gen, step = expected_launches(cfg, steps)
    calls = min(steps - 1, 2)
    return {k: gen[k] + (calls - (steps - 1)) * step[k] for k in gen}


def phase_engine(dev, cfg, slots: int, max_len: int, prompt: int,
                 steps: int, partial: int, kernels: str = "cuda",
                 params=None) -> dict:
    """``ServingEngine`` at ``cfg``'s widths (``params``, or weights from
    generator seed 0): ``b == slots`` (prompts adopt the prefill cache:
    an S-deep ring, or the recurrent states) and ``b = partial < slots``
    (merged into the engine's cache), ``steps`` greedy tokens each. The
    path's kernel counters, set to 0 just before each ``generate`` and
    read just after, must show exactly the wrapper calls of
    ``engine_launch_calls``, with one graph captured and every later step
    replayed; one more decode step calls no wrapper, and a profiled
    replayed step runs exactly the kernels of ``expected_launches``.
    Prefill and one decode step are profiled."""
    import torch
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    counters = path_kernels(cfg) if kernels == "cuda" else ()
    if params is None:
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
        want_step = expected_launches(cfg, steps)[1]
        want = engine_launch_calls(cfg, steps)
        if counters and counts != want:
            fail(f"engine {label}: launches {counts}, expected {want} "
                 "(one kernel launch per layer and pass; the first decode "
                 "step's run and capture)")
        graph = (eng.graph_captures, eng.graph_replays)
        if dev.type == "cuda" and graph != (1, steps - 2):
            fail(f"engine {label}: (captures, replays) {graph}, expected "
                 f"(1, {steps - 2})")
        _, _, step_calls = counted(eng.step, counters, dev)
        if any(step_calls.values()) or dev.type == "cuda" \
                and eng.graph_replays != steps - 1:
            fail(f"engine {label}: a replayed step called {step_calls} "
                 f"({eng.graph_replays} replays)")
        for k, c in counts.items():
            out["launches"][k] += c
        batch = {"tokens": tokens}
        if cfg.n_experts and "E" not in cfg.hybrid_pattern:
            # tokens dropped per layer at the cap: a prefill of these
            # prompts, and a decode step of every slot (idle ones too)
            _, pre = moe_recorded(cfg, lambda: eng._prefill(params, batch))
            # the step eagerly (a replayed graph runs no Python); it
            # writes the cache where the next step writes it again
            _, dec = moe_recorded(cfg, lambda: eng._decode(
                params, eng.current, eng.cache, eng.pos))
            emit({"phase": "moe_drops", "arch": cfg.name, "cell": label,
                  "live": b, "slots": slots,
                  "prefill_cap": pre[0]["cap"],
                  "prefill_dropped": [int((~r["keep"]).sum()) for r in pre],
                  "step_cap": dec[0]["cap"],
                  "step_dropped": [int((~r["keep"]).sum()) for r in dec],
                  "choices": [pre[0]["keep"].numel(),
                              dec[0]["keep"].numel()]})
        # the same work split: prefill alone, then decode steps
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
        first = next((c for c in eng.cache["layers"] if "k" in c), None)
        cache_len = None if first is None else first["k"].shape[1]
        depth = f"C{cache_len}" if cache_len else "state"
        prof_prefill = profile_call(lambda: eng._prefill(params, batch),
                                    dev, f"prefill/{label}/S{prompt}")
        prof = profile_call(eng.step, dev, f"decode/{label}/{depth}",
                            kernels=counters)
        step_counts = prof["kernel_launches"]
        if step_counts != {k: want_step[k] for k in step_counts}:
            fail(f"engine {label}: one decode step ran {step_counts}, "
                 f"expected {want_step}")
        row = {"phase": "engine", "arch": cfg.name, "cell": label,
               "dtype": cfg.dtype, "n_layers": cfg.n_layers,
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
               "decode_busy_ms": prof["device_busy_ms"],
               "prefill_busy_ms": prof_prefill["device_busy_ms"],
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None}
        emit(row)
        out[label] = row
        del eng
    return out


# ------------------------------------- the expert-free decoders: phases --
# Per architecture: float32 parity (``phase_model_parity``, prompts of
# ``parity["prompt"]``), then bf16 serving (``phase_prefill_logits`` and
# ``phase_engine``). RecurrentGemma-2B runs whole in both, its 2048-token
# prompts filling the local layers' 2048-slot ring so that every decode
# step wraps it; the dense configs' parity runs one pattern period and
# their serving the most layers that fit (``served_depth``). Gemma2's
# sliding-window variant (``@sw``, global layers windowed to 32768) runs
# the parity only: below 32768 tokens it computes what Gemma2 does.
DECODERS = {
    "recurrentgemma_2b": dict(
        whole_parity=True, parity=dict(batch=8, prompt=2048, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=2048, steps=64, partial=4)),
    "phi3_medium_14b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
    "gemma2_27b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
    "gemma2_27b@sw": dict(parity=dict(batch=8, prompt=512, steps=16)),
    "chameleon_34b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
    "nemotron_4_340b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
    # the MoE decoders of slice 7: parity one layer (DBRX's float32
    # weights ~18 GB, Arctic's ~56 GB), serving the depth that fits
    "dbrx_132b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
    "arctic_480b": dict(
        parity=dict(batch=8, prompt=512, steps=16),
        serve=dict(slots=8, max_len=2048, prompt=512, steps=32, partial=4)),
}
# Memory kept free beside a bf16 engine's weights and caches: the
# prefill's activations (Nemotron's 8 x 512 x 73728 MLP intermediate and
# its float32 copies, ~3.6 GB), the plain attention's float32 scores and
# the allocator's slack.
ENGINE_RESERVE = 12e9


def decoder_config(arch: str, dtype: str):
    """The published config of ``arch`` (``"gemma2_27b@sw"``: Gemma2's
    ``CONFIG_SW``) in ``dtype``."""
    if arch == "gemma2_27b@sw":
        from repro_torch.configs.gemma2_27b import CONFIG_SW
        return dataclasses.replace(CONFIG_SW, dtype=dtype)
    return full_width(arch, dtype)


def engine_bytes(cfg, slots: int, max_len: int) -> int:
    """``cfg``'s weights (``model.param_count`` on the meta device) and
    two engine caches: the b == slots path holds the engine's and the
    prefill's until it adopts the latter."""
    import torch
    from repro_torch.models import model
    cache = model.init_cache(cfg, slots, max_len, device="meta")
    cache_bytes = sum(t.numel() * t.element_size()
                      for layer in cache["layers"] for t in layer.values())
    elem = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return model.param_count(cfg) * elem + 2 * cache_bytes


def served_depth(dev, cfg, slots: int, max_len: int) -> int:
    """The published depth when its weights and caches fit the card's free
    memory less ``ENGINE_RESERVE``, else the most whole pattern periods
    that do."""
    import torch
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 1e15
    room = free - ENGINE_RESERVE
    if engine_bytes(cfg, slots, max_len) <= room:
        return cfg.n_layers
    n = cfg.period
    while n + cfg.period < cfg.n_layers and engine_bytes(
            dataclasses.replace(cfg, n_layers=n + cfg.period), slots,
            max_len) <= room:
        n += cfg.period
    if engine_bytes(dataclasses.replace(cfg, n_layers=n), slots,
                    max_len) > room:
        fail(f"{cfg.name}: one pattern period does not fit {room / 1e9} GB")
    return n


def emit_depth(arch: str, phase: str, cfg, published: int, why: str) -> None:
    emit({"phase": "depth", "arch": arch, "run": phase,
          "n_layers": cfg.n_layers, "published": published,
          "cut": cfg.n_layers != published, "why": why})


# The bf16 experts' gate GEMM keeps a float32 result (``layers._bmm_f32``):
# on the card one batched GEMM with a float32 output, on the CPU each
# expert's operands upcast. Both accumulate exact bf16 products in
# float32, so they agree to float32 summation order: within
# MOE_GEMM_REL x max |out|.
MOE_GEMM_REL = 1e-5
# (experts, rows, d, d_ff): DBRX's prefill (cap 1280 of 8 x 512 tokens)
# and decode (cap 2), Arctic's prefill (cap 80)
MOE_GEMM_SHAPES = [(16, 1280, 6144, 10752), (16, 2, 6144, 10752),
                   (128, 80, 7168, 4864)]


def phase_moe_gemm(dev) -> float:
    """``layers._bmm_f32`` on bf16 operands on the card against each
    expert's float32 GEMM of upcast operands (the CPU's form), at the
    served experts' shapes; returns the worst relative difference."""
    import torch
    from repro_torch.models import layers
    worst = 0.0
    with layers.float32_gemms():
        for n, (e, c, d, f) in enumerate(MOE_GEMM_SHAPES):
            gen = torch.Generator(device=dev).manual_seed(40 + n)
            a = randn(gen, (e, c, d), dev, torch.bfloat16)
            w = randn(gen, (e, d, f), dev, torch.bfloat16)
            got = layers._bmm_f32(a, w)
            want = torch.stack([a[i].float() @ w[i].float()
                                for i in range(e)])
            rel = (got - want).abs().max().item() / want.abs().max().item()
            worst = max(worst, rel)
            ok = got.dtype == torch.float32 and rel <= MOE_GEMM_REL
            emit({"phase": "moe_gemm", "shape": [e, c, d, f],
                  "dtype": str(got.dtype), "rel": rel,
                  "bound": MOE_GEMM_REL, "ok": ok})
            if not ok:
                fail(f"moe gate GEMM {(e, c, d, f)}: {got.dtype}, relative "
                     f"difference {rel} above {MOE_GEMM_REL}")
            del a, w, got, want
    return worst


def phase_decoders(dev) -> dict:
    """Every decoder of ``DECODERS`` at full width: float32
    parity, then (where it has a ``serve`` entry) a bf16 prefill under
    both kernel routes and ``phase_engine``. Each depth run against the
    published one is printed (``phase: depth``). Returns arch -> {
    "launches": the engine's counts, "parity": ..., "prefill": ...}."""
    import torch
    from repro_torch.models import model
    out = {}
    for arch, spec in DECODERS.items():
        cfg = decoder_config(arch, "float32")
        published = cfg.n_layers
        if not spec.get("whole_parity"):
            cfg = dataclasses.replace(cfg, n_layers=cfg.period)
        emit_depth(arch, "parity_float32", cfg, published,
                   "whole" if cfg.n_layers == published
                   else "one pattern period")
        row = {"parity": phase_model_parity(dev, cfg, **spec["parity"])}
        emit({"phase": "model_parity_summary", "arch": arch,
              "n_layers": cfg.n_layers, **row["parity"]})
        torch.cuda.empty_cache()
        if "serve" in spec:
            serve = spec["serve"]
            cfg = decoder_config(arch, "bfloat16")
            cfg = dataclasses.replace(cfg, n_layers=served_depth(
                dev, cfg, serve["slots"], serve["max_len"]))
            emit_depth(arch, "serve_bfloat16", cfg, published,
                       "whole" if cfg.n_layers == published else
                       "the most layers whose weights and caches fit")
            params = model.init_params(cfg, seed=0, device=dev)
            torch.cuda.empty_cache()
            row["prefill"] = phase_prefill_logits(
                dev, cfg, batch=serve["slots"], prompt=serve["prompt"],
                params=params)
            torch.cuda.empty_cache()
            row["engine"] = phase_engine(dev, cfg, **serve, params=params)
            row["launches"] = row["engine"]["launches"]
            del params
            torch.cuda.empty_cache()
        out[arch] = row
    return out


# ------------------------------------------- the encoder-decoder: phase --
# Whisper-small whole (12 + 12 layers): 8 sequences of 1500 frames (the
# stubbed frontend's output, drawn from a seeded generator) and a 4-token
# decoder prompt. Float32 parity over 16 decode steps; bf16 serving
# through model.prefill and 64 greedy model.decode_steps (the engine's
# generate cannot take the encoder-decoder, in the reference as here).
WHISPER = dict(batch=8, frames=1500, prompt=4, parity_steps=16,
               serve_steps=64)


def whisper_inputs(dev, cfg, batch: int, frames: int, prompt: int) -> dict:
    import torch
    gen = torch.Generator(device=dev).manual_seed(6)
    return {"frames": torch.randn((batch, frames, cfg.d_model),
                                  generator=gen, device=dev),
            "tokens": prompts(7, batch, prompt, cfg.vocab_size, dev)}


def phase_whisper(dev, spec=WHISPER) -> dict:
    """Whisper-small at full width, weights from generator seed 0: float32
    ``greedy_logits`` under ``kernels="cuda"`` against ``"ref"`` on the
    latter's tokens, every step within ``LOGIT_BOUND`` x max |logit|;
    then in bf16 ``phase_prefill_logits`` and a counted prefill plus
    ``serve_steps`` greedy decode steps (exactly ``expected_launches``),
    one more counted decode step, prefill ms, decode ms per step and a
    profiled prefill and decode step. Returns {"launches", "parity",
    "serve"}."""
    import torch
    from repro_torch.models import model
    cfg = full_width("whisper_small", "float32")
    emit_depth("whisper_small", "parity_float32", cfg, cfg.n_layers,
               "whole")
    params = model.init_params(cfg, seed=0, device=dev)
    inputs = whisper_inputs(dev, cfg, spec["batch"], spec["frames"],
                            spec["prompt"])
    want, fed, _ = greedy_logits(params, cfg, inputs, spec["parity_steps"],
                                 "ref")
    got, _, _ = greedy_logits(params, cfg, inputs, spec["parity_steps"],
                              "cuda", feed=fed)
    worst, _ = hold_logits(cfg, got, want, [], [])
    emit({"phase": "model_parity_summary", "arch": "whisper_small",
          "n_layers": cfg.n_layers, "max_rel_logit_err": worst})
    del params, want, got
    torch.cuda.empty_cache()

    cfg = full_width("whisper_small", "bfloat16")
    emit_depth("whisper_small", "serve_bfloat16", cfg, cfg.n_layers,
               "whole")
    params = model.init_params(cfg, seed=0, device=dev)
    inputs = whisper_inputs(dev, cfg, spec["batch"], spec["frames"],
                            spec["prompt"])
    prefill = phase_prefill_logits(dev, cfg, spec["batch"], spec["prompt"],
                                   params=params, inputs=inputs)
    counters = path_kernels(cfg)
    steps = spec["serve_steps"]
    b, t = inputs["tokens"].shape

    def serve():
        logits, cache = model.prefill(params, cfg, inputs)
        pos = torch.full((b,), t, dtype=torch.int32, device=dev)
        out = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(steps):
            logits, cache = model.decode_step(params, cfg, out[-1], cache,
                                              pos)
            out.append(torch.argmax(logits, -1).to(torch.int32))
            pos = pos + 1
        return torch.stack(out, 1).cpu().numpy(), cache, pos, logits
    serve()                                              # warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (tokens, cache, pos, logits), seconds, counts = counted(serve, counters,
                                                            dev)
    want_gen, want_step = expected_launches(cfg, steps + 1)
    if tokens.shape != (b, steps + 1) or (tokens < 0).any() \
            or (tokens >= cfg.vocab_size).any() \
            or not torch.isfinite(logits).all():
        fail(f"whisper serving: tokens {tokens.shape} out of range or "
             "logits not finite")
    if counts != want_gen:
        fail(f"whisper serving: launches {counts}, expected {want_gen}")
    nxt = torch.argmax(logits, -1).to(torch.int32)

    def step():
        return model.decode_step(params, cfg, nxt, cache, pos)
    _, _, step_counts = counted(step, counters, dev)
    if step_counts != want_step:
        fail(f"whisper decode step launched {step_counts}, expected "
             f"{want_step}")
    prefill_ms, step_ms = [], []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        model.prefill(params, cfg, inputs)
        sync(dev)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(16):
        t0 = time.perf_counter()
        logits, _ = step()
        torch.argmax(logits, -1).cpu()        # the host reads each token
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof_prefill = profile_call(lambda: model.prefill(params, cfg, inputs),
                                dev, f"prefill/whisper/S{spec['frames']}")
    prof = profile_call(lambda: torch.argmax(step()[0], -1).cpu(), dev,
                        "decode/whisper/T448")
    row = {"phase": "whisper_serve", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": b, "frames": spec["frames"], "prompt": t,
           "steps": steps, "serve_s": seconds, "launches": counts,
           "step_launches": step_counts,
           "prefill_ms": statistics.median(prefill_ms),
           "decode_ms_per_step": statistics.median(step_ms),
           "decode_tokens_per_s": b * 1e3 / statistics.median(step_ms),
           "idle_share": prof["idle_share"],
           "prefill_idle_share": prof_prefill["idle_share"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if dev.type == "cuda" else None}
    emit(row)
    return {"launches": counts, "parity": {"max_rel_logit_err": worst},
            "prefill": prefill, "serve": row}


def flash_bytes_ops(b, s, h, d, elem=2, hkv=None, window=0, sq=None,
                    causal=True) -> tuple[int, int]:
    """q and out (``sq`` queries, default ``s``, ``h`` heads), k and v
    (``s`` keys, ``hkv`` heads, default ``h``) read or written once; QK^T
    and PV, 2 FLOP per multiply-add over the visible pairs: causal
    self-attention s(s+1)/2, or with a window w each query's last
    min(i + 1, w) keys; without a causal mask or window every (query,
    key) pair, sq s."""
    hkv = h if hkv is None else hkv
    sq = s if sq is None else sq
    if not causal and not window:
        pairs = sq * s
    elif window and window < s:
        pairs = window * (window + 1) // 2 + (s - window) * window
    else:
        pairs = s * (s + 1) // 2
    return (2 * b * sq * h * d + 2 * b * s * hkv * d) * elem, \
        4 * b * h * d * pairs


def decode_bytes_ops(b, c, h, d, elem=2, hkv=None) -> tuple[int, int]:
    """q and out, the K and V caches (``hkv`` heads, default ``h``),
    kv_pos and q_pos; every slot of this run's cache is valid (a full or
    wrapped ring inside the window), so every one is needed."""
    hkv = h if hkv is None else hkv
    nbytes = 2 * b * h * d * elem + 2 * b * c * hkv * d * elem + b * c * 4 \
        + b * 4
    return nbytes, 4 * b * h * c * d


def bf16_bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Shapes the attention kernels are timed at, bf16: label -> flash (b, sq,
# skv, h, hkv, d, kwargs), decode (b, c, h, hkv, d, kwargs, mask). The
# first of each kernel is its main-path shape (StableLM-3B served); then
# its second (B 4 prefill, C 512 decode); then the served heads of
# RecurrentGemma-2B (8 x 2048 prompts, the 2048 window; decode on the
# wrapped ring), Gemma2-27B (8 x 512 prompts, softcap 50, its local
# layers' 4096 window; decode on a wrapped 2048-slot ring),
# Nemotron-4-340B (head_dim 192), Arctic-480B (rep 7) and Whisper-small
# (its encoder over 1500 frames and a decode step's cross-attention, both
# non-causal; its self-attention decode on the full 448-slot ring).
ATTN_TIME_SHAPES = {
    "flash_attention": {
        "b8_s512_h32_d80_bf16_causal": (8, 512, 512, 32, 32, 80, {}),
        "b4_s512_h32_d80_bf16_causal": (4, 512, 512, 32, 32, 80, {}),
        "rg_b8_s2048_h10_hkv1_d256_w2048": (
            8, 2048, 2048, 10, 1, 256, dict(window=2048)),
        "gemma2_b8_s512_h32_hkv16_d128_w4096_cap50": (
            8, 512, 512, 32, 16, 128, dict(window=4096, softcap=50.0,
                                           scale=GEMMA2_SCALE)),
        "nemotron_b8_s512_h96_hkv8_d192": (8, 512, 512, 96, 8, 192, {}),
        "arctic_b8_s512_h56_hkv8_d128": (8, 512, 512, 56, 8, 128, {}),
        "whisper_enc_b8_s1500_h12_d64_noncausal": (
            8, 1500, 1500, 12, 12, 64, dict(causal=False)),
        "whisper_cross_b8_sq1_skv1500_h12_d64": (
            8, 1, 1500, 12, 12, 64, dict(causal=False)),
    },
    "decode_attention": {
        "b8_c2048_h32_d80_bf16": (8, 2048, 32, 32, 80, {}, "full"),
        "b8_c512_h32_d80_bf16": (8, 512, 32, 32, 80, {}, "full"),
        "rg_b8_c2048_h10_hkv1_d256_w2048_ring": (
            8, 2048, 10, 1, 256, dict(window=2048), "ring"),
        "gemma2_b8_c2048_h32_hkv16_d128_cap50_ring": (
            8, 2048, 32, 16, 128, dict(window=4096, softcap=50.0,
                                       scale=GEMMA2_SCALE), "ring"),
        "nemotron_b8_c2048_h96_hkv8_d192": (
            8, 2048, 96, 8, 192, {}, "full"),
        "arctic_b8_c2048_h56_hkv8_d128": (8, 2048, 56, 8, 128, {}, "full"),
        "whisper_b8_c448_h12_d64": (8, 448, 12, 12, 64, {}, "full"),
    },
}


def sdpa(q, k, v, **kw):
    """``scaled_dot_product_attention`` on (B, H, S, D) tensors, with
    ``enable_gqa`` where k and v have fewer heads than q."""
    import torch.nn.functional as F
    if k.shape[1] != q.shape[1]:
        kw["enable_gqa"] = True
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def phase_attention_times(dev) -> dict:
    """Kernel, plain version and the one PyTorch call computing the same
    function (``scaled_dot_product_attention``: causal, or with a window
    as a boolean mask, on pre-transposed (B, H, S, D) tensors; for decode
    with a boolean mask from kv_pos; masks made outside the timed region;
    none with a softcap, which SDPA lacks), in bf16 at every shape of
    ``ATTN_TIME_SHAPES``; ``host_ms`` is the wrapper's host time per call.
    Each shape's kernel output is first held to its plain version on the
    same inputs within ``MODEL_BF16_TOL`` (the served batch, and so the
    decode kernel's split layout, as the main path gives it). Returns
    kernel -> shape label -> row."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models.layers import float32_gemms
    flash, decode = attention_kernels()
    out = {"flash_attention": {}, "decode_attention": {}}

    def held(kernel, label, got, plain):
        with float32_gemms():
            want = plain()
        return compare_attention(kernel, f"timed_{label}", got, want,
                                 "bfloat16")
    for label, (b, sq, s, h, hkv, d, kw) in \
            ATTN_TIME_SHAPES["flash_attention"].items():
        q, k, v = flash_inputs(910, b, sq, s, h, hkv, d, torch.bfloat16, dev)
        window = kw.get("window", 0)
        causal = kw.get("causal", True)
        library = None
        if not kw.get("softcap"):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            if window and window < s:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] <= i[:, None]) \
                    & (i[:, None] - i[None, :] < window)
                library = sdpa(qt, kt, vt, attn_mask=mask)
            else:
                library = sdpa(qt, kt, vt, is_causal=causal)
        err = held("flash_attention", label, flash(q, k, v, **kw),
                   lambda: ref.flash_attention_ref(q, k, v, **kw))
        nbytes, ops = flash_bytes_ops(b, s, h, d, hkv=hkv, window=window,
                                      sq=sq, causal=causal)
        bms, by = bf16_bound_ms(nbytes, ops)
        out["flash_attention"][label] = dict(
            max_abs_err=err,
            ms=time_launches(lambda: flash(q, k, v, **kw), dev, n=100),
            plain_ms=time_launches(
                lambda: ref.flash_attention_ref(q, k, v, **kw), dev, n=100),
            library_ms=None if library is None else
            time_launches(library, dev, n=100),
            host_ms=time_launches(lambda: flash(q, k, v, **kw), dev, n=100,
                                  host=True),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        del q, k, v, library
    for label, (b, c, h, hkv, d, kw, mask) in \
            ATTN_TIME_SHAPES["decode_attention"].items():
        q, kc, vc, kv_pos, q_pos = decode_inputs(
            911, b, h, hkv, d, c, torch.bfloat16, dev, mask)
        library = None
        if not kw.get("softcap"):
            qd = q[:, :, None, :]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
            valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            if kw.get("window"):
                valid &= kv_pos > q_pos[:, None] - kw["window"]
            library = sdpa(qd, kt, vt, attn_mask=valid[:, None, None, :])
        err = held("decode_attention", label,
                   decode(q, kc, vc, kv_pos, q_pos, **kw),
                   lambda: ref.decode_attention_ref(q, kc, vc, kv_pos,
                                                    q_pos, **kw))
        nbytes, ops = decode_bytes_ops(b, c, h, d, hkv=hkv)
        bms, by = bf16_bound_ms(nbytes, ops)
        out["decode_attention"][label] = dict(
            max_abs_err=err,
            ms=time_launches(lambda: decode(q, kc, vc, kv_pos, q_pos, **kw),
                             dev, n=100),
            plain_ms=time_launches(lambda: ref.decode_attention_ref(
                q, kc, vc, kv_pos, q_pos, **kw), dev, n=100),
            library_ms=None if library is None else
            time_launches(library, dev, n=100),
            host_ms=time_launches(lambda: decode(q, kc, vc, kv_pos, q_pos,
                                                 **kw), dev, n=100,
                                  host=True),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops)
        del q, kc, vc, library
    for name, rows in out.items():
        for shape, row in rows.items():
            emit({"phase": "times", "kernel": name, "shape": shape, **row,
                  "x_library": None if row["library_ms"] is None else
                  row["ms"] / row["library_ms"],
                  "library": "scaled_dot_product_attention"
                  if row["library_ms"] is not None else
                  "none: SDPA has no softcap",
                  "x_bound": row["ms"] / row["bound_ms"]})
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
# sweep, groups 2 and 4, L = 1, 100, 200, initial states, long memory),
# then the bf16 body's edges (the same list as TestCudaSSDKernel)
SSD_CASES = [
    (1, 64, 1, 16, 1, 8, {}), (2, 128, 4, 32, 2, 16, {}),
    (2, 128, 4, 32, 4, 16, {}), (1, 256, 2, 64, 1, 32, {}),
    (2, 1, 4, 16, 2, 8, dict(h0=True)), (2, 100, 4, 16, 2, 8, dict(h0=True)),
    (2, 200, 4, 16, 2, 8, dict(h0=True)),
    (1, 200, 2, 64, 1, 128, dict(h0=True)),
    (1, 640, 2, 32, 1, 16, dict(h0=True, dt_scale=0.005, bc_scale=1.0,
                                skip=False)),
    # B 1, 2-4 heads, P 64 and below (zero-padded) with initial states
    (1, 130, 4, 64, 2, 128, dict(h0=True)),
    (1, 130, 3, 40, 1, 64, dict(h0=True)),
    (1, 130, 2, 24, 1, 32, dict(h0=True)),
    # N no multiple of 16; N 12 and P 20 stage by threads, not TMA
    (2, 100, 4, 32, 2, 8, {}), (1, 100, 2, 64, 1, 24, dict(h0=True)),
    (2, 100, 4, 64, 1, 72, dict(h0=True)),
    (1, 100, 2, 20, 1, 12, dict(h0=True)),
    # L 1, 65, 127
    (2, 1, 4, 64, 2, 128, dict(h0=True)), (2, 65, 4, 64, 4, 64, dict(h0=True)),
    (1, 127, 4, 40, 2, 24, dict(h0=True)),
    # B 5 x 32 heads: P 64, 50, 40, 20, G 1, 2, 4
    (5, 130, 32, 64, 2, 72, dict(h0=True)), (5, 65, 32, 40, 4, 24, {}),
    (5, 1, 32, 64, 1, 8, dict(h0=True)), (5, 70, 32, 50, 1, 12, dict(h0=True)),
    (5, 70, 32, 20, 2, 16, {}),
]
# the earlier design's times (CUDA-core float32 products; NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md section 6): the served shape, the long
# prompt; printed beside this run's times in the times rows only
SSD_EARLIER_MS = {"main": 1.529104, "long": 12.025760}


def ssd_kernel():
    from repro_torch.kernels.ssd_scan import ssd_scan
    return ssd_scan


def ssd_step_kernel():
    from repro_torch.kernels.ssd_step import ssd_step
    return ssd_step


def mixer_kernels() -> tuple:
    """The Mamba-2 decode mixer's three wrappers, in launch order."""
    from repro_torch.kernels import ssd_step as step
    return step.ssd_conv_step, step.ssd_state_step, step.ssd_gated_norm


def kernel_name(wrapper) -> str:
    """The device kernel a wrapper launches: ``<name>_kernel``, except
    ``ssd_state_step``'s ``ssd_step_kernel``."""
    name = wrapper.__name__
    return "ssd_step_kernel" if name == "ssd_state_step" else f"{name}_kernel"


def expert_kernel():
    from repro_torch.kernels.moe_gemm import moe_gemm
    return moe_gemm


# --------------------------------------------------- NVIDIA-Nemotron-3-Nano
#: the served shapes of ``nemotron_3_nano.robot_chat``: 32 slots, prompts
#: of 128, 64 tokens out, ``max_len`` 192; a partial wave of 8
NEMOTRON_SERVE = dict(slots=32, max_len=192, prompt=128, steps=64,
                      partial=8)
#: (tokens, top_k, experts, d, f): a decode step's 32 rows and a full
#: wave's prefill of 32 x 128, and a prefill routed to 6 experts alone
EXPERT_SHAPES = {"decode": (32, 6, 128, 2688, 1856),
                 "prefill": (4096, 6, 128, 2688, 1856),
                 "all_to_one": (512, 6, 128, 2688, 1856)}
#: bf16 kernel against its plain version: the same bf16 inputs, float32
#: sums in another order, one rounding of the up product to bf16 each
EXPERT_BF16_REL = 1e-2


def expert_case(shape: str, dev, seed: int = 7):
    """Routed rows of ``EXPERT_SHAPES[shape]`` (sigmoid scores of random
    tokens, or every token on experts 0-5), their plan, the tokens and
    both weight stacks in bf16 at Normal(0, 1/fan_in)."""
    import torch
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.models import layers
    t, k, e, d, f = EXPERT_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.rand((t, e), generator=gen, device=dev)
    if shape == "all_to_one":
        scores[:, :k] += 10.0
    idx = torch.sort(scores, dim=-1, descending=True).indices[:, :k]
    _, tok, counts = layers.sort_by_expert(idx, e)
    x = randn(gen, (t, d), dev, torch.bfloat16)
    wi = (torch.randn((e, d, f), generator=gen, device=dev)
          * d ** -0.5).to(torch.bfloat16)
    wo = (torch.randn((e, f, d), generator=gen, device=dev)
          * f ** -0.5).to(torch.bfloat16)
    return mg.plan(counts, t * k), tok, counts, x, wi, wo


def expert_bound_ms(counts, d: int, f: int) -> float:
    """One layer's up and down launches at their least: the touched
    experts' weights and the rows in and out over 3.35 TB/s, against 4
    rows d f FLOPs at 989 TFLOP/s."""
    rows = int(counts.sum())
    touched = int((counts > 0).sum())
    nbytes = touched * 2 * d * f * 2 + rows * (2 * d + 4 * f + 4 * d)
    return 1e3 * max(nbytes / 3.35e12, 4 * rows * d * f / 989e12)


def phase_expert_kernel(dev) -> dict:
    """``moe_gemm`` (up with relu², down to float32) against its plain
    version at Nemotron-3-Nano's widths, every shape of
    ``EXPERT_SHAPES``, within ``EXPERT_BF16_REL`` x max |out|; then one
    layer's pair timed at the decode and prefill shapes beside its bound
    and the plain version."""
    import torch
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels.ref import moe_gemm_ref
    out = {}
    for shape in EXPERT_SHAPES:
        pl, tok, counts, x, wi, wo = expert_case(shape, dev)
        h = mg.moe_gemm(x, tok, wi, pl, act="relu2")
        y = mg.moe_gemm(h, None, wo, pl, out_dtype=torch.float32)
        sync(dev)
        want_h = moe_gemm_ref(x, tok, wi, counts, "relu2")
        want = moe_gemm_ref(want_h, None, wo, counts,
                            out_dtype=torch.float32)
        rel_h = ((h.float() - want_h.float()).abs().max()
                 / want_h.float().abs().max()).item()
        rel = ((y - want).abs().max() / want.abs().max()).item()
        ok = max(rel_h, rel) <= EXPERT_BF16_REL and bool(
            torch.isfinite(y).all())
        row = {"phase": "expert_parity", "shape": shape,
               "rows": pl.rows, "touched": int((counts > 0).sum()),
               "max_rows": int(counts.max()), "rel_up": rel_h,
               "rel_down": rel, "bound": EXPERT_BF16_REL, "ok": ok}
        emit(row)
        if not ok:
            fail(f"moe_gemm {shape}: relative differences {rel_h}, {rel} "
                 f"above {EXPERT_BF16_REL}")
        if shape != "all_to_one":
            d, f = wi.shape[1], wi.shape[2]

            def pair():
                hh = mg.moe_gemm(x, tok, wi, pl, act="relu2")
                mg.moe_gemm(hh, None, wo, pl, out_dtype=torch.float32)

            def plain():
                hh = moe_gemm_ref(x, tok, wi, counts, "relu2")
                moe_gemm_ref(hh, None, wo, counts, out_dtype=torch.float32)
            ms = time_launches(pair, dev, n=100, chunk=10)
            row = {"phase": "expert_times", "shape": shape,
                   "pair_ms": ms, "bound_ms": expert_bound_ms(counts, d, f),
                   "plain_ms": time_host(plain, dev, n=3, warm=1)}
            row["roofline_pct"] = 100.0 * row["bound_ms"] / ms
            emit(row)
            out[shape] = row
        del pl, tok, counts, x, wi, wo, h, y, want_h, want
        torch.cuda.empty_cache()
    return out


def phase_nemotron(dev) -> dict:
    """NVIDIA-Nemotron-3-Nano-30B-A3B whole in bf16 (52 layers, 128
    experts, the full vocabulary; weights from generator seed 0) served
    through ``ServingEngine`` at ``NEMOTRON_SERVE``: exact launches, one
    graph, every later step replayed, a prefill and a step profiled; the
    expert counters of the prefill and of a step."""
    import torch
    from repro_torch.models import layers, model
    cfg = full_width("nemotron_3_nano", "bfloat16")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev)
    sync(dev)
    emit({"phase": "nemotron_params", "seconds": time.perf_counter() - t0,
          "params": model.param_count(cfg),
          "bytes": torch.cuda.memory_allocated(dev)})
    served = phase_engine(dev, cfg, **NEMOTRON_SERVE, params=params)
    c = layers.expert_counters(dev).phase.cpu().tolist()
    emit({"phase": "nemotron_expert_counters",
          **{ph: dict(zip(layers.EXPERT_COLUMNS, row))
             for ph, row in zip(layers.EXPERT_PHASES, c)},
          "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)})
    del params
    torch.cuda.empty_cache()
    return served


# ------------------------------------------------------ Falcon-H1-34B
#: the served shapes of ``falcon_h1_34b.robot_chat``: 16 slots, prompts
#: of 128, 64 tokens out, ``max_len`` 192; a partial wave of 8
FALCON_SERVE = dict(slots=16, max_len=192, prompt=128, steps=64, partial=8)


def phase_falcon(dev) -> dict:
    """Falcon-H1-34B whole in bf16 (72 parallel layers, the full
    vocabulary; weights from generator seed 0) served through
    ``ServingEngine`` at ``FALCON_SERVE``: exact launches (two
    ``ssd_scan`` a layer and prefill), one graph, every later step
    replayed with ``decode_attention`` and the three mixer launches in
    every layer, a prefill and a step profiled, the peak memory."""
    import torch
    from repro_torch.models import model
    cfg = full_width("falcon_h1_34b", "bfloat16")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev)
    sync(dev)
    emit({"phase": "falcon_params", "seconds": time.perf_counter() - t0,
          "params": model.param_count(cfg),
          "bytes": torch.cuda.memory_allocated(dev)})
    served = phase_engine(dev, cfg, **FALCON_SERVE, params=params)
    emit({"phase": "falcon_memory",
          "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)})
    del params
    torch.cuda.empty_cache()
    return served


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


def ssd_bodies(log: str, lib) -> list:
    """Registers, spills and dynamic shared memory of each body of
    ``ssd_scan_kernel`` from ptxas's lines in the build log."""
    import re
    bodies = {"IfLb0E": ("float32", 0), "I13__nv_bfloat16Lb0E": ("bf16", 1),
              "I13__nv_bfloat16Lb1E": ("bf16, a slice of N", 1)}
    out, current = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*ssd_scan_kernel\S*)'",
                      ln)
        if m:
            current = next((v for k, v in bodies.items() if k in m.group(1)),
                           None)
            row = {}
            continue
        if current is None:
            continue
        if "spill stores" in ln:
            row["spill"] = ln.strip()
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            label, dtype = current
            out.append({"body": label, "registers": int(m.group(1)),
                        "spill": row.get("spill"),
                        "dynamic_smem_bytes":
                            lib.lib.laimr_ssd_smem_bytes(dtype)})
            current = None
    return out


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
        # a record, not measured here: kept out of the kernels line
        out[key]["earlier_ms"] = SSD_EARLIER_MS[key]
        out[key]["earlier_of"] = ("the CUDA-core design on an H100 80GB HBM3 "
                                  "at 700 W, PERF.md section 6")
        emit({"phase": "times", "kernel": "ssd_scan", **out[key]})
        del args
    return out


# The scan at Falcon-H1's head (P 128, N 256 over 2 groups), which the
# wrapper runs as whole tiles (P in two slices of 64 as heads, N in two
# launches of 128 whose y it sums): small cases with initial states and
# ragged L, then the served prefill of ``falcon_h1_34b.robot_chat`` (16 x
# 128) and a long one (8 x 2048), the model's a.
SSD_WIDE_CASES = [
    (2, 130, 4, 128, 2, 256, dict(h0=True)), (1, 65, 2, 128, 1, 128, {}),
    (1, 100, 2, 64, 1, 256, dict(h0=True)), (2, 1, 4, 128, 2, 256,
                                              dict(h0=True)),
]
SSD_WIDE = {"falcon_prefill": dict(b=16, l=128, h=32, p=128, g=2, n=256),
            "falcon_long": dict(b=8, l=2048, h=32, p=128, g=2, n=256)}


def phase_ssd_wide(dev) -> dict:
    """``ssd_scan`` at P 128 / N 256 against its plain version (y and the
    final state, float32 within ``SSD_TOL``, bf16 within
    ``MODEL_BF16_TOL``) at ``SSD_WIDE_CASES`` and ``SSD_WIDE``; then at
    ``SSD_WIDE`` in bf16 the device time of the whole call (its
    launches), the plain version's wall time, and the bound."""
    import torch
    from repro_torch.kernels import ref
    kernel = ssd_kernel()
    cases = [(f"b{b}_l{l}_h{h}_p{p}_g{g}_n{n}", dict(b=b, l=l, h=h, p=p,
                                                   g=g, n=n, **kw), 1600 + i)
             for i, (b, l, h, p, g, n, kw) in enumerate(SSD_WIDE_CASES)]
    cases += [(k, dict(**v, model_a=True), 1650 + i)
              for i, (k, v) in enumerate(SSD_WIDE.items())]
    for dtype in ("float32", "bfloat16"):
        tol = SSD_TOL if dtype == "float32" else MODEL_BF16_TOL
        for label, kw, seed in cases:
            args, _ = ssd_inputs(seed, dtype=getattr(torch, dtype),
                                 dev=dev, **kw)
            before = kernel.launches
            got = kernel(*args[:6], initial_state=args[6],
                         return_final_state=True)
            launches = kernel.launches - before
            want = ref.ssd_scan_ref(*args[:6], initial_state=args[6],
                                    return_final_state=True)
            for out, g, w in zip(("y", "h_final"), got, want):
                compare_attention("ssd_scan", f"{label}_{out}", g, w, dtype,
                                  tol, phase="ssd_wide_parity")
            emit({"phase": "ssd_wide_launches", "case": label,
                  "dtype": dtype, "launches": launches})
            del args, got, want
    out = {}
    for key, shape in SSD_WIDE.items():
        args, _ = ssd_inputs(1700, dtype=torch.bfloat16, dev=dev,
                             model_a=True, **shape)
        nbytes, ops = ssd_bytes_ops(**shape)
        bms, by = bf16_bound_ms(nbytes, ops)
        out[key] = dict(
            shape="b{b}_l{l}_h{h}_p{p}_g{g}_n{n}_bf16".format(**shape),
            ms=time_launches(lambda: kernel(*args[:6],
                                            return_final_state=True),
                             dev, n=50),
            plain_ms=time_host(lambda: ref.ssd_scan_ref(
                *args[:6], return_final_state=True), dev, n=PLAIN_RUNS,
                warm=1),
            plain_runs=PLAIN_RUNS, library_ms=None, bound_ms=bms,
            bound_by=by, bytes=nbytes, ops=ops)
        emit({"phase": "times", "kernel": "ssd_scan", "arch":
              "falcon_h1_34b", **out[key]})
        del args
    return out


# The decode step's state update (``ssd_step``) at the served steps:
# mamba2_370m's robot_chat (64 slots, 32 heads over 1 group),
# Nemotron-H's (32 slots, 64 heads over 8 groups), P 64, N 128, and
# Falcon-H1's (16 slots, 32 heads over 2 groups, P 128, N 256: two
# slices of rows, two float4s a lane); before them the CPU tests' shapes
# (tests/test_torch_ssd_step.py), with P and N at their limits
SSD_STEP_SHAPES = {"mamba2_370m": dict(b=64, h=32, g=1, p=64, n=128),
                   "nemotron_3_nano": dict(b=32, h=64, g=8, p=64, n=128),
                   "falcon_h1_34b": dict(b=16, h=32, g=2, p=128, n=256)}
SSD_STEP_CASES = [(2, 32, 1, 64, 128), (2, 64, 8, 64, 128), (3, 3, 1, 5, 4),
                  (1, 4, 2, 7, 12), (2, 6, 3, 24, 20), (5, 2, 2, 1, 8),
                  (2, 4, 4, 40, 72), (1, 1, 1, 64, 128), (3, 5, 1, 33, 124),
                  (2, 3, 3, 63, 4), (2, 32, 2, 128, 256), (3, 5, 1, 100, 252),
                  (2, 3, 3, 65, 132)]


def ssd_step_inputs(seed, b, h, g, p, n, dev, cols=True) -> list:
    """[h, dt, a, x, b, c, d_skip] as the decode step hands them over: x
    a view of a conv output row (x | B | C), laid out by column (strides
    (1, B), as the step's einsum leaves it) or with ``cols`` False by
    row; B and C repeated from G groups over the heads, dt a softplus of
    N(0, 1), a = -linspace(1, 16, H); the state and d_skip ~ N(0, 1)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    conv = normal(h * p + 2 * g * n, b).t() if cols \
        else normal(b, h * p + 2 * g * n)
    rep = h // g
    bb = conv[:, h * p:h * p + g * n].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)
    cc = conv[:, h * p + g * n:].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)
    return [normal(b, h, p, n), F.softplus(normal(b, h)),
            -torch.linspace(1.0, 16.0, h, device=dev),
            conv[:, :h * p].reshape(b, h, p), bb, cc, normal(h)]


def ssd_step_bytes_ops(b, h, p, n) -> tuple[int, int]:
    """The float32 state read once and written once; x read and y written;
    b, c, dt, a and d_skip read once. FLOPs: per state element its decay,
    (dt x) b, their sum, h c and its sum (5); per state row dt x, d_skip
    x and its add (3); per head dt a (1)."""
    return (8 * b * h * p * n + 8 * b * h * p + 8 * b * h * n + 4 * b * h
            + 8 * h, 5 * b * h * p * n + 3 * b * h * p + b * h)


def phase_ssd_step(dev) -> dict:
    """``ssd_step`` against its plain version on the card: the new state
    bit for bit, y within the bound of its sum order (N 2^-23 x sum |h c|
    + 2^-23 |y|: tests/test_torch_ssd_step.py) at ``SSD_STEP_CASES`` and
    at the served steps (``SSD_STEP_SHAPES``), x laid out by row and by
    column; then at the served steps (x by column, as served) the
    kernel's device time, the plain version's, the bytes bound and the
    launch floor. Returns {"max_y_err": the largest y error at the
    served steps, "launch_floor_ms", arch: times}."""
    import torch
    from repro_torch.kernels import ref
    kernel = ssd_step_kernel()
    cases = [("b{}_h{}_g{}_p{}_n{}".format(*c),
              dict(zip(("b", "h", "g", "p", "n"), c)))
             for c in SSD_STEP_CASES] + list(SSD_STEP_SHAPES.items())
    cases = [(f"{label}_{'cols' if cols else 'rows'}", label, kw, cols)
             for label, kw in cases for cols in (False, True)]
    worst = 0.0
    for i, (label, name, kw, cols) in enumerate(cases):
        args = ssd_step_inputs(1300 + i, dev=dev, cols=cols, **kw)
        want_h = args[0].clone()
        want = ref.ssd_step_ref(want_h, *args[1:])
        got = kernel(*args)
        sync(dev)
        same = bool(torch.equal(args[0], want_h))
        err = (got - want).abs()
        mass = (args[0] * args[5][:, :, None, :]).abs().sum(-1)
        tol = kw["n"] * 2.0 ** -23 * mass + 2.0 ** -23 * want.abs()
        row = {"phase": "ssd_step_parity", "case": label,
               "h_bit_equal": same, "y_max_abs_err": err.max().item(),
               "y_err_over_bound": (err / tol).max().item()}
        emit(row)
        if not same:
            fail(f"ssd_step {label}: the state differs from the plain "
                 f"version's in {int((args[0] != want_h).sum())} elements")
        if not bool((err <= tol).all()):
            fail(f"ssd_step {label}: y off by {row['y_max_abs_err']}, "
                 f"{row['y_err_over_bound']} of its bound")
        if name in SSD_STEP_SHAPES:
            worst = max(worst, row["y_max_abs_err"])
        del args, want_h, want, got
    one = torch.zeros(1, device=dev)
    floor = time_launches(lambda: one.fill_(1.0), dev)
    out = {"max_y_err": worst, "launch_floor_ms": floor}
    for arch, kw in SSD_STEP_SHAPES.items():
        args = ssd_step_inputs(1400, dev=dev, **kw)
        nbytes, ops = ssd_step_bytes_ops(kw["b"], kw["h"], kw["p"], kw["n"])
        bms, by = bound_ms(nbytes, ops)
        out[arch] = row = dict(
            shape="b{b}_h{h}_g{g}_p{p}_n{n}_f32".format(**kw),
            ms=time_launches(lambda: kernel(*args), dev),
            plain_ms=time_launches(lambda: ref.ssd_step_ref(*args), dev),
            bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
            launch_floor_ms=floor)
        emit({"phase": "times", "kernel": "ssd_step", "arch": arch, **row})
        del args
    return out


# The decode mixer's three kernels at the served steps (``SSD_STEP_SHAPES``'
# batches and heads; conv width 4, bf16 and the parity dtype float32):
# mamba2_370m (d_in 2048, rmsnorm(y) * silu(z)), Nemotron-H (d_in 4096,
# the gate first over 8 groups) and Falcon-H1 (d_in 4096, P 128, N 256,
# the gate first over 2 groups). Their CPU tests' cases are in
# tests/test_torch_ssd_mixer.py, which also runs on the card.
MIXER_ARCHS = {"mamba2_370m": "served_g1", "nemotron_3_nano": "served_g8",
               "falcon_h1_34b": "served_g2"}


def mixer_bytes_ops(kind: str, b: int, elem: int = 2, c: int = 0,
                    h: int = 0, w: int = 0, g: int = 0, p: int = 0,
                    n: int = 0, d: int = 0) -> tuple[int, int]:
    """(bytes, FLOPs) of one launch, each input read once and each output
    written once. conv: u, dt_raw, the buffer both ways, the taps and the
    bias in the model dtype, dt_bias, the float32 output and dt; per
    channel W products, W adds and SiLU (4), per head the add and
    softplus (3). state: ``ssd_step_bytes_ops`` with B and C read per
    group (and a_log read per head). norm: y (float32), z, scale and the
    output; ~10 FLOPs an element (the square and its sum, the scale's
    add and two products, SiLU, the gate's product)."""
    if kind == "conv":
        return (elem * (b * c * (2 * w - 1) + w * c + c + b * h)
                + 4 * (h + b * c + b * h),
                b * c * (2 * w + 4) + 3 * b * h)
    if kind == "state":
        nbytes, ops = ssd_step_bytes_ops(b, h, p, n)
        return nbytes - 8 * b * h * n + 8 * b * g * n, ops + h
    return (4 * b * d + 4 * d + 2 * elem * b * d, 10 * b * d)


def phase_ssd_mixer(dev) -> dict:
    """The decode mixer's kernels at the served steps: each against its
    plain version (``tests/test_torch_ssd_mixer.py``'s ``mixer_args``:
    the conv output, dt, the buffer and the state bit for bit, y within
    its sum-order bound, the norm within ``norm_tol``), in bf16 and
    float32; then in bf16 each kernel's device time, its plain version's,
    its bytes bound and the launch floor, and the device time of one
    layer's decode step (in_proj to out_proj) under ``"cuda"`` and under
    ``"ref"`` (the eager passes).
    Returns {arch: {kernel: times}, "layer": ...}."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_ssd_mixer as tm
    from repro_torch.models import ssm
    one = torch.zeros(1, device=dev)
    floor = time_launches(lambda: one.fill_(1.0), dev)
    out = {"launch_floor_ms": floor}
    for arch, case in MIXER_ARCHS.items():
        bsz = SSD_STEP_SHAPES[arch]["b"]
        for dtype in (torch.float32, torch.bfloat16):
            args = tm.mixer_args(case, dtype, bsz, 1500, dev)
            for which in ("conv", "norm"):
                got, got_m, want, want_m = tm.run_kernel(which, args[which])
                if which == "conv":
                    ok = all(torch.equal(u, v) for u, v in zip(
                        (*got, got_m), (*want, want_m)))
                    worst = max((u - v).abs().max().item()
                                for u, v in zip(got, want))
                else:
                    err = (got.float() - want.float()).abs()
                    worst = (err / tm.norm_tol(want, args["norm"][4])) \
                        .max().item()
                    ok = worst <= 1.0
                emit({"phase": "ssd_mixer_parity", "arch": arch,
                      "kernel": which, "dtype": str(dtype), "ok": ok,
                      "worst": worst})
                if not ok:
                    fail(f"ssd_mixer {arch} {which} {dtype}: off its plain "
                         f"version by {worst}")
        st = args["state"]
        rep = st[0].shape[1] // st[4].shape[1]
        want_h = st[0].clone()
        ref_y = tm.ref.ssd_step_ref(
            want_h, st[1], -torch.exp(st[2]), st[3],
            st[4].repeat_interleave(rep, 1).contiguous(),
            st[5].repeat_interleave(rep, 1).contiguous(), st[6])
        h = st[0].clone()
        y = mixer_kernels()[1](h, *st[1:])
        sync(dev)
        tol = tm.y_tol(h, st[5].repeat_interleave(rep, 1), ref_y)
        y_over = ((y - ref_y).abs() / tol).max().item()
        emit({"phase": "ssd_mixer_parity", "arch": arch, "kernel": "state",
              "h_bit_equal": bool(torch.equal(h, want_h)),
              "y_err_over_bound": y_over})
        if not torch.equal(h, want_h) or y_over > 1.0:
            fail(f"ssd_mixer {arch} state: off ssd_step's plain version")
        out[arch] = rows = {}
        dd = ssm.dims(tm.arch_config(case, torch.bfloat16))
        sizes = {"conv": dict(c=dd["conv_ch"], h=dd["n_heads"],
                              w=dd["conv_w"]),
                 "state": dict(h=dd["n_heads"], g=dd["groups"],
                               p=dd["head_dim"], n=dd["state"]),
                 "norm": dict(d=dd["d_in"])}
        for which, wrapper in zip(("conv", "state", "norm"),
                                  mixer_kernels()):
            _, plain, _, _ = tm.WRAPPERS[which]
            a = args[which]
            nbytes, ops = mixer_bytes_ops(which, bsz, **sizes[which])
            bms, by = bound_ms(nbytes, ops)
            rows[which] = row = dict(
                kernel=kernel_name(wrapper), shape=f"b{bsz}_{case}_bf16",
                ms=time_launches(lambda: wrapper(*a), dev),
                plain_ms=time_launches(lambda: plain(*a), dev),
                bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                launch_floor_ms=floor)
            emit({"phase": "times", "kernel": wrapper.__name__,
                  "arch": arch, **row})
        cfg, prm, state, x = tm.layer_case(case, torch.bfloat16, bsz, 1501,
                                           dev)
        rows["layer"] = row = {
            kernels: time_launches(lambda: ssm.decode_step(
                prm, cfg, x, state, kernels=kernels), dev)
            for kernels in ("cuda", "ref")}
        emit({"phase": "times", "kernel": "mamba2_decode_layer",
              "arch": arch, "shape": f"b{bsz}_{case}_bf16",
              "device_ms": row, "note": "one layer's decode step, in_proj "
              "to out_proj, under the kernels and the eager passes"})
        del args, st, h, want_h, state
    return out

# ----------------------------------------------------- training: phase --
# The trainer (``repro_torch.training``) on the card, through the fused
# path (``kernels="fused"``: blocked attention with its hand-written
# backward, the chunked SSD scan), the only path with a backward besides
# the plain versions; the checkpoint it writes is then served through the
# hand-written kernels. Sizes:
# * parity: StableLM-3B at 2 of 32 layers, B 2 x S 1024, and Mamba2-370m
#   at 2 of 48, B 2 x L 512, float32 (remat as configured): loss and
#   every gradient leaf under "fused" against "ref";
# * example: ``examples/train_small.py``'s model (StableLM family at 8 x
#   512, vocab 32768, float32, no remat), B 8 x S 128, 300 steps, seed
#   0, lr 3e-4, warmup 100, cosine to 300;
# * serve: the example's trained params saved, restored and served in
#   float32 through ``ServingEngine`` under "cuda" and "ref", both slot
#   paths;
# * whole: StableLM-3B (32 layers, bf16, float32 AdamW state, remat) at
#   B 2 x S 4096 (``train_4k``'s sequence, the global batch of 256 cut to
#   2 for one card) and Mamba2-370m (48 layers, bf16) at B 4 x L 2048.
TRAIN = dict(
    parity={"stablelm_3b": dict(layers=2, batch=2, seq=1024),
            "mamba2_370m": dict(layers=2, batch=2, seq=512)},
    example=dict(steps=300, batch=8, seq=128, lr=3e-4, seed=0),
    serve=dict(slots=8, partial=4, prompt=64, steps=32, max_len=256),
    whole={"stablelm_3b": dict(batch=2, seq=4096, steps=4),
           "mamba2_370m": dict(batch=4, seq=2048, steps=4)})
#: float32 parity bounds of "fused" against "ref": the loss relative,
#: each gradient leaf against its own largest |gradient| (the CPU tests
#: measure at most 3.7e-5 of it on reduced Mamba2-370m)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
#: where the example's checkpoint is written (gitignored), and removed
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "train_ckpt"


def all_kernels() -> tuple:
    """Every hand-written kernel's wrapper (each counts its launches)."""
    from repro_torch.kernels.routing_decide import (routing_attain,
                                                    routing_guard,
                                                    routing_topk)
    from repro_torch.kernels.routing_score import routing_score
    return attention_kernels() + (ssd_kernel(), ssd_step_kernel(),
                                  *mixer_kernels(), routing_score,
                                  routing_guard, routing_topk,
                                  routing_attain)


def example_config():
    """``examples/train_small.py``'s ~100M-parameter model."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("stablelm_3b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, head_dim=64, d_ff=1536, vocab_size=32768,
        dtype="float32", remat=False)


def train_batches(cfg, batch: int, seq: int, seed: int = 0):
    from repro_torch.training.data import DataConfig, SyntheticText
    return iter(SyntheticText(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, batch_size=batch,
                                         seed=seed)))


def train_parity(dev, arch: str, layers: int, batch: int, seq: int) -> dict:
    """Loss and gradients of ``arch`` at full width, ``layers`` deep, in
    float32 under kernels="fused" against "ref" on one SyntheticText
    batch; no hand-written kernel may launch in either run."""
    from repro_torch.models import model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    cfg = dataclasses.replace(full_width(arch, "float32"), n_layers=layers)
    params = model.init_params(cfg, seed=0, device=dev)
    data = next(train_batches(cfg, batch, seq))
    out, seconds = {}, {}
    for kernels in ("fused", "ref"):
        (loss, extras, grads), secs, counts = counted(
            lambda: train.value_and_grad(params, cfg, data, kernels),
            all_kernels(), dev)
        if any(counts.values()):
            fail(f"train parity {arch}/{kernels}: a hand-written kernel "
                 f"launched {counts}")
        out[kernels], seconds[kernels] = (loss, grads), secs
    (loss_f, grads_f), (loss_r, grads_r) = out["fused"], out["ref"]
    loss_rel = abs(float(loss_f) / float(loss_r) - 1)
    worst, worst_leaf = 0.0, None
    for i, (a, b) in enumerate(zip(opt.leaves(grads_f),
                                   opt.leaves(grads_r))):
        if not bool(a.isfinite().all()):
            fail(f"train parity {arch}: gradient leaf {i} not finite")
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_leaf = rel, i
    row = {"phase": "train_parity", "arch": cfg.name, "layers": layers,
           "batch": batch, "seq": seq, "loss_fused": float(loss_f),
           "loss_ref": float(loss_r), "loss_rel": loss_rel,
           "loss_bound": TRAIN_LOSS_REL, "grad_worst_rel_to_max": worst,
           "grad_worst_leaf": worst_leaf, "grad_bound": TRAIN_GRAD_REL,
           "leaves": len(opt.leaves(grads_f)),
           "seconds_fused": seconds["fused"], "seconds_ref": seconds["ref"],
           "hand_kernel_launches": 0}
    emit(row)
    if loss_rel > TRAIN_LOSS_REL or worst > TRAIN_GRAD_REL:
        fail(f"train parity {arch}: loss rel {loss_rel}, gradient "
             f"{worst} of its leaf's max (bounds {TRAIN_LOSS_REL}, "
             f"{TRAIN_GRAD_REL})")
    return row


def train_example(dev, steps: int, batch: int, seq: int, lr: float,
                  seed: int) -> tuple:
    """``examples/train_small.py`` on the card under kernels="fused":
    ``steps`` AdamW steps, the first-20 and last-20 mean loss, which must
    fall by more than 0.2 (the example's "LEARNING"). Returns (cfg,
    trained params, the data stream)."""
    from repro_torch.models import model
    from repro_torch.training import train
    cfg = example_config()
    state = train.make_train_state(cfg, seed=seed, lr=lr,
                                   total_steps=steps, device=dev)
    step = train.make_functional_step(cfg, state.opt_cfg, kernels="fused")
    data = train_batches(cfg, batch, seq, seed)
    params, opt_state = state.params, state.opt_state
    losses, step_ms = [], []
    start = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, next(data))
        losses.append(float(metrics["loss"]))          # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    first, last = statistics.fmean(losses[:20]), statistics.fmean(losses[-20:])
    emit({"phase": "train_example", "arch": cfg.name,
          "params": model.param_count(cfg), "steps": steps, "batch": batch,
          "seq": seq, "kernels": "fused", "first20_loss": first,
          "last20_loss": last, "learning": last < first - 0.2,
          "step_ms_median": statistics.median(step_ms[1:]),
          "first_step_ms": step_ms[0],
          "tokens_per_s": batch * seq * 1e3 / statistics.median(step_ms[1:]),
          "loss_every_25": losses[::25] + [losses[-1]],
          "seconds": time.perf_counter() - start})
    if not last < first - 0.2:
        fail(f"train example: last-20 loss {last} not below first-20 "
             f"{first} - 0.2")
    return cfg, params, data


def train_serve(dev, cfg, params, data, slots: int, partial: int,
                prompt: int, steps: int, max_len: int) -> dict:
    """The trained params through the port's checkpoint (saved, restored
    into a fresh tree, equal bit for bit), then served in float32 by
    ``ServingEngine`` under kernels="cuda" and "ref" on both slot paths:
    greedy tokens equal, the hand-written kernels' wrappers called
    exactly as ``engine_launch_calls`` says."""
    import shutil

    import torch
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    from repro_torch.training import checkpoint
    from repro_torch.training import optimizer as opt
    start = time.perf_counter()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = checkpoint.save(params, str(TRAIN_CKPT), step=300)
        save_s = time.perf_counter() - t0
        restored = checkpoint.restore(model.init_params(cfg, seed=1,
                                                        device=dev),
                                      str(TRAIN_CKPT))
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(opt.leaves(params), opt.leaves(restored)))
    if not same:
        fail("train serve: the restored checkpoint differs from the "
             "trained params")
    counters = path_kernels(cfg)
    want = engine_launch_calls(cfg, steps)
    tokens = torch.as_tensor(next(data)["tokens"][:, :prompt], device=dev)
    out = {"launches": {k.__name__: 0 for k in counters}}
    for label, b in (("b_eq_slots", slots), ("b_lt_slots", partial)):
        runs, launched = {}, {}
        for kernels in ("cuda", "ref"):
            eng = ServingEngine(cfg, restored, slots=slots, max_len=max_len,
                                device=dev, kernels=kernels)
            res, secs, counts = counted(
                lambda: eng.generate(tokens[:b], steps=steps), counters,
                dev)
            if kernels == "cuda":
                if counts != want:
                    fail(f"train serve {label}: launches {counts}, "
                         f"expected {want}")
                launched = counts
                for k, c in counts.items():
                    out["launches"][k] += c
            runs[kernels] = res.tokens
        equal = bool((runs["cuda"] == runs["ref"]).all())
        emit({"phase": "train_serve", "cell": label, "batch": b,
              "prompt": prompt, "steps": steps, "tokens_equal": equal,
              "launches": launched, "expected": want,
              "checkpoint_bytes": nbytes, "save_s": save_s,
              "restored_bit_equal": same,
              "seconds": time.perf_counter() - start})
        if not equal:
            rows = np.nonzero((runs["cuda"] != runs["ref"]).any(1))[0]
            fail(f"train serve {label}: greedy tokens differ in rows "
                 f"{rows.tolist()}")
    return out


def train_whole(dev, arch: str, batch: int, seq: int, steps: int) -> dict:
    """``arch`` whole at its published width and dtype (remat as
    configured), AdamW state in ``opt_state_dtype``: ``steps`` steps
    under kernels="fused", the first a warm step, the last profiled on
    the device. Loss per step, step wall ms (the steps between),
    tokens/s, peak memory; loss finite and params moved; kernels="cuda"
    refused."""
    import torch
    from repro_torch.models import model
    from repro_torch.training import train
    from repro_torch.configs import get_config
    cfg = full_width(arch, get_config(arch).dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = train.make_train_state(cfg, seed=0, device=dev)
    probe = [state.params["layers"][0]["norm1"]["scale"],
             state.params["layers"][-1]["norm1"]["scale"],
             state.params["final_norm"]["scale"]]
    probe = [p.clone() for p in probe]
    step = train.make_functional_step(cfg, state.opt_cfg, kernels="fused")
    data = train_batches(cfg, batch, seq)
    params, opt_state, ocfg = state.params, state.opt_state, state.opt_cfg
    del state
    losses, step_ms = [], []

    def one():
        nonlocal params, opt_state
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, next(data))
        losses.append(float(metrics["loss"]))          # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)

    t0 = time.perf_counter()
    for _ in range(steps - 1):
        one()
    prof = profile_call(one, dev, f"train/{arch}/B{batch}xS{seq}",
                        warm=False, host_ops=False)
    after = [params["layers"][0]["norm1"]["scale"],
             params["layers"][-1]["norm1"]["scale"],
             params["final_norm"]["scale"]]
    moved = [not torch.equal(a, b) for a, b in zip(probe, after)]
    refused = False
    try:
        train.train_step(train.TrainState(params, opt_state, ocfg), cfg,
                         next(data), kernels="cuda")
    except ValueError:
        refused = True
    timed = step_ms[1:steps - 1]
    row = {"phase": "train_whole", "arch": cfg.name, "dtype": cfg.dtype,
           "opt_state_dtype": cfg.opt_state_dtype, "remat": cfg.remat,
           "n_layers": cfg.n_layers, "params": model.param_count(cfg),
           "batch": batch, "seq": seq, "losses": losses,
           "step_ms": statistics.median(timed), "step_ms_all": step_ms,
           "tokens_per_s": batch * seq * 1e3 / statistics.median(timed),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if dev.type == "cuda" else None,
           "profiled_wall_ms": prof["wall_ms"],
           "device_busy_ms": prof["device_busy_ms"],
           "idle_share": prof["idle_share"], "params_moved": moved,
           "cuda_refused": refused, "seconds": time.perf_counter() - t0}
    emit(row)
    if not all(np.isfinite(losses)):
        fail(f"train whole {arch}: loss not finite {losses}")
    if not any(moved):
        fail(f"train whole {arch}: params did not move")
    if not refused:
        fail(f"train whole {arch}: kernels='cuda' was not refused")
    return row


def phase_train(dev, spec=TRAIN) -> dict:
    """(a) float32 parity of the fused path against the plain one at full
    width; (b) the reference's training example on the card; (c) its
    checkpoint restored and served through the hand-written kernels; (d)
    StableLM-3B and Mamba2-370m trained whole. Returns the serve
    launches and the rows of (a) and (d)."""
    import torch
    out = {"parity": [train_parity(dev, arch, **kw)
                      for arch, kw in spec["parity"].items()]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg, params, data = train_example(dev, **spec["example"])
    out["serve"] = train_serve(dev, cfg, params, data, **spec["serve"])
    del params
    out["whole"] = []
    for arch, kw in spec["whole"].items():
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["whole"].append(train_whole(dev, arch, **kw))
    return out



# ------------------------------------------------ checkouts in turns --
# ----------------------------------------------------------- phase 15 ----
# tests/test_jaxsim.py SMOKE_CELLS: (scenario, admission window, policy,
# pods); the policy is ignored at window 0 (the scalar Algorithm-1 path)
TWIN_CELLS = [
    ("poisson", 0.0, "route_best", 1),
    ("flash", 0.0, "route_best", 2),
    ("mmpp", 0.1, "route_best", 1),
    ("poisson", 0.1, "route_best", 2),
    ("diurnal", 0.1, "guarded_alg1", 1),
    ("bursts", 0.1, "guarded_alg1", 2),
    ("mixed", 0.1, "guarded_alg1", 1),
]
# the card's twin against the CPU twin, sample for sample: the same
# float32 step on two devices, whose pow and Erlang recurrence may round
# apart by a few ulps (the same bound holds the CPU twin to the JAX twin)
TWIN_TRACE_RTOL = 1e-5
TWIN_LAM = 2000.0                  # bench_sim_throughput's --lam default
TWIN_ARRIVALS = 1_000_000          # and its --arrivals default
TWIN_GUARDED_ARRIVALS = 200_000
TWIN_PROFILE_ARRIVALS = 20_000


def twin_scenario(name: str):
    """The port's twin of ``tests/test_sim_golden.py``'s ``scenario``:
    (cluster, trace) built with the port's catalogue and generators."""
    from repro_torch.core import workload as wl
    from repro_torch.core.catalogue import paper_cluster
    if name == "poisson":
        return golden_two_tier(), wl.poisson_arrivals(4.0, 60.0, "yolov5m",
                                                      seed=5)
    if name == "bursts":
        return golden_two_tier(), wl.bounded_pareto_bursts(
            2.0, 60.0, "yolov5m", seed=5)
    if name == "diurnal":
        return golden_two_tier(), wl.diurnal_arrivals(
            3.0, 90.0, "yolov5m", seed=5, amplitude=0.9, period=45.0)
    if name == "mmpp":
        return golden_two_tier(), wl.mmpp_arrivals(
            [1.0, 8.0], 10.0, 80.0, "yolov5m", seed=5)
    if name == "flash":
        return golden_two_tier(), wl.flash_crowd_arrivals(
            1.0, 12.0, 90.0, "yolov5m", seed=5, t_start=30.0,
            duration=20.0, ramp=5.0)
    if name == "mixed":
        return paper_cluster(), wl.mixed_traffic(
            {"efficientdet": 4.0, "yolov5m": 2.0, "faster_rcnn": 0.5},
            60.0, seed=5)
    raise KeyError(name)


def fleet_cluster(n_edge: int = 16, n_cloud: int = 16):
    """``benchmarks/bench_sim_throughput.py``'s ``fleet_cluster``, built
    from the port's catalogue: two candidates of 16 replicas each,
    ``n_max`` 64."""
    from repro_torch.core.catalogue import Cluster, Deployment
    from repro_torch.core.latency_model import CLOUD, PI4_EDGE, YOLOV5M
    from repro_torch.core.scheduler import QualityClass
    edge = dataclasses.replace(PI4_EDGE, net_rtt=0.05, speedup=100.0,
                               r_max=300.0)
    cloud = dataclasses.replace(CLOUD, net_rtt=0.086, r_max=19000.0,
                                speedup=400.0)
    return Cluster([
        Deployment(YOLOV5M, edge, QualityClass.BALANCED,
                   n_replicas=n_edge, n_max=4 * n_edge),
        Deployment(YOLOV5M, cloud, QualityClass.BALANCED,
                   n_replicas=n_cloud, n_max=4 * n_cloud),
    ])


def fleet_flash_trace(n_arrivals: int, lam: float = TWIN_LAM,
                      seed: int = 0):
    """``bench_sim_throughput.make_trace("flash", ...)``: base lam / 2, a
    surge to 2 lam over the middle fifth of the horizon."""
    from repro_torch.core.workload import flash_crowd_arrivals
    horizon = max(n_arrivals / lam, 1.0)
    return flash_crowd_arrivals(lam * 0.5, lam * 2.0, horizon, "yolov5m",
                                seed=seed, t_start=horizon * 0.4,
                                duration=horizon * 0.2,
                                ramp=horizon * 0.02)


def sync_all() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def sim_run(cluster, cfg, arr, stats=None):
    """One simulator run through ``ClusterSimulator.run``, timed to its
    end on the card; with ``stats`` the bucketed twin goes through
    ``jaxsim.simulate`` (what ``run`` calls) to collect them."""
    from repro_torch.core import jaxsim
    from repro_torch.core.simulator import ClusterSimulator
    sync_all()
    t0 = time.perf_counter()
    if stats is not None and cfg.backend == "jax":
        res = jaxsim.simulate(cluster, cfg, arr, stats=stats)
    else:
        res = ClusterSimulator(cluster, cfg).run(arr)
    sync_all()
    return res, time.perf_counter() - t0


def conserved(res, n: int) -> bool:
    if res.backend == "jax":
        return res.n_arrivals == n and res.latency_trace.size == n \
            and res.failed_count() == 0
    return len(res.completed) + len(res.failed) == n


def tolerance_gaps(label: str, oracle, twin, n: int) -> dict:
    """The twin against the event loop by ``jaxsim.TOLERANCES``; fails
    the run on a violation or a lost arrival."""
    from repro_torch.core.jaxsim import TOLERANCES
    if not conserved(oracle, n) or not conserved(twin, n):
        fail(f"twin {label}: arrivals not conserved")
    gaps = {}
    for q, tol in ((50.0, TOLERANCES["p50_rel"]),
                   (99.0, TOLERANCES["p99_rel"])):
        ref, got = oracle.percentile(q), twin.percentile(q)
        gaps[f"p{q:.0f}_rel"] = abs(got - ref) / ref
        if not gaps[f"p{q:.0f}_rel"] <= tol:
            fail(f"twin {label}: P{q:.0f} {got} vs event loop {ref}")
    gaps["offload_abs"] = abs(twin.offload_fast - oracle.offload_fast) / n
    if gaps["offload_abs"] > TOLERANCES["offload_abs"]:
        fail(f"twin {label}: offload {twin.offload_fast} vs "
             f"{oracle.offload_fast} of {n}")
    return gaps


def replay_ms(stats: dict):
    """Device time from the first graph replay to the end of the last
    (None where the twin ran eagerly)."""
    span = stats.get("replay_events")
    return span[0].elapsed_time(span[1]) if span else None


def twin_profile(cluster, cfg, arr) -> dict:
    """``torch.profiler`` over one twin run: the device work that starts
    after the first graph launch (the replays; the warm-up and capture
    come before it), its ops per bucket, and its kernel time against
    the replays' device span, profiled and in an unprofiled run of the
    same trace (the profiler stretches the gaps between the replays'
    small kernels). The record counts as complete only when the device
    work it holds spans the profiled replays' own span (CUDA events)
    within 10%; otherwise the derived numbers are null."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    stats = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim_run(cluster, cfg, arr, stats)
    events = prof.events()
    launches = [ev.time_range.start for ev in events
                if ev.name == "cudaGraphLaunch"]
    dev_ev = [ev for ev in events
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and launches and ev.time_range.start >= min(launches)]
    plain = {}
    sim_run(cluster, cfg, arr, plain)
    out = {"buckets": stats["buckets"], "graph_launches": len(launches),
           "replay_device_ms": replay_ms(plain),
           "profiled_replay_device_ms": replay_ms(stats),
           "device_ops": len(dev_ev), "profiled_span_ms": None,
           "complete": False, "ops_per_bucket": None, "busy_ms": None,
           "busy_share": None, "idle_share": None}
    if dev_ev:
        busy = sum(ev.time_range.elapsed_us() for ev in dev_ev) / 1e3
        span = (max(ev.time_range.end for ev in dev_ev)
                - min(ev.time_range.start for ev in dev_ev)) / 1e3
        out["profiled_span_ms"] = span
        want = out["profiled_replay_device_ms"]
        if want and abs(span - want) <= 0.1 * want:
            share = busy / out["replay_device_ms"]
            out.update(complete=True,
                       ops_per_bucket=len(dev_ev) / stats["buckets"],
                       busy_ms=busy, profiled_busy_share=busy / span,
                       busy_share=share, idle_share=1.0 - share)
    return out


def twin_profile_child(n_profile: int) -> int:
    """``--twin-profile N``: :func:`twin_profile` of the fleet flash trace
    at N requested arrivals, in a process of its own (a profiler that
    earlier phases of the same process used recorded only part of the
    replays), printed as one JSON line."""
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.core.simulator import SimConfig
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = SimConfig(mode="laimr", seed=0, backend="jax",
                    twin_device=str(dev))
    arr = fleet_flash_trace(n_profile)
    emit({"requested": n_profile, "arrivals": len(arr),
          **twin_profile(fleet_cluster(), cfg, arr)})
    return 0


def twin_graph_widths(cluster, cfg, arr, widths=(0, 1, 16)) -> dict:
    """The twin's wall time on one trace, eager on the card
    (``graph_buckets`` 0) and with graphs of 1 and 16 buckets: host
    clock to the end of the run, and the replays' device span."""
    from repro_torch.core import jaxsim
    out = {}
    for k in widths + widths[::-1]:
        stats = {}
        sync_all()
        t0 = time.perf_counter()
        jaxsim.simulate(cluster, cfg, arr, graph_buckets=k, stats=stats)
        sync_all()
        row = out.setdefault(str(k), {"wall_s": [], "replay_device_ms": []})
        row["wall_s"].append(time.perf_counter() - t0)
        row["replay_device_ms"].append(replay_ms(stats))
    return out


def phase_twin(dev, smi: str, cells=TWIN_CELLS,
               n_big: int = TWIN_ARRIVALS,
               n_guarded: int = TWIN_GUARDED_ARRIVALS,
               n_profile: int = TWIN_PROFILE_ARRIVALS) -> dict:
    """The bucketed twin (``SimConfig.backend="jax"``) on the card: the
    seven smoke cells against the CPU twin and the event loop; the
    1M-arrival flash trace of ``bench_sim_throughput.py`` on its fleet
    cluster (scalar Algorithm 1) against the event loop; ``guarded_alg1``
    at a 0.1 s window on the same scenario at ``n_guarded`` arrivals; a
    profiled run of ``n_profile`` arrivals for ops per bucket and the
    device's busy and idle share over the replays."""
    from repro_torch.core.jaxsim import GRAPH_BUCKETS
    from repro_torch.core.simulator import SimConfig
    # (a) the smoke cells
    worst = {"trace_rel": 0.0}
    for name, window, policy, pods in cells:
        label = f"{name}/w{window}/{policy}/pods{pods}"
        runs = {}
        for key, backend, device in (("cuda", "jax", str(dev)),
                                     ("cpu", "jax", "cpu"),
                                     ("event", "event", "cpu")):
            cluster, arr = twin_scenario(name)
            cfg = SimConfig(mode="laimr", seed=5, slo=1.8, jitter_sigma=0.2,
                            admission_window=window, policy=policy,
                            pods_per_deployment=pods, backend=backend,
                            twin_device=device, admission_device=str(dev))
            runs[key] = sim_run(cluster, cfg, arr)[0]
        n = len(arr)
        got, cpu = runs["cuda"], runs["cpu"]
        if got.n_arrivals != n or cpu.n_arrivals != n \
                or got.latency_trace.size != n:
            fail(f"twin {label}: n_arrivals {got.n_arrivals} / "
                 f"{cpu.n_arrivals} of {n}")
        rel = float(np.max(np.abs(got.latency_trace - cpu.latency_trace)
                           / np.abs(cpu.latency_trace)))
        if not rel <= TWIN_TRACE_RTOL or got.offload_fast != cpu.offload_fast:
            fail(f"twin {label}: card vs CPU trace rel {rel}, offload "
                 f"{got.offload_fast} vs {cpu.offload_fast}")
        gaps = tolerance_gaps(label, runs["event"], got, n)
        worst["trace_rel"] = max(worst["trace_rel"], rel)
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
        emit({"phase": "twin_cell", "cell": label, "arrivals": n,
              "trace_rel_vs_cpu": rel, "offload_fast": got.offload_fast,
              "p50": got.percentile(50.0), "p99": got.percentile(99.0),
              "vs_event": gaps})
    emit({"phase": "twin_cells", "cells": len(cells), "worst": worst,
          "trace_rtol": TWIN_TRACE_RTOL})

    # (b) the bench's own 1M-arrival flash run, then guarded_alg1
    out = {}
    for label, size, kw in (
            ("flash_scalar", n_big, {}),
            ("flash_guarded_w0.1", n_guarded,
             dict(admission_window=0.1, policy="guarded_alg1"))):
        arr = fleet_flash_trace(size)
        n = len(arr)
        rows = {}
        for backend in ("jax", "event"):
            cfg = SimConfig(mode="laimr", seed=0, backend=backend,
                            twin_device=str(dev), admission_device=str(dev),
                            **kw)
            stats = {}
            res, seconds = sim_run(fleet_cluster(), cfg, arr, stats)
            rows[backend] = (res, seconds, stats)
        (twin, t_twin, stats), (oracle, t_event, _) = rows["jax"], \
            rows["event"]
        gaps = tolerance_gaps(label, oracle, twin, n)
        row = {"phase": "twin_run", "cell": label, "requested": size,
               "arrivals": n,
               "buckets": stats["buckets"],
               "graph_buckets": stats.get("graph_buckets"),
               "graphs": stats.get("graphs"),
               "replays": stats.get("replays"),
               "replay_device_ms": replay_ms(stats),
               "twin_wall_s": t_twin, "twin_arrivals_per_s": n / t_twin,
               "event_wall_s": t_event, "event_arrivals_per_s": n / t_event,
               "speedup": t_event / t_twin,
               "twin_p50": twin.percentile(50.0),
               "twin_p99": twin.percentile(99.0),
               "event_p50": oracle.percentile(50.0),
               "event_p99": oracle.percentile(99.0),
               "twin_offload_rate": twin.offload_fast / n,
               "event_offload_rate": oracle.offload_fast / n,
               "vs_event": gaps, "card": smi}
        emit(row)
        out[label] = row

    # (c) one profiled run in a process of its own: ops per bucket, busy
    # and idle share; then the profiled trace eager on the card and with
    # graphs of 1 and 16 buckets, and the 1M trace with graphs of 1 and 16
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--twin-profile",
         str(n_profile)], capture_output=True, text=True, check=True)
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    emit({"phase": "twin_profile", "graph_buckets": GRAPH_BUCKETS,
          "card": smi, **prof})
    out["profile"] = prof
    cfg = SimConfig(mode="laimr", seed=0, backend="jax",
                    twin_device=str(dev))
    for size, widths in ((n_profile, (0, 1, 16)), (n_big, (1, 16))):
        arr = fleet_flash_trace(size)
        emit({"phase": "twin_graph_widths", "requested": size,
              "arrivals": len(arr), "card": smi,
              "by_graph_buckets": twin_graph_widths(fleet_cluster(), cfg,
                                                    arr, widths)})
    return out


def phase_tree(dev) -> None:
    """The routing path of the checkout whose ``src`` is first on the
    path, measured by this file's phases: each routing kernel's device
    time, host time (``host_ms``: back to back; ``call_host_ms``: the
    wrapper's own per call, the device kept busy) at every shape of
    :func:`phase_times`, and ``BatchRouter``'s decisions/s under every
    policy on both clusters (:func:`phase_serving`)."""
    phase_times(dev)
    phase_serving(dev, "cuda")


# ------------------------------------------ the launch layer: phases 19-21 --
DRYRUN_DIR = Path(__file__).resolve().parent / "results" / "dryrun_torch"
#: the dry run's combinations: every arch's served decode step on the
#: single-pod mesh (the H100 catalogue reads these), and a multi-pod
#: training step
DRYRUN_RUNS = (("all", "decode_32k", "single"),
               ("stablelm_3b", "train_4k", "multi"))
DRYRUN_JOBS = 3            # child processes at a time (CPU work, meta)
DRYRUN_DEVICE = "cuda"     # the meshes' device type
DRYRUN_TIMEOUT = 600


def start_dryrun(out: Path = DRYRUN_DIR):
    """Start the port's dry run (``repro_torch.launch.dryrun``, one child
    process; it runs each combination in a process of its own) over
    ``DRYRUN_RUNS``, the meshes' device type ``DRYRUN_DEVICE``. It is
    CPU work on meta tensors, so it runs beside the card's phases;
    returns the ``Popen``."""
    out.mkdir(parents=True, exist_ok=True)
    argvs = [["--device", DRYRUN_DEVICE, "--arch", a, "--shape", s,
              "--mesh", m, "--out", str(out), "--force",
              "--jobs", str(DRYRUN_JOBS)] for a, s, m in DRYRUN_RUNS]
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    dryrun.main(argv)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(argvs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_dryrun(proc, out: Path = DRYRUN_DIR) -> dict:
    """Wait for :func:`start_dryrun`'s child and read its records: every
    one must be ``ok`` (10 decode_32k/single, StableLM-3B
    train_4k/multi on 512 ranks). Per-device figures are accounting on
    meta tensors, not measurements."""
    from repro_torch.configs.base import REFERENCE_IDS
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dry run: over {DRYRUN_TIMEOUT} s")
    if proc.returncode:
        fail(f"dry run: exit {proc.returncode}: {stderr[-2000:]}")
    want = [(a, "decode_32k", "single") for a in REFERENCE_IDS] \
        + [("stablelm_3b", "train_4k", "multi")]
    recs = {}
    for arch, shape, mesh_kind in want:
        path = out / f"{arch}__{shape}__{mesh_kind}.json"
        if not path.is_file():
            fail(f"dry run: no record {path.name}")
        rec = json.loads(path.read_text())
        emit({"phase": "dryrun", "arch": arch, "shape": shape,
              "mesh": mesh_kind, "status": rec["status"],
              "n_devices": rec.get("n_devices"),
              "gflops_per_device": rec.get("flops", 0) / 1e9,
              "hbm_gb_per_device": rec.get("hlo_bytes", 0) / 1e9,
              "collective_gb_per_device":
                  rec.get("collective_bytes_total", 0) / 1e9,
              "argument_gb_per_device":
                  rec.get("memory", {}).get("argument_bytes", 0) / 1e9,
              "wall_s": rec.get("wall_s"),
              "error": rec.get("error", "")[:300]})
        if rec["status"] != "ok":
            fail(f"dry run {arch}/{shape}/{mesh_kind}: {rec['status']} "
                 f"{rec.get('error', '')[:300]}")
        recs[(arch, shape, mesh_kind)] = rec
    train = recs[("stablelm_3b", "train_4k", "multi")]
    if train["n_devices"] != 512 or train["collective_bytes_total"] <= 1e9:
        fail(f"dry run train_4k/multi: {train['n_devices']} devices, "
             f"{train['collective_bytes_total']} collective bytes")
    return recs


def fleet_route(cluster, policy: str, dev, backend: str):
    """``examples/route_h100_fleet.py``'s 12 requests (4 per lane) in one
    admission window: (decisions, flushes)."""
    from repro_torch.core.router import RouterParams
    from repro_torch.core.scheduler import QualityClass, Request
    from repro_torch.serving import AdmissionConfig, BatchRouter
    br = BatchRouter(cluster, params=RouterParams(x=3.0),
                     config=AdmissionConfig(max_batch=12, backend=backend,
                                            device=str(dev), policy=policy))
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for q in QualityClass:
        for _ in range(4):
            t += float(rng.exponential(0.05))
            reqs.append(Request(model="any", quality=q, arrival=t, slo=2.0))
    out = []
    for rq in reqs:
        out.extend(br.submit(rq, rq.arrival) or [])
    out.extend(br.flush(t))
    br.check_conservation()
    return [(d.req.quality.name, d.target_key, d.outcome,
             float(d.predicted_latency)) for d in out], br.flushes


def fleet_sim(cluster, policy: str, dev, backend: str):
    """The example's burst trace through the simulator in 0.1 s windows:
    (n, P50, P99, offloads, scale events, flushes)."""
    from repro_torch.core import (ClusterSimulator, SimConfig,
                                  bounded_pareto_bursts)
    arr = bounded_pareto_bursts(8.0, 180.0, "stablelm_3b", seed=1)
    sim = ClusterSimulator(cluster, SimConfig(
        mode="laimr", seed=1, slo=2.0, admission_window=0.1, policy=policy,
        admission_backend=backend, admission_device=str(dev)))
    res = sim.run(arr)
    if len(res.completed) + len(res.failed) != len(arr):
        fail(f"fleet sim {policy}/{backend}: arrivals not conserved")
    s = res.summary()
    return (int(s["n"]), s["p50"], s["p99"], res.offload_fast,
            len(res.scale_events)), sim.plane.flushes


def fleet_equal(label: str, got, want) -> bool:
    """Routes: every decision's lane, target and outcome equal, its
    predicted latency within ``G_RTOL`` (the kernels' g bound). Simulated
    runs: n, P50, P99, offloads and scale events equal."""
    if label == "sim":
        return got == want
    return len(got) == len(want) and all(
        g[:3] == w[:3] and abs(g[3] - w[3]) <= G_RTOL * abs(w[3])
        for g, w in zip(got, want))


def phase_fleet(dev, out: Path = DRYRUN_DIR) -> dict:
    """``h100_catalogue`` from the dry run's records: every tier's lane,
    L_m and mu; then the fleet's requests routed and its burst trace
    simulated under every policy through ``backend="cuda"``, each held
    to the plain route (``backend="ref"`` on the card): decisions, P50 /
    P99 and offloads equal (:func:`fleet_equal`). Launch counters are
    set to 0 just before each cuda run and read just after: one launch
    per admission window, of the policy's kernel (``hybrid``: its guard,
    or topk in a burst)."""
    from repro_torch.core.catalogue import h100_catalogue
    from repro_torch.kernels.routing_decide import (routing_attain,
                                                    routing_guard,
                                                    routing_topk)
    from repro_torch.kernels.routing_score import routing_score
    kernels = (routing_score, routing_guard, routing_topk, routing_attain)
    cluster = h100_catalogue(str(out))
    for d in cluster:
        emit({"phase": "fleet_tier", "key": d.key,
              "lane": d.quality.name, "l_m_ms": d.model.l_ref * 1e3,
              "mu": d.mu})
    launches = {k.__name__: 0 for k in kernels}
    for policy in POLICIES:
        row = {"phase": "fleet", "policy": policy}
        for label, run in (("route", fleet_route), ("sim", fleet_sim)):
            want, _ = run(cluster, policy, dev, "ref")
            for k in kernels:
                k.launches = 0
            sync(dev)
            got, flushes = run(cluster, policy, dev, "cuda")
            sync(dev)
            counts = {k.__name__: k.launches for k in kernels}
            if not fleet_equal(label, got, want):
                fail(f"fleet {label}/{policy}: cuda {got} against the "
                     f"plain route {want}")
            # one launch a window: hybrid's guard or, in a burst, topk
            path = ("routing_guard", "routing_topk") \
                if policy == "hybrid" else POLICY_KERNELS[policy]
            if any(counts[k] == 0 for k in POLICY_KERNELS[policy]) \
                    or sum(counts[k] for k in path) != flushes \
                    or sum(counts.values()) != flushes:
                fail(f"fleet {label}/{policy}: launches {counts} in "
                     f"{flushes} windows")
            for k, c in counts.items():
                launches[k] += c
            row[label] = {"launches": counts, "windows": flushes}
            if label == "sim":
                row[label].update(zip(("n", "p50", "p99", "offloads",
                                       "scale_events"), got))
            else:
                row[label]["targets"] = sorted({d[1] for d in got
                                                if d[1] is not None})
        emit(row)
    return launches


#: the served shapes of phases 9 and 13 (``SERVE``, ``MAMBA_SERVE``)
COST_CHECKS = (("stablelm_3b", "SERVE"), ("mamba2_370m", "MAMBA_SERVE"))


def served_costs(cfg, batch: int, prompt: int):
    """``op_analysis`` of the served prefill of ``batch`` x ``prompt``
    tokens and of one decode step against that prefill's ``prompt``-deep
    cache, on one device with meta tensors at the served widths. The
    served path's hand-written kernels take no meta tensors, so each is
    stood in for by an op that makes its outputs and adds its own bytes
    and FLOPs (``flash_bytes_ops``, ``decode_bytes_ops``,
    ``ssd_bytes_ops``, ``mixer_bytes_ops``, the kernel table's bounds);
    every other op is counted by the analysis. Returns
    {"prefill", "decode"}: Costs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis, specs
    from repro_torch.models import model
    counter = op_analysis.OpCounter()
    elem = torch.finfo(getattr(torch, cfg.dtype)).bits // 8

    def charge(nbytes_ops):
        counter.costs.bytes += nbytes_ops[0]
        counter.costs.flops += nbytes_ops[1]

    def attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=None, segment_pos=None, impl="cuda"):
        b, sq, h, d = q.shape
        charge(flash_bytes_ops(b, k.shape[1], h, d, elem, hkv=k.shape[2],
                               window=window, sq=sq, causal=causal))
        return torch.empty_like(q)

    def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, *, window=0,
                         softcap=0.0, scale=None, impl="cuda"):
        b, h, d = q.shape
        charge(decode_bytes_ops(b, k_cache.shape[1], h, d, elem,
                                hkv=k_cache.shape[2]))
        return torch.empty_like(q)

    def ssd_scan(x, dt, a, b, c, d_skip, initial_state=None,
                 return_final_state=False, impl="cuda", chunk=64):
        bs, length, h, p = x.shape
        charge(ssd_bytes_ops(bs, length, h, p, b.shape[2], b.shape[3],
                             elem))
        y = torch.empty_like(x)
        if not return_final_state:
            return y
        return y, torch.empty((bs, h, p, b.shape[3]), dtype=torch.float32,
                              device=x.device)
    def ssd_conv_step(u, dt_raw, buf, w, bias, dt_bias, impl="cuda"):
        bs, w1, ch = buf.shape
        charge(mixer_bytes_ops("conv", b=bs, c=ch, h=dt_bias.shape[0],
                               w=w1 + 1, elem=elem))
        return (torch.empty((bs, ch), dtype=torch.float32, device=u.device),
                torch.empty((bs, dt_bias.shape[0]), dtype=torch.float32,
                            device=u.device))

    def ssd_state_step(h, dt, a_log, x, b, c, d_skip, impl="cuda"):
        bs, heads, hp, n = h.shape
        charge(mixer_bytes_ops("state", b=bs, h=heads, g=b.shape[1], p=hp,
                               n=n))
        return torch.empty((bs, heads, hp), dtype=torch.float32,
                           device=h.device)

    def ssd_gated_norm(y, z, scale, groups, gate_first, eps, impl="cuda"):
        charge(mixer_bytes_ops("norm", b=y.shape[0], d=y.shape[1],
                               elem=elem))
        return torch.empty(y.shape, dtype=z.dtype, device=y.device)
    params = model.init_params(cfg, device="meta")
    names = ("attention", "decode_attention", "ssd_scan", "ssd_conv_step",
             "ssd_state_step", "ssd_gated_norm")
    saved = {k: getattr(ops, k) for k in names}
    for k, fn in zip(names, (attention, decode_attention, ssd_scan,
                             ssd_conv_step, ssd_state_step, ssd_gated_norm)):
        setattr(ops, k, fn)
    out = {}
    try:
        with counter:
            model.prefill(params, cfg, {"tokens": specs.sds(
                (batch, prompt), torch.int32)}, kernels="cuda")
        out["prefill"], counter.costs = counter.costs, op_analysis.Costs()
        cache = model.init_cache(cfg, batch, prompt, device="meta")
        with counter:
            model.decode_step(params, cfg, specs.sds((batch,), torch.int32),
                              cache, specs.sds((batch,), torch.int32),
                              kernels="cuda")
        out["decode"] = counter.costs
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)
    return out


def phase_cost_check(served: dict) -> dict:
    """The op analysis against the card: the bound of each served step,
    max(flops / PEAK_FLOPS_BF16, bytes / HBM_BW) from
    :func:`served_costs`, must not exceed the device busy time that the
    same run's ``phase_engine`` profile measured for that step
    (``b_eq_slots``: the prefill of ``slots`` x ``prompt`` tokens and a
    decode step against its ``prompt``-deep ring). A bound above the
    measured time would mean the accounting overcounts."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    rows = {}
    for arch, spec_name in COST_CHECKS:
        spec = globals()[spec_name]
        measured = served[arch]["b_eq_slots"]
        costs = served_costs(full_width(arch, "bfloat16"), spec["slots"],
                             spec["prompt"])
        for step, key in (("prefill", "prefill_busy_ms"),
                          ("decode", "decode_busy_ms")):
            c = costs[step]
            t_ops = c.flops / PEAK_FLOPS_BF16 * 1e3
            t_bytes = c.bytes / HBM_BW * 1e3
            bound = max(t_ops, t_bytes)
            busy = measured[key]
            row = {"phase": "cost_check", "arch": arch, "step": step,
                   "batch": spec["slots"], "prompt": spec["prompt"],
                   "gflops": c.flops / 1e9, "gbytes": c.bytes / 1e9,
                   "bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "busy_ms": busy,
                   "bound_over_busy": None if not busy else bound / busy}
            emit(row)
            if busy is None:
                fail(f"cost check {arch}/{step}: no device busy time")
            if bound > busy:
                fail(f"cost check {arch}/{step}: bound {bound:.3f} ms above "
                     f"the measured busy {busy:.3f} ms: the accounting "
                     "overcounts")
            rows[f"{arch}/{step}"] = row
    return rows


def main_turns(argv: list) -> int:
    """``--twin-profile N``: :func:`twin_profile_child`.
    ``--tree DIR``: :func:`phase_tree` on the checkout at DIR.
    ``--turns DIR [DIR ...] [--rounds N]``: that for each DIR in turn, a
    process each, the order reversed every other round (A B, B A, ...),
    so that checkouts are compared within one call by the same code.
    Each process is pinned to the same CPU core."""
    if argv[0] == "--twin-profile":
        return twin_profile_child(int(argv[1]))
    if argv[0] == "--tree":
        sys.path.insert(0, str(Path(argv[1]).resolve() / "src"))
        # one core, the same for every checkout: host times then spread
        # less between processes
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
        import torch
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_tree(dev)
        return 0
    if argv[0] != "--turns":
        fail(f"unknown arguments {argv}")
    rounds = 1
    if "--rounds" in argv:
        k = argv.index("--rounds")
        rounds = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    trees = argv[1:]
    for n in range(rounds):
        for tree in trees if n % 2 == 0 else trees[::-1]:
            emit({"phase": "turn", "round": n, "tree": tree})
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--tree", tree], check=True)
    return 0


# ------------------------------------------------------------------ main --
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script drives the port on a CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return main_turns(sys.argv[1:])
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
        if name == "ssd":
            emit({"phase": "build", "library": name,
                  "bodies": ssd_bodies(log, _build.library("ssd"))})
        if name == "routing":
            emit({"phase": "build", "library": name,
                  "bodies": routing_bodies(log)})

    # the launch layer's dry run: CPU work on meta tensors in a child
    # process, beside the card's phases; read before phase_fleet
    dryrun_proc = start_dryrun()

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
    phase_prefill_logits(dev, full_width("mamba2_370m", "bfloat16"),
                         batch=MAMBA_SERVE["slots"],
                         prompt=MAMBA_SERVE["prompt"])
    torch.cuda.empty_cache()
    mamba = phase_engine(dev, full_width("mamba2_370m", "bfloat16"),
                         **MAMBA_SERVE)
    torch.cuda.empty_cache()
    ssd_times = phase_ssd_times(dev)
    torch.cuda.empty_cache()
    phase_ssd_wide(dev)
    torch.cuda.empty_cache()
    step_times = phase_ssd_step(dev)
    torch.cuda.empty_cache()
    mixer_times = phase_ssd_mixer(dev)
    torch.cuda.empty_cache()

    # the decoders of slices 6 and 7: RecurrentGemma-2B whole, the dense
    # and MoE configs at full width (parity one period, serving the depth
    # that fits); then Whisper-small whole
    phase_moe_gemm(dev)
    torch.cuda.empty_cache()
    decoders = phase_decoders(dev)
    torch.cuda.empty_cache()
    decoders["whisper_small"] = phase_whisper(dev)
    torch.cuda.empty_cache()

    # NVIDIA-Nemotron-3-Nano whole: the expert kernel, then the served model
    phase_expert_kernel(dev)
    served = phase_nemotron(dev)
    decoders["nemotron_3_nano"] = {"engine": served,
                                   "launches": served["launches"]}
    torch.cuda.empty_cache()
    falcon = phase_falcon(dev)
    decoders["falcon_h1_34b"] = {"engine": falcon,
                                 "launches": falcon["launches"]}
    torch.cuda.empty_cache()

    # the launch layer: the dry run's records, the H100 catalogue that
    # feeds Algorithm 1 through the routing kernels, and the op analysis
    # of the served steps against their measured device time
    phase_dryrun(dryrun_proc)
    fleet = phase_fleet(dev)
    emit({"phase": "launches", "path": "fleet", **fleet})
    phase_cost_check({"stablelm_3b": serving, "mamba2_370m": mamba})

    # the trainer: fused-path parity at full width, the reference's
    # training example, its checkpoint served through the hand-written
    # kernels, StableLM-3B and Mamba2-370m trained whole
    trained = phase_train(dev)
    torch.cuda.empty_cache()

    # the bucketed twin: no hand-written kernel on its path (it routes
    # through the plain torch select/guard), counted all the same
    for k in kernels:
        k.launches = 0
    phase_twin(dev, smi)
    sync(dev)
    emit({"phase": "launches", "path": "twin",
          **{k.__name__: k.launches for k in kernels}})

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
            "launch_floor_ms": times["launch_floor"]["ms"],
        })
    sources = {"flash_attention": "src/repro/kernels/flash_attention.py:84",
               "decode_attention": "src/repro/kernels/decode_attention.py:72"}
    for k in attention_kernels():
        (shape, tm), (shape2, tm2), *others = attn_times[k.__name__].items()
        rows.append({
            "name": k.__name__, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": sources[k.__name__],
            "launches": serving["launches"][k.__name__],
            "max_abs_err": errs[k.__name__], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
            "shape": shape,
            "shape2": shape2, "ms2": tm2["ms"],
            "library_ms2": tm2["library_ms"], "bound_ms2": tm2["bound_ms"],
            # the other decoders' launches and served heads, beside
            # StableLM-3B's above
            "launches_by_arch": {a: row["launches"][k.__name__]
                                 for a, row in decoders.items()
                                 if "launches" in row},
            # serving the trained checkpoint (phase_train)
            "launches_train_serve":
                trained["serve"]["launches"][k.__name__],
            "shapes": {label: {key: row[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err")} for label, row in others}})
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
    tm, nem = step_times["mamba2_370m"], step_times["nemotron_3_nano"]
    rows.append({
        "name": "ssd_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "none: the reference's decode step is plain jnp",
        "launches": mamba["launches"]["ssd_state_step"],
        "max_abs_err": step_times["max_y_err"], "ms": tm["ms"],
        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None,
        "shape": tm["shape"], "nemotron_shape": nem["shape"],
        "nemotron_ms": nem["ms"], "nemotron_plain_ms": nem["plain_ms"],
        "nemotron_bound_ms": nem["bound_ms"],
        "launch_floor_ms": step_times["launch_floor_ms"]})
    for which, wrapper in zip(("conv", "state", "norm"), mixer_kernels()):
        tm, nem = (mixer_times[a][which] for a in MIXER_ARCHS)
        rows.append({
            "name": wrapper.__name__, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "none: the reference's decode step is plain jnp",
            "launches": mamba["launches"][wrapper.__name__],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "shape": tm["shape"],
            "nemotron_shape": nem["shape"], "nemotron_ms": nem["ms"],
            "nemotron_plain_ms": nem["plain_ms"],
            "nemotron_bound_ms": nem["bound_ms"],
            "launch_floor_ms": mixer_times["launch_floor_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
