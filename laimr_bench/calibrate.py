"""Calibrate a served cell's replica and find its knee, on the card.

    python3 laimr_bench/calibrate.py --workload <cell> --seed <n>

Once per cell, when it is defined: the replica's wave time at each
batch size its traffic can form (closed loop, ``--reps`` waves each),
then one sweep of Poisson offered rate around ``slots / wave(slots)``
with admission that never offloads, each point ``--sweep-seconds``
long. The admitted backlog (due and not yet in a wave's prefill) is
averaged over each half of the arrivals (the first full wave left out
of the first), read every 10 ms, so over many wave periods: it grows
where the second half's mean exceeds the first's by more than a quarter
of the requests that fall due in one full wave (a read at one instant
mostly says where in a wave it fell). The knee is the highest rate
whose backlog does not grow. Then, on the requests the last point
served, the widest logit gaps of the program and of the fp8 control
against the float32 reference. One JSON line per reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from laimr_bench import common, replica  # noqa: E402
from laimr_bench.loops import wave_serve  # noqa: E402
from laimr_bench.run import Run  # noqa: E402
from laimr_bench.traffic import generators  # noqa: E402


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def wave_times(st, sizes, reps: int) -> dict:
    eng, dev = st.engine, st.run.device
    out = {}
    for b in sizes:
        rows = st.tokens_in[:b]
        pre, step, wall = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eng.generate(rows, 1)
            t1 = time.perf_counter()
            for _ in range(st.out_len - 1):
                eng.step()
            t2 = time.perf_counter()
            for k in range(b):
                eng.release(k)
            pre.append(t1 - t0)
            step.append((t2 - t1) / max(st.out_len - 1, 1))
            wall.append(t2 - t0)
        out[b] = {"prefill_s": statistics.median(pre),
                  "step_s": statistics.median(step),
                  "wave_s": statistics.median(wall)}
        emit({"phase": "wave", "b": b, **out[b]})
    return out


def backlog(st, t: float) -> int:
    return int(np.count_nonzero(st.arrivals <= t)
               - np.count_nonzero(st.first_t <= t))


def mean_backlog(st, t0: float, t1: float, step: float = 0.01) -> float:
    """The backlog averaged over [t0, t1), read every ``step`` s."""
    grid = np.arange(t0, t1, step)
    due = np.searchsorted(np.sort(st.arrivals), grid, side="right")
    first = np.sort(np.where(np.isnan(st.first_t), np.inf, st.first_t))
    started = np.searchsorted(first, grid, side="right")
    return float(np.mean(due - started))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--factors", default="0.6,0.8,0.95,1.1")
    p.add_argument("--sweep-seconds", type=float, default=20.0)
    args = p.parse_args()
    cell = replica.load("workloads", args.workload)
    conf = replica.load("configs", cell["config"])
    dev = torch.device("cuda", 0)
    run = Run(name=args.workload, cell=cell, conf=conf, seed=args.seed,
              seconds=args.sweep_seconds, trace=False, device=dev)
    t0 = time.time()
    st = wave_serve.Served(run)
    emit({"phase": "setup", "cell": args.workload,
          "seconds": time.time() - t0, "card": common.power_limit(),
          "torch": torch.__version__,
          "memory_bytes": torch.cuda.max_memory_allocated(dev)})
    sizes = sorted({min(st.slots, 1 << j)
                    for j in range(st.slots.bit_length() + 1)})
    st.load(np.zeros(st.slots))
    times = wave_times(st, sizes, args.reps)
    full = times[st.slots]["wave_s"]
    knee = st.slots / full
    emit({"phase": "service", "wave_s": full, "knee_estimate_per_s": knee})
    for f in (float(x) for x in args.factors.split(",")):
        rate = f * knee
        arr = generators.poisson_arrivals(rate, args.sweep_seconds,
                                          seed=args.seed)
        st.load(arr, slo=1e30)
        st.plane = st.make_plane()
        st.window()
        done = ~np.isnan(st.last_t)
        ttft = (st.first_t[done] - arr[done]) * 1e3
        half = args.sweep_seconds / 2
        m1 = mean_backlog(st, full, half)
        m2 = mean_backlog(st, half, args.sweep_seconds)
        emit({"phase": "sweep", "factor": f, "rate_per_s": rate,
              "offered": int(len(arr)), "served": int(done.sum()),
              "ttft_p50_ms": float(np.median(ttft)),
              "ttft_p95_ms": float(np.quantile(ttft, 0.95)),
              "backlog_half": backlog(st, args.sweep_seconds / 2),
              "backlog_end": backlog(st, args.sweep_seconds),
              "backlog_mean_first_half": m1,
              "backlog_mean_second_half": m2,
              "grows": m2 - m1 > 0.25 * rate * full,
              "drain_s": st.t_end - st.t0 - args.sweep_seconds,
              "waves": len(st.waves),
              "mean_wave_b": float(np.mean([w[0] for w in st.waves]))})
        st.waves = []
    st.release()
    t1 = time.time()
    gaps, ctl = wave_serve.logit_gaps(run, st, control=True)
    emit({"phase": "gaps", "tokens": int(gaps.size),
          "program_max": float(gaps.max()),
          "program_p99": float(np.quantile(gaps, 0.99)),
          "program_nonzero": int(np.count_nonzero(gaps)),
          "control_max": float(ctl.max()),
          "control_median": float(np.median(ctl)),
          "control_nonzero": int(np.count_nonzero(ctl)),
          "reference_s": time.time() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
