"""Readings that set a cell's limits: the program's numbers compared,
over many seeds, and the control's, on the card at the cell's own size.

    python3 laimr_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

Per seed, in one process: the cell's set-up and a short window at its
own load, then the check a run makes (the served tokens' widest logit
gap against the float32 reference, every admission decision against the
routing reference) and beside it the control, the reference in the
nearest precision below the configuration's, put in the program's
place: fp8 e4m3 weights for the bf16 model (the gap of the token it
puts first, on the same prompts and tokens), bfloat16 scores for the
float32 routing (its decisions replayed against the float32 ones). The
benchmark's own runs never run the control. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from laimr_bench import replica  # noqa: E402
from laimr_bench.reference import route_ref  # noqa: E402
from laimr_bench.run import Run  # noqa: E402


def route_control(pools: list, policy: str, arrivals, models, adm) -> int:
    """Mismatches of the bfloat16 routing reference, run free, against
    the float32 one."""
    low = route_ref.replay(route_ref.Pools(pools, bf16=True), policy,
                           arrivals, models, adm["window_s"],
                           adm["max_batch"], None, None, None)
    t, o, d = low["decisions"]
    return route_ref.replay(route_ref.Pools(pools), policy, arrivals,
                            models, adm["window_s"], adm["max_batch"],
                            t, o, d)["mismatched"]


def served(run, control: bool) -> dict:
    from laimr_bench.loops import wave_serve
    st = wave_serve.Served(run)
    st.window()
    st.release()
    checks = wave_serve.check_routing(run, st)
    gaps, ctl = wave_serve.logit_gaps(run, st, control=control)
    adm = run.cell["admission"]
    n = len(st.arrivals)
    row = {"served": int(np.count_nonzero(st.outcome == 1)),
           "offloaded": int(np.count_nonzero(st.outcome == 2)),
           "tokens": int(gaps.size),
           "logit_gap": float(gaps.max()),
           "logit_gap_p99": float(np.quantile(gaps, 0.99)),
           "route_mismatched": checks["route_mismatched"]["value"],
           "lines": run.lines[-1]}
    if control:
        row.update(control_logit_gap=float(ctl.max()),
                   control_logit_gap_median=float(np.median(ctl)),
                   control_route_mismatched=route_control(
                       st.pools, adm["policy"], st.arrivals,
                       [st.pools[0]["model"]] * n, adm))
    return row


def fleet(run, control: bool) -> dict:
    from laimr_bench.loops import route_replay
    fl = route_replay.Fleet(run)
    fl.window()
    fl.release()
    checks = route_replay.check_routing(run, fl)
    arr = fl.arrivals()
    models = [fl.models[k % len(fl.models)] for k in range(len(arr))]
    row = {"decided": len(fl.got_target), "outcomes": fl.outcomes,
           "route_mismatched": checks["route_mismatched"]["value"],
           "switches_off_by": checks["switches_off_by"]["value"],
           "lines": run.lines[-1]}
    if control:
        row["control_route_mismatched"] = route_control(
            fl.pools, run.cell["admission"]["policy"], arr, models,
            run.cell["admission"])
    return row


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="the control runs on the first this many seeds")
    args = p.parse_args()
    cell = replica.load("workloads", args.workload)
    conf = replica.load("configs", cell["config"])
    dev = torch.device("cuda", 0)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = Run(name=args.workload, cell=cell, conf=conf, seed=seed,
                  seconds=args.seconds, trace=False, device=dev)
        row = (fleet if cell["loop"] == "route_replay" else served)(
            run, k < args.control_seeds)
        print(json.dumps({"cell": args.workload, "seed": seed, **row}),
              flush=True)
        run.state = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
