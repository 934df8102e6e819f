"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 laimr_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell is ``laimr_bench/workloads/<cell>.json``; it names its model
configuration (``configs/<config>.json``) and its drive loop
(``loops/<loop>.py``). With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<name>.py`` from the run's host spans, the
program's counters and a device trace. The trace covers the window's
second half (``TRACE_FROM``) and what drains after it; the host-clock
readings come from the first half, which the profiler does not slow.
Which metrics a cell reports is read from ``BENCHMARK.json``.

After the window the program's state is freed and the plain references
(``reference/``) check what the timed path produced; each number
compared is printed beside its limit, as the last lines on standard
error and under ``checks``, the last key of the result line, which is
the last line on standard output.

The run fails, printing no result, without a CUDA device, or when a
module of JAX or of the JAX package ``repro`` is loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))
os.environ.setdefault("USE_FLAX", "0")

from laimr_bench import common  # noqa: E402

BENCH = Path(__file__).resolve().parent
#: where in a traced run's window the device trace starts, as a share of
#: ``--seconds``: host-clock readings come from before it, untouched by
#: the profiler's cost per launch, device readings from after it
TRACE_FROM = 0.5


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the loop measured."""

    name: str
    cell: dict
    conf: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    kernels: str = "cuda"
    spans: common.Spans = dataclasses.field(default_factory=common.Spans)
    trace_obj: object = None
    t_window_wall: float = 0.0
    state: object = None
    e2e: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    lines: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    trace_at: float = math.inf

    def open_window(self, t0: float) -> None:
        """The window opens at ``t0`` (``time.perf_counter``); a traced
        run's device trace is due ``TRACE_FROM`` of the way in."""
        self.t_window_wall = time.time() - (time.perf_counter() - t0)
        if self.trace_obj is not None:
            self.trace_at = t0 + TRACE_FROM * self.seconds

    def tick(self, now: float) -> None:
        """Start the device trace once it is due; the loops call this
        between their calls into the program."""
        if now >= self.trace_at:
            self.trace_at = math.inf
            self.trace_obj.start()

    def untraced(self, end: float) -> bool:
        """Whether host work that ended at ``end`` ran before the
        device trace (all of it does in an untraced run)."""
        tr = self.trace_obj
        return tr is None or tr.t_start is None or end <= tr.t_start

    def traced(self, start: float) -> bool:
        """Whether device work that began at ``start`` is in the
        trace."""
        tr = self.trace_obj
        return tr is not None and tr.t_start is not None \
            and start >= tr.t_start


def manifest_metrics(name: str, trace: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` has cell ``name`` report."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or name in m["workloads"]]


def load_module(kind: str, name: str):
    """``laimr_bench/<kind>/<name>.py`` as a module (names may hold
    dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"laimr_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def execute(run: Run) -> None:
    """Set-up, the window, the release of the program's state and the
    check, by the cell's loop module."""
    loop = importlib.import_module(f"laimr_bench.loops.{run.cell['loop']}")
    loop.run_cell(run)


def result_line(run: Run, metrics: list[dict], device: dict) -> dict:
    values = {}
    for m in metrics:
        if run.trace:
            v = load_module("metrics", m["name"]).read(run)
        else:
            v = run.e2e.get(m["name"])
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in run.checks.values()) \
        and run.failed == 0 and bool(run.checks)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": values, "device": device}
    if run.trace and run.trace_obj is not None:
        device["busy_s"] = run.trace_obj.busy_s()
        device["window_s"] = run.trace_obj.window_s
        line["breakdown"] = run.trace_obj.breakdown(run.spans)
    line["checks"] = run.checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = common.process_start_wall()

    import torch
    cell_path = BENCH / "workloads" / f"{args.workload}.json"
    if not cell_path.exists():
        common.log(f"no cell {args.workload!r} ({cell_path})")
        return 2
    cell = json.loads(cell_path.read_text())
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            int(cell.get("chips", 1)):
        common.log("no CUDA device (or fewer than the cell asks for): "
                   "the benchmark runs on the card only")
        return 3
    device = torch.device("cuda", 0)
    with open(BENCH / "configs" / f"{cell['config']}.json") as f:
        conf = json.load(f)
    run = Run(name=args.workload, cell=cell, conf=conf, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device)
    return run_and_report(run, t_start)


def run_and_report(run: Run, t_start: float) -> int:
    """Execute ``run``, then print its earlier lines, its checks on
    standard error and its result line, last, on standard output.
    Returns the exit code."""
    if run.trace:
        run.trace_obj = common.DeviceTrace(run.device)
    metrics = manifest_metrics(run.name, run.trace)
    execute(run)
    run.e2e["setup_s"] = run.t_window_wall - t_start
    device_row = common.device_info(run.device)
    device_row["memory_peak_bytes"] = run.memory_peak
    line = result_line(run, metrics, device_row)
    # last of all, after the metric readers have been loaded and run
    found = common.forbidden_loaded()
    if found:
        common.log(f"forbidden modules loaded: {found}")
        return 4
    for text in run.lines:
        print(text, flush=True)
    common.log(f"card: {common.power_limit()}")
    for k, c in run.checks.items():
        common.log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
