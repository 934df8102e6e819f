"""One cell of the port's benchmark with the program's own spans.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s>
    python3 tools/trace_cell.py --cost --workload <cell> --seed <n> \
        --seconds <s>

A stop-gap until the benchmark reads the program's spans itself: the
``benchmark`` change that does so moves ``trace_spans.READERS`` into
``laimr_bench/metrics/`` and the tracer's switch into ``run.py``, and
deletes this tool's traced form, keeping ``--cost`` if it is still
wanted. Until then it reaches into the harness's ``Run`` and
``DeviceTrace``, and ``trace_spans.READERS`` lists each metric's cells.

The first form is ``laimr_bench/run.py --trace 1`` with the port's tracer
(``repro_torch.core.telemetry.TRACER``) on from the window's opening to
the device trace's end, and through the set-up before it. It prints the
harness's earlier lines and its result line, then three lines of its
own (reductions in ``tools/trace_spans.py``):

* ``program_spans``: span counts by name, ``program_counters``
  (``trace_spans.counters``, with ``step.ssd_mixer``: the traced steps'
  launches of the Mamba-2 decode mixer's three kernels against the
  model's Mamba-2 layers, the device kernels a step and, for parallel
  layers, ``decode_attention`` launches per such layer and step;
  ``streams``: the parallel layers and the SSM-state and KV bytes a
  prefill and a step stream, counted from shapes; and
  ``setup_step``: the set-up's decode steps and the engine's graph
  captures there) and ``clock_check``
  (``trace_spans.clock_check``: routing kernels in their flush and
  device busy time in program spans, each with the device's own stamps
  and with each operation placed by its launch call), and how far the
  wall clock moved against ``perf_counter`` over the trace;
* ``program_breakdown``: the traced half's longest idle gaps, each named
  by the innermost program span holding its middle, else by the
  harness's span (the harness's ``breakdown``, device stamps);
* ``program_metrics``: the per-layer readings of the program's spans
  (``trace_spans.READERS``). Host times come from the spans that ended
  before the device trace began, device shares from the traced half, as
  the harness's own readers do.

The program's spans share the harness's clock (``time.perf_counter``),
onto which ``DeviceTrace.kernels`` maps the device's operations.

The second form times the tracer itself in one process, on and off in
turns: a ``route_replay`` cell's flushes, or a ``wave_serve`` cell's
decode steps, for ``--seconds`` each; and, with the tracer off, the
attribute checks a flush makes and their cost. Both forms run on the
card only.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from laimr_bench import common, families, replica  # noqa: E402
from laimr_bench import run as bench_run  # noqa: E402
from repro_torch.core.telemetry import TRACER, SpanRecords, Tracer  # noqa: E402
from tools import trace_spans  # noqa: E402


class ProgramTrace(common.DeviceTrace):
    """The harness's device trace; its end also ends the program's
    tracing. ``ops`` reads the raw events before the harness's
    ``kernels`` drops them."""

    _ops: list = None

    def stop(self) -> None:
        super().stop()
        TRACER.disable()
        # the wall clock against perf_counter over the trace: the
        # harness maps device stamps with the offset taken at start
        self.wall_stop_ns = time.time_ns()
        self.pc_stop = time.perf_counter()

    def ops(self) -> list:
        """Device operations as ``trace_spans.Window.ops`` has them: each
        with its launch call's host stamp, its stream and its
        correlation id, every stamp mapped as the harness maps device
        stamps (``DeviceTrace.kernels``)."""
        if self._ops is None:
            launch: dict = {}
            dev = []
            for ev in self.prof.profiler.kineto_results.events():
                s = self.t_start + (ev.start_ns() - self.wall_ns) * 1e-9
                c = ev.correlation_id()
                if ev.device_type() == self.kind:
                    if ev.duration_ns() > 0:
                        dev.append((ev.name(), s,
                                    s + ev.duration_ns() * 1e-9,
                                    ev.device_resource_id(), c))
                elif c and ev.name().startswith("cu"):
                    # the runtime call that launched it (cudaLaunchKernel,
                    # cudaMemcpyAsync, ...)
                    launch[c] = min(s, launch.get(c, math.inf))
            self._ops = [(n, s, e, launch.get(c), stream, c)
                         for n, s, e, stream, c in dev]
        return self._ops

    @property
    def kernels(self) -> list:
        self.ops()
        return common.DeviceTrace.kernels.fget(self)


class ProgramRun(bench_run.Run):
    """A traced run whose window also turns the program's tracer on; the
    drained records land in ``program``, the set-up's in
    ``setup_program``."""

    program: SpanRecords = None
    setup_program: SpanRecords = None

    def open_window(self, t0: float) -> None:
        super().open_window(t0)
        self.setup_program = TRACER.drain()
        TRACER.enable()


def window_of(run) -> trace_spans.Window:
    """The traced window of ``run`` as plain data."""
    tr = run.trace_obj
    return trace_spans.Window(name=run.name, rec=run.program,
                              t_start=tr.t_start, t_stop=tr.t_stop,
                              ops=tr.ops())


def mamba_layers(conf: dict) -> int:
    """The Mamba-2 layers of a cell's model: those whose prefill launches
    ``ssd_scan`` (and whose decode step the mixer's three kernels)."""
    return families.launches(conf["layer_kind"], replica.dims(conf),
                             "ssd_scan")


def program_lines(run) -> list[dict]:
    """The three lines this tool adds to a traced run's output."""
    w, tr = window_of(run), run.trace_obj
    rec = run.program
    check = trace_spans.clock_check(w)
    check["wall_minus_perf_counter_drift_us"] = 1e-3 * (
        tr.wall_stop_ns - tr.wall_ns) - 1e6 * (tr.pc_stop - tr.t_start)
    spans = common.Spans(items=list(run.spans.items)
                         + trace_spans.program_items(rec))
    counters = trace_spans.counters(w, mamba_layers(run.conf))
    counters["setup_step"] = trace_spans.step_counters(run.setup_program)
    return [{"program_spans": dict(collections.Counter(rec.name)),
             "program_counters": counters,
             "clock_check": check},
            {"program_breakdown": run.trace_obj.breakdown(spans)},
            {"program_metrics": trace_spans.metrics(w)}]


def traced(run, t_start: float) -> int:
    """``run.py``'s ``run_and_report`` for a traced run, the program's
    tracer on through the window; prints this tool's lines last."""
    run.trace_obj = ProgramTrace(run.device)
    metrics = bench_run.manifest_metrics(run.name, True)
    TRACER.drain()
    TRACER.enable()
    try:
        bench_run.execute(run)
    finally:
        TRACER.disable()
        run.program = TRACER.drain()
    run.e2e["setup_s"] = run.t_window_wall - t_start
    device_row = common.device_info(run.device)
    device_row["memory_peak_bytes"] = run.memory_peak
    line = bench_run.result_line(run, metrics, device_row)
    for text in run.lines:
        print(text, flush=True)
    common.log(f"card: {common.power_limit()}")
    for k, c in run.checks.items():
        common.log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    for extra in program_lines(run):
        print(json.dumps(extra), flush=True)
    return 0


# ------------------------------------------------------------ on-cost
class _CountingOff(Tracer):
    """A tracer that is off and counts the sites that ask."""

    reads = 0

    @property
    def on(self):
        _CountingOff.reads += 1
        return False

    @on.setter
    def on(self, value):
        pass


def check_ns(number: int = 2_000_000) -> float:
    """ns of one ``if TRACER.on:`` with the tracer off, over an empty
    statement."""
    g = {"TRACER": Tracer()}
    best = min(timeit.repeat("if TRACER.on: pass", globals=g,
                             number=number, repeat=5))
    empty = min(timeit.repeat("pass", number=number, repeat=5))
    return 1e9 * (best - empty) / number


def replay_flushes(fl, seconds: float, block: int = 0) -> list:
    """Replay ``fl``'s trace through its plane for ``seconds``, timing
    every call that flushed; with ``block``, the tracer flips every
    ``block`` flushes. Returns (seconds, tracer on) per flush."""
    from repro_torch.core.scheduler import QualityClass, Request
    plane, win, models = fl.plane, fl.plane.cfg.window, fl.models
    trace = fl.trace.tolist()
    out: list = []
    on = False
    submitted, rounds = 0, 0
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        off = rounds * fl.period
        for a0 in trace:
            a = a0 + off
            opened = plane.window_opened_at()
            s = time.perf_counter()
            if opened is not None and a >= opened + win:
                plane.flush(opened + win)
                out.append((time.perf_counter() - s, on))
                s = time.perf_counter()
            req = Request(model=models[submitted % len(models)],
                          quality=QualityClass.BALANCED, arrival=a)
            if plane.submit(req, a) is not None:
                out.append((time.perf_counter() - s, on))
            submitted += 1
            if block and (len(out) // block) % 2 != on:
                on = not on
                (TRACER.enable if on else TRACER.disable)()
                TRACER.drain()
            if s >= deadline:
                break
        rounds += 1
    if on:
        TRACER.disable()
        TRACER.drain()
    return out


def paired_pct(timed: list) -> float:
    """Median over neighbouring (off, on) flushes of on over off, less
    1, in %: neighbours decide windows of about one size."""
    pct = [100.0 * (t1 / t0 - 1.0)
           for (t0, on0), (t1, on1) in zip(timed, timed[1:])
           if not on0 and on1]
    return statistics.median(pct) if pct else None


def tracer_us_per_flush(number: int = 20000) -> float:
    """us of the tracer's own calls in one guard flush (a scope, five
    stages, four uploads and three reads counted, the padded rows), on
    a tracer of its own."""
    tr = Tracer()
    tr.enable()

    def flush():
        sid = tr.open("admission.flush", rows=200)
        tr.stage("admission.rates")
        tr.stage("admission.rates")
        tr.stage("admission.upload")
        tr.pad(200)
        for _ in range(4):
            tr.h2d(3200)
        tr.stage("admission.kernel")
        tr.stage("admission.download")
        for _ in range(3):
            tr.d2h(800)
        tr.stage("admission.settle")
        tr.stage("admission.settle")
        tr.close(sid)
    return 1e6 * min(timeit.repeat(flush, number=number, repeat=5)) / number


def flush_cost(run) -> dict:
    """A fleet cell's flushes with the tracer on and off in turns, and
    the off tracer's checks per flush."""
    from laimr_bench.loops import route_replay
    fl = route_replay.Fleet(run)
    # set-up's objects out of the collector's passes, as in the window
    gc.collect()
    gc.freeze()
    timed = replay_flushes(fl, run.seconds, block=1)
    gc.unfreeze()
    TRACER.__class__ = _CountingOff
    try:
        _CountingOff.reads = 0
        flushes = len(replay_flushes(fl, 2.0))
        reads = _CountingOff.reads
    finally:
        TRACER.__class__ = Tracer
        TRACER.on = False
    per = reads / max(flushes, 1)
    ns = check_ns()
    t_on = [t for t, on in timed if on]
    t_off = [t for t, on in timed if not on]
    on, off = statistics.mean(t_on), statistics.mean(t_off)
    return {"flushes": len(timed), "flush_ms_on": 1e3 * on,
            "flush_ms_off": 1e3 * off,
            "on_cost_pct": 100.0 * (on / off - 1.0),
            "on_cost_pct_paired": paired_pct(timed),
            "tracer_us_per_flush": tracer_us_per_flush(),
            "flush_ms_median_on": 1e3 * statistics.median(t_on),
            "flush_ms_median_off": 1e3 * statistics.median(t_off),
            "off_checks_per_flush": per, "off_check_ns": ns,
            "off_ns_per_flush": per * ns}


def step_cost(run) -> dict:
    """A served cell's decode steps, full waves, the tracer on every
    other step."""
    from laimr_bench import replica
    from laimr_bench.loops import wave_serve
    st = wave_serve.Served(run)
    eng = st.engine
    tokens = replica.prompts(run.seed + 2, st.slots, st.prompt_len,
                             st.cfg.vocab_size, run.device)
    times: dict = {False: [], True: []}
    deadline = time.perf_counter() + run.seconds
    while time.perf_counter() < deadline:
        eng.generate(tokens, 1)
        for k in range(st.out_len - 1):
            (TRACER.enable if k % 2 else TRACER.disable)()
            s = time.perf_counter()
            eng.step()
            times[TRACER.on].append(time.perf_counter() - s)
        TRACER.disable()
        TRACER.drain()
        for k in range(st.slots):
            eng.release(k)
    on, off = statistics.mean(times[True]), statistics.mean(times[False])
    return {"steps": len(times[True]) + len(times[False]),
            "step_ms_on": 1e3 * on, "step_ms_off": 1e3 * off,
            "on_cost_pct": 100.0 * (on / off - 1.0),
            "step_ms_median_on": 1e3 * statistics.median(times[True]),
            "step_ms_median_off": 1e3 * statistics.median(times[False])}


def cost(run) -> int:
    out = flush_cost(run) if run.cell["loop"] == "route_replay" \
        else step_cost(run)
    out["card"] = common.power_limit()
    print(json.dumps({"tracer_cost": out}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args(argv)
    t_start = common.process_start_wall()
    import torch
    if not torch.cuda.is_available():
        common.log("no CUDA device: this tool runs on the card only")
        return 3
    cell = json.loads((bench_run.BENCH / "workloads"
                       / f"{args.workload}.json").read_text())
    conf = json.loads((bench_run.BENCH / "configs"
                       / f"{cell['config']}.json").read_text())
    run = ProgramRun(name=args.workload, cell=cell, conf=conf,
                     seed=args.seed, seconds=args.seconds, trace=True,
                     device=torch.device("cuda", 0))
    rc = cost(run) if args.cost else traced(run, t_start)
    found = common.forbidden_loaded()
    if found:
        common.log(f"forbidden modules loaded: {found}")
        return 4
    return rc


if __name__ == "__main__":
    sys.exit(main())
