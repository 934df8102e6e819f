"""A traced run reads its host-clock metrics before the device trace and
its device metrics inside it: the trace starts half-way through the
window, and each reader keeps to its side of that line."""
import contextlib
import io
import json
import time

from laimr_bench import run as bench_run
from laimr_bench.tests import tiny


def traced_run():
    cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
    run = tiny.make_run(cell, tiny.conf("mamba2_370m"), seconds=2.0)
    run.trace = True
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.run_and_report(run, time.time())
    assert rc == 0
    return run, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_trace_covers_the_second_half_and_the_readers_split_at_it():
    run, line = traced_run()
    tr = run.trace_obj
    waves = run.state.waves
    assert tr.t_start >= run.state.t0 + bench_run.TRACE_FROM * run.seconds
    assert line["device"]["window_s"] < run.state.t_end - run.state.t0
    before = [w for w in waves if w.end <= tr.t_start]
    after = [w for w in waves if w.start >= tr.t_start]
    assert before and after
    assert len(before) + len(after) >= len(waves) - 1
    got = line["metrics"]["prefill_ms"]["value"]
    want = 1e3 * sum(w.prefill_s for w in before) / len(before)
    assert abs(got - want) <= 1e-9 * want
    steps = sum(w.steps for w in before)
    got = line["metrics"]["decode_step_ms"]["value"]
    assert abs(got - 1e3 * sum(w.decode_s for w in before) / steps) \
        <= 1e-9 * got
    assert 0.0 < line["metrics"]["idle_share.generate"]["value"] < 100.0
    assert 0.0 < line["device"]["busy_s"] < line["device"]["window_s"]


def test_an_untraced_run_keeps_every_wave_on_the_host_side():
    cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
    run = tiny.make_run(cell, tiny.conf("mamba2_370m"), seconds=1.0)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert bench_run.run_and_report(run, time.time()) == 0
    assert run.trace_obj is None
    assert all(run.untraced(w.end) and not run.traced(w.start)
               for w in run.state.waves)
