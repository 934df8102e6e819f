"""``tools/trace_cell.py`` on the benchmark's tiny CPU cells
(``laimr_bench/tests/tiny.py``, the plain kernels). These import the
benchmark, so they sit outside the repo's ``tests/``, beside the tool:

    PYTHONPATH=src python -m pytest -q tools/tests

A traced run reports each program-span metric of its cell as a number;
an untraced run of the benchmark leaves the tracer off and empty;
``DeviceTrace.breakdown`` names an idle gap by the innermost program
span that holds it.
"""
import contextlib
import io
import json
import time

import pytest
import torch

from laimr_bench import common, run as bench_run
from laimr_bench.tests import tiny
from repro_torch.core.telemetry import TRACER, SpanRecords
from tools import trace_cell as tc, trace_spans as ts


def traced(cell: dict, conf: dict):
    run = tc.ProgramRun(name=cell["name"], cell=cell, conf=conf,
                        seed=2**31 + 11, seconds=2.0, trace=True,
                        device=torch.device("cpu"), kernels="ref")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tc.traced(run, time.time()) == 0
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    return run, lines


@pytest.fixture(scope="module")
def served():
    cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
    return traced(cell, tiny.conf("mamba2_370m"))


@pytest.fixture(scope="module")
def fleet():
    return traced(tiny.fleet_cell(), tiny.conf("stablelm_3b"))


@pytest.mark.parametrize("which", ["served", "fleet"])
def test_a_traced_run_reports_every_metric_of_its_cell(which, request):
    run, lines = request.getfixturevalue(which)
    assert lines[-4]["correct"]
    metrics = lines[-1]["program_metrics"]
    want = {m for m, (_, cells) in ts.READERS.items() if run.name in cells}
    assert want and set(metrics) == want
    assert all(isinstance(v, float) and v >= 0.0 for v in metrics.values())
    first = lines[-3]
    spans = first["program_spans"]
    assert spans["admission.flush"] == spans["admission.settle"] > 0
    for how in ("device", "launch"):
        assert 0.95 <= first["clock_check"][how]["busy_in_program_spans"] \
            <= 1.0
    flush = first["program_counters"]["flush"]
    assert flush["rows"] >= 1.0 and flush["d2h_bytes"] > 0
    if which == "served":
        counters = first["program_counters"]
        assert counters["wave"]["steps"] == 1.0
        # a CPU engine steps eagerly: no capture, no replay
        setup, steps = counters["setup_step"], counters["step"]
        assert setup["steps"] > 0 and steps["steps"] > 0
        assert setup["captures"] == setup["replays"] == steps["replays"] == 0
        # the plain versions run on the CPU: no mixer kernel
        mixer = steps["ssd_mixer"]
        assert mixer["steps"] > 0
        assert set(mixer["launches"].values()) == {0}
        assert mixer["share"] == 0.0
        assert tc.mamba_layers(run.conf) == run.conf["model"]["n_layer"]
    assert not TRACER.on and len(TRACER.drain()) == 0


@pytest.mark.parametrize("which", ["served", "fleet"])
def test_host_readers_keep_to_spans_before_the_trace(which, request):
    run, _ = request.getfixturevalue(which)
    w = tc.window_of(run)
    rec, t0 = run.program, run.trace_obj.t_start
    flushes = ts.ids_of(rec, "admission.flush")
    before = [f for f in flushes if rec.end[f] <= t0]
    assert before and len(before) < len(flushes)
    assert ts.flush_settle_ms(w) == pytest.approx(ts.child_ms(
        rec, before, ("admission.settle",)), rel=1e-12)


def test_an_untraced_run_leaves_the_tracer_off():
    TRACER.drain()
    cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
    run = tiny.make_run(cell, tiny.conf("mamba2_370m"), seconds=1.0)
    # the harness's untraced path (run_and_report without its check for
    # loaded modules, which a shared test process fails)
    bench_run.execute(run)
    assert run.state.waves and run.checks["route_mismatched"]["value"] == 0
    assert not TRACER.on
    assert len(TRACER.drain()) == 0


def test_breakdown_names_a_gap_by_its_innermost_program_span():
    tr = object.__new__(common.DeviceTrace)
    # device busy at [0, 1], [2, 3] and [5, 6]: gaps [1, 2] and [3, 5]
    tr._kernels = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 5.0, 6.0)]
    tr.t_start, tr.t_stop = 0.0, 6.0
    rec = SpanRecords(name=["engine.step", "engine.step.launch",
                            "engine.step.readback"],
                      start=[0.5, 0.6, 2.5], end=[3.5, 2.5, 3.5],
                      parent=[-1, 0, 0])
    harness = [("decode_step", 0.4, 3.6), ("await_arrival", 3.6, 6.0)]
    spans = common.Spans(items=harness + ts.program_items(rec))
    gaps = dict((round(t, 9), name) for name, t in
                tr.breakdown(spans)["idle_gaps"])
    assert gaps == {2.0: "await_arrival", 1.0: "engine.step.launch"}
    # the harness's own spans name it where no program span holds it
    plain = common.Spans(items=harness)
    assert sorted(n for n, _ in tr.breakdown(plain)["idle_gaps"]) == \
        ["await_arrival", "decode_step"]
