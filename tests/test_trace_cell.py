"""``tools/trace_spans.py``: the readings of a traced window, on plain
span records and device operations (no benchmark, no device).

The host-time readers keep to spans that ended before the device trace
began; the idle share inside program spans and the clock check read
both placements of the device's operations; the span list names a gap
by the innermost span holding it; the counters' summary, decode steps
and graph replays among them. The tool's
runs on the benchmark's tiny CPU cells are in
``tools/tests/test_trace_cell_runs.py``.
"""
import dataclasses
import math

import pytest

from repro_torch.core.telemetry import SpanRecords
from tools import trace_spans as ts


def op(name, s, e, launch=None, stream=7, corr=0):
    return (name, s, e, launch, stream, corr)


def window(rec, ops=(), t_start=10.0, t_stop=20.0, name="cell"):
    return ts.Window(name=name, rec=rec, t_start=t_start, t_stop=t_stop,
                     ops=list(ops))


def span(rec: SpanRecords, name: str, parent: int, start: float,
         end: float, **counters) -> int:
    """Append a closed span to ``rec``; returns its id."""
    for field in dataclasses.fields(rec):
        getattr(rec, field.name).append(counters.get(field.name, 0))
    sid = len(rec) - 1
    rec.name[sid], rec.parent[sid] = name, parent
    rec.start[sid], rec.end[sid] = start, end
    return sid


STAGES = ("admission.rates", "admission.upload", "admission.kernel",
          "admission.download", "admission.settle")


def fleet_records() -> SpanRecords:
    """Three flushes of 3, 4 and 5 rows with all five stages, two before
    the device trace starts at 10 and one after; 4 copies up and 3 down
    each. Stage j lasts 10 (j + 1) ms."""
    rec = SpanRecords()
    for k, t0 in enumerate((1.0, 5.0, 12.0)):
        sid = span(rec, "admission.flush", -1, t0, t0 + 1.0, rows=3 + k,
                   padded_rows=8, h2d_copies=4,
                   d2h_copies=3, h2d_bytes=400, d2h_bytes=90)
        for j, name in enumerate(STAGES):
            s = t0 + 0.1 * j
            span(rec, name, sid, s, s + 0.01 * (j + 1))
    return rec


def served_records() -> SpanRecords:
    """Waves of 2 and 4 rows before 10 and one of 4 after; a decode step
    before 10 and one after."""
    rec = SpanRecords()
    for t0, rows, pre in ((1.0, 2, 0.5), (3.0, 4, 0.7), (12.0, 4, 0.9)):
        g = span(rec, "engine.generate", -1, t0, t0 + 1.0, rows=rows,
                 steps=1)
        span(rec, "engine.prefill", g, t0, t0 + pre)
        span(rec, "engine.readback", g, t0 + pre, t0 + 1.0)
    for t0, launch in ((6.0, 0.04), (14.0, 0.08)):
        s = span(rec, "engine.step", -1, t0, t0 + 0.1)
        span(rec, "engine.step.launch", s, t0, t0 + launch)
        span(rec, "engine.step.readback", s, t0 + launch, t0 + 0.1)
    return rec


@pytest.mark.parametrize("which", ["served", "fleet"])
def test_host_readers_keep_to_spans_before_the_trace(which):
    if which == "fleet":
        w = window(fleet_records(), name="stablelm_3b.fleet_route")
        # rates 0.01, copies 0.02 + 0.03 + 0.04, settle 0.05 a flush
        assert ts.flush_rates_ms(w) == pytest.approx(10.0)
        assert ts.flush_copy_ms(w) == pytest.approx(90.0)
        assert ts.flush_settle_ms(w) == pytest.approx(50.0)
        # the copy count reads the whole window
        assert ts.route_copies_per_flush(w) == 7.0
        assert set(ts.metrics(w)) == {
            "flush_rates_ms", "flush_copy_ms", "flush_settle_ms",
            "route_copies_per_flush"}
    else:
        w = window(served_records(), name="mamba2_370m.robot_chat",
                   ops=[op("k", 12.0, 12.5)])
        assert ts.prefill_launch_ms(w) == pytest.approx(600.0)
        assert ts.decode_launch_ms(w) == pytest.approx(40.0)
        assert set(ts.metrics(w)) == {
            "prefill_launch_ms", "decode_launch_ms",
            "program_idle_share.generate"}
    # no span ended before the trace: nothing to read
    late = window(w.rec, t_start=0.5, name=w.name)
    got = ts.metrics(late)
    assert "flush_rates_ms" not in got and "prefill_launch_ms" not in got


def test_breakdown_names_a_gap_by_its_innermost_program_span():
    rec = SpanRecords(name=["engine.step", "engine.step.launch",
                            "engine.step.readback", "open"],
                      start=[0.5, 0.6, 2.5, 0.0],
                      end=[3.5, 2.5, 3.5, math.nan],
                      parent=[-1, 0, 0, -1])
    items = ts.program_items(rec)
    # open spans are left out; parents come before their children
    assert [n for n, *_ in items] == ["engine.step", "engine.step.launch",
                                      "engine.step.readback"]

    def innermost(t):
        label = None
        for n, s, e in items:
            if s <= t <= e:
                label = n
        return label
    assert innermost(1.5) == "engine.step.launch"
    assert innermost(3.0) == "engine.step.readback"


def test_idle_inside_program_spans():
    rec = SpanRecords(name=["engine.step", "engine.step.launch", "x"],
                      start=[0.5, 0.5, 3.5], end=[2.5, 2.0, 5.0],
                      parent=[-1, 0, -1])
    # stamped busy at [0, 1] and [2, 3]; launched at 0.6 and 2.0 on one
    # stream, so placed at [0.6, 1.6] and [2.0, 3.0]
    w = window(rec, [op("k", 0.0, 1.0, 0.6, corr=1),
                     op("k", 2.0, 3.0, 2.0, corr=2)], 0.0, 4.0)
    # inside: [0.5, 2.5] and [3.5, 4] (clipped)
    assert ts.idle_inside_pct(w, ts.device_placed(w)) == \
        pytest.approx(100 * (2.5 - 1.0) / 4.0)
    assert ts.program_idle_share(w) == \
        pytest.approx(100 * (2.5 - 1.5) / 4.0)
    assert ts.program_idle_share(window(rec, [], 0.0, 4.0)) is None


def test_launch_placement():
    w = window(SpanRecords(), [
        # launched at 1.0, stamped before its launch
        op("a", 0.9, 1.1, 1.0, corr=1),
        # launched at 1.05 behind a on its stream: starts when a ends
        op("b", 1.3, 1.4, 1.05, corr=2),
        # another stream, launched at 1.06
        op("c", 1.2, 1.25, 1.06, stream=8, corr=3),
        # no launch record: its own stamps
        op("d", 5.0, 5.5)])
    assert ts.launch_starts(w) == [1.0, pytest.approx(1.2), 1.06, None]
    assert ts.launch_placed(w) == [
        ("a", 1.0, pytest.approx(1.2)), ("c", 1.06, pytest.approx(1.11)),
        ("b", pytest.approx(1.2), pytest.approx(1.3)), ("d", 5.0, 5.5)]
    assert [n for n, *_ in ts.device_placed(w)] == ["a", "c", "b", "d"]
    merged = ts.busy_intervals(ts.launch_placed(w))
    assert merged == [[1.0, pytest.approx(1.3)], [5.0, 5.5]]


def test_clock_check_on_a_synthetic_trace():
    # a routing kernel after its flush's kernel stage began, one inside
    # its flush but before that stage, one outside every flush; the
    # launch calls: two inside their kernel stage, one before it
    rec = SpanRecords(name=["admission.flush", "admission.kernel"] * 2,
                      start=[1.0, 1.4, 3.0, 3.1], end=[2.0, 1.9, 4.0, 3.5],
                      parent=[-1, 0, -1, 2])
    w = window(rec, [op("routing_guard_kernel", 1.5, 1.6, 1.45, corr=1),
                     op("copy", 1.7, 1.8, 1.65, corr=2),
                     op("routing_topk_kernel", 3.05, 3.1, 3.04, corr=3),
                     op("routing_guard_kernel", 5.0, 5.1, 3.2, corr=4)],
               0.0, 6.0)
    got = ts.clock_check(w)
    dev, lau = got["device"], got["launch"]
    assert dev["routing_kernels"] == lau["routing_kernels"] == 3
    assert dev["routing_in_a_flush"] == pytest.approx(2 / 3)
    assert dev["routing_in_their_flush"] == pytest.approx(1 / 3)
    assert dev["busy_in_program_spans"] == pytest.approx(0.25 / 0.35)
    # placed by launch: at 1.45, 3.04 and 3.2, each in its flush
    assert lau["routing_in_a_flush"] == pytest.approx(1.0)
    assert lau["routing_in_their_flush"] == pytest.approx(2 / 3)
    assert lau["busy_in_program_spans"] == pytest.approx(1.0)
    assert got["routing_launches_in_their_stage"] == pytest.approx(2 / 3)
    lag = got["routing_start_after_launch_us"]
    assert lag["p0"] == pytest.approx(1e4)
    assert lag["p100"] == pytest.approx(1.8e6)
    assert got["ops_without_launch"] == 0
    moved = got["device_after_launch_placed_us"]
    assert moved["p0"] == pytest.approx(1e4)
    assert moved["p100"] == pytest.approx(1.8e6)
    # idle inside the flushes: [1, 2] and [3, 4] less the busy time
    assert dev["idle_inside_pct"] == pytest.approx(100 * (2 - 0.25) / 6)
    assert lau["idle_inside_pct"] == pytest.approx(100 * (2 - 0.35) / 6)


def test_counters():
    w = window(fleet_records())
    c = ts.counters(w)["flush"]
    assert c == {"rows": 4.0, "padded_rows": 8.0, "h2d_bytes": 400.0,
                 "d2h_bytes": 90.0}
    waves = ts.counters(window(served_records()))["wave"]
    assert waves == {"rows": 3.0, "steps": 1.0,
                     "prefill_ms_by_rows": {2: pytest.approx(500.0),
                                            4: pytest.approx(700.0)}}
    assert ts.counters(window(SpanRecords())) == {}


def test_step_counters_read_the_graph_counter():
    """Replays are the ``engine.step`` spans whose ``graph`` counter is
    set, captures the steps with an ``engine.step.capture`` stage."""
    rec = served_records()                  # two eager steps
    cap = span(rec, "engine.step", -1, 5.0, 5.3)
    span(rec, "engine.step.launch", cap, 5.0, 5.1)
    span(rec, "engine.step.capture", cap, 5.1, 5.2)
    span(rec, "engine.step.readback", cap, 5.2, 5.3)
    for t0 in (15.0, 16.0, 17.0):
        s = span(rec, "engine.step", -1, t0, t0 + 0.02, graph=1)
        span(rec, "engine.step.launch", s, t0, t0 + 0.001)
    want = {"steps": 6, "replays": 3, "replay_share": 0.5, "captures": 1}
    assert ts.step_counters(rec) == want
    assert ts.counters(window(rec))["step"] == want
    assert ts.step_counters(fleet_records()) is None
    assert "step" not in ts.counters(window(fleet_records()))


def traced_steps() -> tuple:
    """``served_records`` with three replayed steps at 15, 16 and 17; the
    records and the four steps that began inside the trace (10 to 20)."""
    rec = served_records()                  # a step at 6, one at 14
    for t0 in (15.0, 16.0, 17.0):
        span(rec, "engine.step", -1, t0, t0 + 0.02, graph=1)
    return rec, [i for i in ts.ids_of(rec, "engine.step")
                 if rec.start[i] > 10]


def test_ssd_step_counter_reads_the_device_trace():
    """``program_counters.step.ssd_mixer``'s state step: the state-step
    kernel's device launches over the ``engine.step`` spans that began
    inside the trace; steps through it alone (the conv and the norm as
    plain passes) read a share of 0."""
    rec, traced = traced_steps()
    kern = "void (anonymous namespace)::ssd_step_kernel(float*, ...)"
    ops = [op(kern, rec.start[s] + 0.001 * k, rec.start[s] + 0.001 * k
              + 5e-4) for s in traced for k in range(3)]
    ops += [op("ssd_scan_kernel", 12.0, 12.1), op("elementwise", 15.5,
                                                    15.6)]
    w = window(rec, ops)
    got = ts.ssd_mixer_counter(w, 3)
    assert got["launches"] == {"ssd_conv_step_kernel": 0,
                               "ssd_step_kernel": 12,
                               "ssd_gated_norm_kernel": 0}
    assert got["steps"] == 4 and got["per_step"]["ssd_step_kernel"] == 3.0
    assert got["share"] == 0.0 and got["kernels_per_step"] == 3.0
    assert ts.counters(w, 3)["step"]["ssd_mixer"] == got
    # a model without Mamba-2 layers: no launches, no share
    plain = ts.ssd_mixer_counter(window(rec, ops[-2:]), 0)
    assert set(plain["launches"].values()) == {0}
    assert plain["share"] is None and plain["kernels_per_step"] == 0.0
    # no layer count given, or no step traced: nothing added
    assert "ssd_mixer" not in ts.counters(w)["step"]
    late = window(rec, ops, t_start=18.0)
    assert ts.ssd_mixer_counter(late, 3) is None
    assert "ssd_mixer" not in ts.counters(late, 3)["step"]


def test_ssd_mixer_counter_reads_the_device_trace():
    """Each of the mixer's three kernels once a layer and step (3
    layers) reads a share of 1.0; the kernels that started inside the
    traced steps count per step, copies and fills aside, and nothing
    outside a step."""
    rec, traced = traced_steps()
    ops = []
    for s in traced:
        t = rec.start[s]
        for k in range(3):
            for j, name in enumerate(("ssd_conv_step_kernel<__nv_bfloat16>",
                                      "ssd_step_kernel",
                                      "ssd_gated_norm_kernel<float>")):
                t0 = t + 0.001 * (3 * k + j)
                ops.append(op(f"void (anonymous namespace)::{name}(...)",
                              t0, t0 + 5e-4))
        ops += [op("elementwise", t + 0.0095, t + 0.0099),
                op("Memcpy DtoH (Device -> Pinned)", t + 0.0199,
                   t + 0.01995),
                op("Memset (Device)", t + 0.0101, t + 0.0102)]
    ops += [op("ssd_scan_kernel", 12.0, 12.1), op("elementwise", 15.5,
                                                    15.6)]
    w = window(rec, ops)
    got = ts.ssd_mixer_counter(w, 3)
    assert got == {"steps": 4,
                   "launches": dict.fromkeys(ts.MIXER_KERNELS, 12),
                   "per_step": dict.fromkeys(ts.MIXER_KERNELS, 3.0),
                   "share": 1.0, "kernels_per_step": 10.0}
    assert ts.ssd_mixer_counter(w, 6)["share"] == pytest.approx(0.5)
    # one layer's norm missing: the share reads the least of the three
    short = window(rec, [o for o in ops if not (
        "gated_norm" in o[0] and o[1] > 17.0)])
    assert ts.ssd_mixer_counter(short, 3)["share"] == pytest.approx(
        (12 - 3) / 4 / 3)


def test_ssd_mixer_counter_reads_the_parallel_layers_attention():
    """Steps that ran 3 parallel layers (the spans' counter), each with
    one ``decode_attention`` launch a layer beside the mixer's three
    kernels: a share of 1.0 and one attention launch per parallel layer
    and step; a model without such layers gets neither key."""
    rec = served_records()
    traced = [span(rec, "engine.step", -1, t0, t0 + 0.02, graph=1,
                   parallel_layers=3) for t0 in (15.0, 16.0)]
    ops = []
    for s in traced:
        for k in range(3):
            t0 = rec.start[s] + 0.001 * k
            ops += [op(f"{name}(...)", t0, t0 + 1e-4) for name in
                    ts.MIXER_KERNELS + ("decode_attention_kernel",)]
    got = ts.ssd_mixer_counter(window(rec, ops, t_start=14.5), 3)
    assert got["share"] == 1.0 and got["parallel_layers"] == 3
    assert got["decode_attention_per_parallel_layer"] == 1.0
    got = ts.ssd_mixer_counter(window(rec, ops[:-1], t_start=14.5), 3)
    assert got["decode_attention_per_parallel_layer"] == \
        pytest.approx(5 / 6)
    rec2, _ = traced_steps()
    assert "parallel_layers" not in ts.ssd_mixer_counter(
        window(rec2, ops), 3)


def test_stream_counters_per_call_by_phase():
    """``program_counters.streams``: the parallel layers and the bytes
    of SSM state and KV a prefill and a step stream, per call."""
    rec = served_records()
    gen = next(i for i in range(len(rec)) if rec.name[i] == "engine.generate")
    rec.parallel_layers[gen] = 72
    rec.ssm_state_bytes[gen] = 1000
    rec.kv_bytes[gen] = 64
    for t0 in (15.0, 16.0):
        span(rec, "engine.step", -1, t0, t0 + 0.02, parallel_layers=72,
             ssm_state_bytes=4000, kv_bytes=500)
    got = ts.counters(window(rec))["streams"]
    steps = len(ts.ids_of(rec, "engine.step"))
    gens = len(ts.ids_of(rec, "engine.generate"))
    assert got["decode"] == {"calls": steps,
                             "parallel_layers": 144 / steps,
                             "ssm_state_bytes": 8000 / steps,
                             "kv_bytes": 1000 / steps}
    assert got["prefill"]["parallel_layers"] == 72 / gens
    assert ts.stream_counters(served_records()) is None
    assert "streams" not in ts.counters(window(served_records()))


def test_expert_counters_per_launch_by_phase():
    """``program_counters.experts``: the expert layers' launches of the
    prefills (``engine.generate``) and of the steps, and per launch their
    rows, experts touched and most rows on one expert."""
    rec = served_records()
    gen = next(i for i in range(len(rec)) if rec.name[i] == "engine.generate")
    rec.expert_launches[gen] = 2
    rec.expert_rows[gen] = 1536
    rec.expert_touched[gen] = 250
    rec.expert_max_rows[gen] = 40
    for t0 in (15.0, 16.0):
        span(rec, "engine.step", -1, t0, t0 + 0.02, expert_launches=2,
             expert_rows=384, expert_touched=180, expert_max_rows=10)
    want = {"prefill": {"launches": 2, "rows": 768.0, "touched": 125.0,
                        "max_rows": 20.0},
            "decode": {"launches": 4, "rows": 192.0, "touched": 90.0,
                       "max_rows": 5.0}}
    assert ts.expert_counters(rec) == want
    assert ts.counters(window(rec))["experts"] == want
    assert ts.expert_counters(fleet_records()) is None
    assert "experts" not in ts.counters(window(served_records()))
