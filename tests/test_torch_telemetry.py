"""The port's in-memory tracer (``repro_torch.core.telemetry.TRACER``).

The tracer itself (scopes, contiguous stages, counters, ``drain``), the
spans that ``ControlPlane.flush`` and the routing policies record
(``admission.flush`` with its five stages and copy counters), the
engine's (``engine.generate`` / ``engine.step`` with their launches and
read-backs, and the expert layers' routing counters of a hybrid stack),
and that tracing changes no decision and no token. CPU,
``backend="ref"`` (the plain versions of the routing kernels) and
``kernels="ref"``.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.control.admission import AdmissionConfig
from repro_torch.control.plane import ControlPlane
from repro_torch.core import catalogue, latency_model as lm
from repro_torch.core.scheduler import QualityClass, Request
from repro_torch.core.telemetry import TRACER, SpanRecords, Tracer
from repro_torch.models import layers, model
from repro_torch.serving.engine import ServingEngine
from test_torch_nemotron_h import draw, tiny

STAGES = ("admission.rates", "admission.upload", "admission.kernel",
          "admission.download", "admission.settle")
POLICIES = ("route_best", "guarded_alg1", "safetail", "reliable", "hybrid")


@pytest.fixture
def tracing():
    """The module tracer, on for the test and off and empty after it."""
    TRACER.drain()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.drain()


def traced_decide(pol, reqs, t_now: float) -> tuple[int, int]:
    """(h2d copies, h2d bytes) of one ``pol.decide`` inside a flush
    scope of its own."""
    TRACER.drain()
    TRACER.enable()
    try:
        sid = TRACER.open("admission.flush")
        pol.decide(reqs, t_now)
        TRACER.close(sid)
    finally:
        TRACER.disable()
    rec = TRACER.drain()
    return rec.h2d_copies[0], rec.h2d_bytes[0]


def two_tier() -> catalogue.Cluster:
    edge = dataclasses.replace(lm.PI4_EDGE, net_rtt=0.05)
    cloud = dataclasses.replace(lm.CLOUD, net_rtt=0.086)
    return catalogue.Cluster([
        catalogue.Deployment(lm.YOLOV5M, edge, QualityClass.BALANCED,
                             n_replicas=2, n_max=6),
        catalogue.Deployment(lm.YOLOV5M, cloud, QualityClass.BALANCED,
                             n_replicas=2, n_max=16),
    ])


def make_plane(policy: str, backend: str = "ref") -> ControlPlane:
    return ControlPlane(two_tier(), config=AdmissionConfig(
        window=0.05, max_batch=512, policy=policy, backend=backend,
        device="cpu", block_r=8))


#: requests per flush: two small windows, then a surge that hybrid
#: bursts on and stays in
WINDOWS = (2, 3, 200, 40, 5)


def drive(plane: ControlPlane) -> list:
    """Flush ``WINDOWS`` at 0.05 s apart; every decision, flattened."""
    out = []
    for w, n in enumerate(WINDOWS):
        t = 0.05 * w
        for k in range(n):
            plane.submit(Request(model="yolov5m",
                                 quality=QualityClass.BALANCED,
                                 arrival=t + 1e-6 * k), t)
        out += plane.flush(t)
    return out


def window(n: int) -> list:
    return [Request(model="yolov5m", quality=QualityClass.BALANCED,
                    arrival=0.0) for _ in range(n)]


def children(rec: SpanRecords, sid: int) -> list[int]:
    return [i for i in range(len(rec)) if rec.parent[i] == sid]


# ------------------------------------------------------------- the tracer
class TestTracer:
    def test_stages_are_contiguous_children_of_their_scope(self):
        tr = Tracer()
        tr.enable()
        a = tr.open("a", rows=3, steps=2)
        tr.stage("s1")
        tr.stage("s1")                      # the same name continues it
        tr.stage("s2")
        b = tr.open("b")                    # inside stage s2
        tr.stage("b1")
        tr.close(b)
        tr.end_stage()
        tr.h2d(16)
        tr.close(a)
        rec = tr.drain()
        assert rec.name == ["a", "s1", "s2", "b", "b1"]
        assert rec.parent == [-1, a, a, 2, b]
        assert rec.end[1] == rec.start[2]
        assert (rec.rows[a], rec.steps[a]) == (3, 2)
        assert (rec.rows[1], rec.steps[1]) == (0, 0)
        assert (rec.h2d_copies[a], rec.h2d_bytes[a]) == (1, 16)
        assert rec.end[a] >= rec.end[2] >= rec.end[b] >= rec.end[4]
        assert not any(math.isnan(e) for e in rec.end)
        assert len(tr.drain()) == 0

    def test_replayed_counts_on_the_innermost_scope(self):
        tr = Tracer()
        tr.enable()
        a = tr.open("engine.step")
        tr.stage("engine.step.launch")
        tr.replayed()                       # on the scope, not its stage
        tr.close(a)
        tr.replayed()                       # no scope open: dropped
        assert tr.drain().graph == [1, 0]

    def test_close_ends_scopes_left_open_inside(self):
        tr = Tracer()
        tr.enable()
        a = tr.open("a")
        tr.open("b")
        tr.stage("b1")
        tr.close(a)
        rec = tr.drain()
        assert not any(math.isnan(e) for e in rec.end)
        assert rec.end[0] == max(rec.end)

    def test_counters_go_to_the_innermost_scope(self):
        tr = Tracer()
        tr.enable()
        a = tr.open("a")
        tr.stage("x")
        b = tr.open("b")
        tr.d2h(8)
        tr.pad(16)
        tr.close(b)
        tr.d2h(4)
        tr.close(a)
        rec = tr.drain()
        assert (rec.d2h_copies[b], rec.d2h_bytes[b]) == (1, 8)
        assert (rec.d2h_copies[a], rec.d2h_bytes[a]) == (1, 4)
        assert rec.padded_rows[b] == 16 and rec.padded_rows[a] == 0

    def test_without_a_scope_stages_and_counters_are_dropped(self):
        tr = Tracer()
        tr.enable()
        tr.stage("loose")
        tr.end_stage()
        tr.h2d(4)
        tr.pad(1)
        assert len(tr.drain()) == 0


# -------------------------------------------------------- admission spans
class TestFlushSpans:
    @pytest.mark.parametrize("backend", ["ref", "vmap"])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_children_lie_inside_their_parents(self, tracing, policy,
                                               backend):
        drive(make_plane(policy, backend))
        rec = tracing.drain()
        flushes = [i for i in range(len(rec))
                   if rec.name[i] == "admission.flush"]
        assert len(flushes) == len(WINDOWS)
        for i in range(len(rec)):
            assert rec.start[i] <= rec.end[i]
            p = rec.parent[i]
            if p >= 0:
                assert rec.start[p] <= rec.start[i] <= rec.end[i] \
                    <= rec.end[p]
            else:
                assert rec.name[i] == "admission.flush"
        for f, n in zip(flushes, WINDOWS):
            assert rec.rows[f] == n
            kids = children(rec, f)
            # the vmap scorer uploads inside its kernel stage
            assert {rec.name[k] for k in kids} == set(STAGES) - (
                {"admission.upload"} if backend == "vmap" else set())
            # stages follow each other: none overlaps the next
            for k0, k1 in zip(kids, kids[1:]):
                assert rec.end[k0] <= rec.start[k1]
            assert sum(rec.end[k] - rec.start[k] for k in kids) \
                <= rec.end[f] - rec.start[f]

    @pytest.mark.parametrize("policy,nth,h2d,d2h", [
        # lam, tau, home and up; idx, g and offload back
        ("guarded_alg1", 1, 4, 3),
        # hybrid's steady windows are the guard's
        ("hybrid", 1, 4, 3),
        # its first burst window: the steady windows already put the
        # shared columns and Erlang table up, so only lam and slo go
        ("hybrid", 2, 2, 3),
        # its second burst window: SafeTail's top-k, lam and slo up
        ("hybrid", 3, 2, 3),
    ])
    def test_copies_of_a_fused_flush(self, tracing, policy, nth, h2d, d2h):
        plane = make_plane(policy)
        drive(plane)
        rec = tracing.drain()
        f = [i for i in range(len(rec))
             if rec.name[i] == "admission.flush"][nth]
        r, p = rec.rows[f], rec.padded_rows[f]
        i = len(plane.policy.deps)
        assert p == -(-r // 8) * 8                  # block_r 8
        assert (rec.h2d_copies[f], rec.d2h_copies[f]) == (h2d, d2h)
        if h2d == 4:
            # float32 lam and tau, int32 home and up, padded rows; int32
            # idx, float32 g and a bool offload flag, the window's rows
            assert rec.h2d_bytes[f] == 4 * p * i + 3 * 4 * p
            assert rec.d2h_bytes[f] == r * (4 + 4 + 1)
        else:
            # float32 lam and slo; (R, k) int32 idx and float32 g, and ok
            k = plane.cfg.redundancy
            assert rec.h2d_bytes[f] == 2 * 4 * p * i
            assert rec.d2h_bytes[f] == r * (4 * k + 4 * k + 1)

    def test_hybrid_flushes_both_constituents(self, tracing):
        plane = make_plane("hybrid")
        drive(plane)
        assert plane.policy.switches >= 1

    @pytest.mark.parametrize("policy", POLICIES)
    def test_decisions_equal_with_the_tracer_on_and_off(self, policy):
        def decided():
            return [(d.outcome, d.target_key, d.predicted_latency,
                     d.dup_of is None) for d in drive(make_plane(policy))]
        off = decided()
        TRACER.enable()
        try:
            on = decided()
        finally:
            TRACER.disable()
        assert len(TRACER.drain()) > 0
        assert on == off

    @pytest.mark.parametrize("backend", ["vmap", "ref"])
    def test_the_tracer_off_records_nothing(self, backend):
        TRACER.drain()
        drive(make_plane("hybrid", backend))
        assert not TRACER.on
        assert len(TRACER.drain()) == 0


class TestColumnUploads:
    """The static columns upload with the first flush of a policy only;
    a moved replica count re-uploads the n column and the Erlang table
    keyed on it, nothing else."""

    @pytest.mark.parametrize("policy,rows_up", [("guarded_alg1", 4),
                                                ("safetail", 2),
                                                ("reliable", 2),
                                                ("route_best", 2)])
    def test_later_flushes_of_a_shape_upload_only_rows(self, policy,
                                                       rows_up):
        pol = make_plane(policy).policy
        first = traced_decide(pol, window(4), 0.1)[0]
        later = [traced_decide(pol, window(4), 0.1)[0] for _ in range(3)]
        assert later == [rows_up] * 3
        # six static columns, n and the Erlang table (and reliable's two
        # distribution columns)
        assert first - rows_up == 8 + 2 * (policy == "reliable")

    def test_a_moved_replica_count_reuploads_n_and_the_table(self):
        pol = make_plane("guarded_alg1").policy
        traced_decide(pol, window(4), 0.1)
        steady = traced_decide(pol, window(4), 0.1)
        pol.deps[0].n_replicas += 1
        moved = traced_decide(pol, window(4), 0.1)
        i, t = len(pol.deps), pol.cfg.erlang_table_size
        assert moved == (steady[0] + 2, steady[1] + 4 * i + 4 * i * t)
        assert traced_decide(pol, window(4), 0.1) == steady


# ----------------------------------------------------------- engine spans
@pytest.fixture(scope="module")
def engine_setup():
    cfg = reduced(get_config("mamba2_370m"))
    params = model.init_params(cfg, seed=0, device="cpu")
    gen = np.random.default_rng(5)
    prompts = gen.integers(0, cfg.vocab_size, (2, 12))
    return cfg, params, prompts


def new_engine(engine_setup) -> ServingEngine:
    cfg, params, _ = engine_setup
    return ServingEngine(cfg, params, slots=4, max_len=24, device="cpu",
                         kernels="ref")


class TestEngineSpans:
    def test_spans_nest_per_wave_and_per_step(self, tracing, engine_setup):
        eng = new_engine(engine_setup)
        prompts = engine_setup[2]
        eng.generate(prompts, 3)
        eng.step()
        rec = tracing.drain()
        gen = rec.name.index("engine.generate")
        assert rec.parent[gen] == -1
        assert (rec.rows[gen], rec.steps[gen]) == (2, 3)
        kids = children(rec, gen)
        assert [rec.name[k] for k in kids] == [
            "engine.prefill", "engine.readback", "engine.step",
            "engine.step"]
        steps = [i for i in range(len(rec)) if rec.name[i] == "engine.step"]
        assert [rec.parent[s] for s in steps] == [gen, gen, -1]
        for s in steps:
            assert [rec.name[k] for k in children(rec, s)] == [
                "engine.step.launch", "engine.step.readback"]
        for i in range(len(rec)):
            p = rec.parent[i]
            if p >= 0:
                assert rec.start[p] <= rec.start[i] <= rec.end[i] \
                    <= rec.end[p]
        # no copy is counted on the engine's spans; a CPU engine steps
        # eagerly, so no step replays a graph
        assert not any(rec.h2d_copies) and not any(rec.d2h_copies)
        assert not any(rec.graph)

    def test_tokens_equal_with_the_tracer_on_and_off(self, engine_setup):
        prompts = engine_setup[2]
        off = new_engine(engine_setup).generate(prompts, 4).tokens
        TRACER.drain()
        TRACER.enable()
        try:
            on = new_engine(engine_setup).generate(prompts, 4).tokens
        finally:
            TRACER.disable()
        assert len(TRACER.drain()) == 1 + 2 + 3 * 3
        np.testing.assert_array_equal(on, off)

    def test_the_tracer_off_records_nothing(self, engine_setup):
        TRACER.drain()
        eng = new_engine(engine_setup)
        eng.generate(engine_setup[2], 2)
        eng.step()
        assert len(TRACER.drain()) == 0


# ------------------------------------------------------- expert counters
@pytest.fixture(scope="module")
def hybrid_setup():
    cfg = tiny()
    gen = np.random.default_rng(6)
    return cfg, draw(cfg, 3), gen.integers(0, cfg.vocab_size, (3, 10))


def routed(record: dict, n_experts: int) -> tuple:
    """(rows, experts touched, most rows on one expert) of one
    ``MOE_RECORD`` entry."""
    counts = np.bincount(record["gate_idx"].reshape(-1).numpy(),
                         minlength=n_experts)
    return int(counts.sum()), int((counts > 0).sum()), int(counts.max())


class TestExpertCounters:
    def test_counters_on_generate_and_step_equal_the_routing(
            self, tracing, hybrid_setup):
        """Each span's counters sum its expert layers' routing, as
        ``MOE_RECORD`` records it: the prefill's on ``engine.generate``,
        each step's on its ``engine.step``."""
        cfg, params, prompts = hybrid_setup
        eng = ServingEngine(cfg, params, slots=4, max_len=16,
                            device="cpu", kernels="ref")
        layers.MOE_RECORD = []
        try:
            eng.generate(prompts, 3)
            records = layers.MOE_RECORD
        finally:
            layers.MOE_RECORD = None
        rec = tracing.drain()
        n_moe = cfg.hybrid_pattern.count("E")
        spans = [rec.name.index("engine.generate")] + [
            i for i in range(len(rec)) if rec.name[i] == "engine.step"]
        assert len(records) == n_moe * len(spans)
        for k, sid in enumerate(spans):
            mine = [routed(r, cfg.n_experts)
                    for r in records[k * n_moe:(k + 1) * n_moe]]
            got = (rec.expert_launches[sid], rec.expert_rows[sid],
                   rec.expert_touched[sid], rec.expert_max_rows[sid])
            assert got == (n_moe, *map(sum, zip(*mine))), k
        assert rec.expert_rows[spans[0]] == n_moe * 3 * 10 * cfg.top_k
        assert rec.expert_rows[spans[1]] == n_moe * 4 * cfg.top_k

    def test_the_tracer_off_reads_no_counter(self, hybrid_setup,
                                             monkeypatch):
        """With the tracer off the engine never reads the device's
        counters (no sync); they still count on the device."""
        cfg, params, prompts = hybrid_setup
        eng = ServingEngine(cfg, params, slots=4, max_len=16,
                            device="cpu", kernels="ref")
        before = eng._experts.clone()
        monkeypatch.setattr(eng, "_experts_before", _raise)
        monkeypatch.setattr(eng, "_trace_experts", _raise)
        TRACER.drain()
        eng.generate(prompts, 2)
        eng.step()
        assert len(TRACER.drain()) == 0
        assert int(eng._experts[0, 0] - before[0, 0]) == \
            cfg.hybrid_pattern.count("E")
        assert int(eng._experts[1, 0] - before[1, 0]) == \
            2 * cfg.hybrid_pattern.count("E")

    def test_a_span_starts_from_the_previous_read(self, tracing,
                                                  hybrid_setup,
                                                  monkeypatch):
        """Under the tracer a span's start reads the counters only when
        no span read them since the last call: the first traced call, or
        the first after an untraced one. Every other span starts from
        the previous span's read, so the tokens' read-back stays the
        only wait."""
        cfg, params, prompts = hybrid_setup
        eng = ServingEngine(cfg, params, slots=4, max_len=16,
                            device="cpu", kernels="ref")
        real = eng._experts_before
        fresh = []

        def spy():
            kept = eng._experts_read
            got = real()
            fresh.append(kept is None or got is not kept[0])
            return got
        monkeypatch.setattr(eng, "_experts_before", spy)
        eng.generate(prompts, 3)
        eng.step()
        tracing.disable()
        eng.step()
        tracing.enable()
        eng.step()
        eng.step()
        assert fresh == [True, False, False, False, True, False]
        rec = tracing.drain()
        steps = [i for i in range(len(rec)) if rec.name[i] == "engine.step"]
        assert [rec.expert_launches[i] for i in steps] == \
            [cfg.hybrid_pattern.count("E")] * 5

    def test_an_expert_free_engine_keeps_no_counters(self, engine_setup):
        assert new_engine(engine_setup)._experts is None


# ------------------------------------------------------- calls that raise
def _raise(*args, **kwargs):
    raise RuntimeError("raised inside the span")


class TestStreamCounters:
    """The parallel layers and the SSM-state and KV bytes a call streams,
    counted on the host from the cache's shapes."""

    @pytest.mark.parametrize("arch", ["falcon_h1_34b", "mamba2_370m",
                                      "stablelm_3b"])
    def test_counts_follow_the_shapes(self, tracing, arch):
        cfg = reduced(get_config(arch))
        params = model.init_params(cfg, seed=0, device="cpu")
        slots, max_len, b, s = 4, 24, 3, 10
        eng = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                            device="cpu", kernels="ref")
        eng.generate(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (b, s)), 3)
        rec = tracing.drain()
        kinds = [k for k in model.transformer.layer_kinds(cfg)]
        par = kinds.count("parallel_hybrid")
        ssm = sum(k in ("mamba2", "parallel_hybrid") for k in kinds)
        attn = sum(k in ("attn", "local", "parallel_hybrid")
                   for k in kinds)
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 \
            if cfg.ssm_heads else cfg.ssm_expand * cfg.d_model \
            * cfg.ssm_state * 4
        kv = 2 * cfg.n_kv_heads * cfg.head_dim * 4        # float32 k, v
        gen = rec.name.index("engine.generate")
        assert (rec.parallel_layers[gen], rec.ssm_state_bytes[gen],
                rec.kv_bytes[gen]) == (par, ssm * b * state,
                                       attn * b * s * kv)
        steps = [i for i in range(len(rec)) if rec.name[i] == "engine.step"]
        assert len(steps) == 2
        for i in steps:
            assert (rec.parallel_layers[i], rec.ssm_state_bytes[i],
                    rec.kv_bytes[i]) == (par, 2 * ssm * slots * state,
                                         attn * slots * max_len * kv)


@pytest.mark.parametrize("where", ["flush", "step", "generate"])
def test_a_call_that_raises_closes_its_span(tracing, engine_setup,
                                            monkeypatch, where):
    """The span of a call that raises ends with it: later spans open at
    the top level and every span is closed."""
    if where == "flush":
        plane = make_plane("guarded_alg1")
        plane.submit(window(1)[0], 0.0)
        monkeypatch.setattr(plane.policy, "decide", _raise)
        with pytest.raises(RuntimeError):
            plane.flush(0.0)
        monkeypatch.undo()
        drive(plane)
        top = "admission.flush"
    else:
        eng = new_engine(engine_setup)
        eng.generate(engine_setup[2], 1)
        monkeypatch.setattr(eng, "_decode" if where == "step"
                            else "_prefill", _raise)
        with pytest.raises(RuntimeError):
            eng.step() if where == "step" else \
                eng.generate(engine_setup[2], 1)
        monkeypatch.undo()
        eng.step()
        top = "engine.step"
    rec = tracing.drain()
    assert not any(math.isnan(e) for e in rec.end)
    last = max(i for i in range(len(rec)) if rec.name[i] == top)
    assert rec.parent[last] == -1
