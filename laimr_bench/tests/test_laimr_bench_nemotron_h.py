"""The ``nemotron_h`` family (NVIDIA-Nemotron-3-Nano-30B-A3B) and the
expert kernel's roofline, on the CPU at toy widths.

The configuration's file at toy widths keeps the published pattern (52
layers) and is served through its cell's loop (``wave_serve_gaps``:
``wave_serve`` with the median gap checked too) with the plain kernels:
the port's tree is the harness's, its reference agrees with the port,
the served cell comes out correct. The counts go by layer kind; at full
size the stack launches ``flash_attention`` from 6 layers, ``ssd_scan``
from 23 and the expert GEMM from 23. ``expert_gemm_roofline`` reads a
stub trace and logged launches, and nothing without them."""
import copy
import types

import numpy as np
import pytest
import torch

from laimr_bench import families, replica, run as bench_run
from laimr_bench.families import hybrid_moe
from laimr_bench.loops import wave_serve
from laimr_bench.loops.wave_serve import Wave
from laimr_bench.metrics import counts
from laimr_bench.reference import model_ref
from laimr_bench.tests import tiny
from repro_torch.models import layers, model, transformer

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, vocab_size=256, mamba_num_heads=8,
            mamba_head_dim=16, ssm_state_size=16, n_groups=2,
            n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=48, moe_shared_expert_intermediate_size=32,
            intermediate_size=48)


def tiny_conf() -> dict:
    c = copy.deepcopy(replica.load("configs", "nemotron_3_nano"))
    c["dtype"] = "float32"
    c["model"].update(TINY)
    return c


def shapes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in shapes(v, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree)
                for p, s in shapes(v, prefix + (i,)).items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("which", ["tiny", "published"])
def test_make_params_draws_the_ports_tree(which):
    conf = tiny_conf() if which == "tiny" \
        else replica.load("configs", "nemotron_3_nano")
    cfg = replica.arch_config(conf)
    want = shapes(transformer.init_params(cfg, device="meta"))
    if which == "tiny":
        got = shapes(replica.make_params("nemotron_h", cfg, 2**31 + 1,
                                         "cpu"))
    else:       # the leaves' shapes and dtypes alone, nothing drawn
        rand, fixed = families.weights("nemotron_h", cfg)
        dt = getattr(torch, cfg.dtype)
        got = {p: (s, dt) for p, (s, _) in rand.items()}
        for p, (what, s, kind) in fixed:
            got[p] = (s, torch.float32 if callable(what) or kind is None
                      else dt)
        got = {p: (tuple(s), d) for p, (s, d) in got.items()}
    assert got == want


def test_the_reference_equals_the_port():
    conf = tiny_conf()
    cfg = replica.arch_config(conf)
    params = replica.make_params("nemotron_h", cfg, 2**31 + 7, "cpu")
    tokens = replica.prompts(5, 2, 70, cfg.vocab_size, "cpu")
    want, _ = model.forward(params, cfg, {"tokens": tokens}, kernels="ref")
    got = model_ref.logits(conf, params, tokens, 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_the_selection_bias_moves_the_routing():
    conf = tiny_conf()
    cfg = replica.arch_config(conf)
    params = replica.make_params("nemotron_h", cfg, 2**31 + 7, "cpu")
    bias = params["layers"][1]["moe"]["select_bias"]
    assert bias.dtype == torch.float32 and 0 < float(bias.std()) < 0.1
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32


def test_the_fp8_control_scales_an_expert_per_output_channel():
    w = torch.zeros(4, 6, 5)
    assert hybrid_moe.fp8_in_dims(("moe", "wi"), w) == (1,)
    assert hybrid_moe.fp8_in_dims(("moe", "shared", "wi"), w[0]) is None
    assert hybrid_moe.fp8_in_dims(("moe", "router"), w[0]) is None


def test_counts_are_the_sum_of_the_kinds():
    dims = replica.dims(replica.load("configs", "nemotron_3_nano"))
    kinds = families.kinds("nemotron_h", dims)
    b, s, rows, pos = 32, 128, 32, 150
    head = counts.head_flops(dims)
    assert counts.prefill_flops("nemotron_h", dims, b, s) == sum(
        families.get(k).layer_prefill_flops(dims, b, s) for k in kinds) \
        + b * head
    assert counts.decode_flops("nemotron_h", dims, rows, pos) == rows * (
        sum(families.get(k).layer_decode_flops(dims, pos) for k in kinds)
        + head)
    # active FLOPs a token: the router, 6 of 128 experts, the shared one
    d = dims["d_model"]
    assert hybrid_moe.layer_decode_flops(dims, pos) == \
        2 * d * 128 + 6 * 4 * d * 1856 + 4 * d * 3712


def test_launches_at_full_size():
    dims = replica.dims(replica.load("configs", "nemotron_3_nano"))
    assert families.launches("nemotron_h", dims, "flash_attention") == 6
    assert families.launches("nemotron_h", dims, "ssd_scan") == 23
    assert families.launches("nemotron_h", dims, "moe_gemm") == 23


def test_a_served_cell_is_correct():
    """Full and partial waves decoding 6 tokens past a 16-token prompt,
    through the attention layers' rings, the SSM states and the expert
    layers."""
    conf = tiny_conf()
    run = tiny.make_run(tiny.served_cell("nemotron_3_nano.robot_chat", 16,
                                         6), conf)
    bench_run.execute(run)
    line = bench_run.result_line(run, [], {})
    assert line["correct"], run.checks
    assert run.attempted > 0 and run.failed == 0
    assert any(w.b == 4 for w in run.state.waves)
    assert set(run.checks) == {"route_mismatched", "logit_gap_p90",
                               "logit_gap_request_median"}


def sample(bad_rows=(), bad_cols=(), n=8, length=64) -> np.ndarray:
    """Gaps (requests, tokens) as bf16 serves them (a unit gap, a few
    flips at 4.5), with whole requests ``bad_rows`` and positions
    ``bad_cols`` of every request served at random (4.8)."""
    g = np.ones((n, length))
    g[:, ::16] = 4.5
    g[list(bad_rows), :] = 4.8
    g[:, list(bad_cols)] = 4.8
    return g


@pytest.mark.parametrize("gaps,correct", [
    (sample(), True),
    (sample(bad_rows=[5]), False),                  # one slot or wave
    (sample(bad_cols=range(48, 64)), False),        # the late positions
    (np.full((8, 64), 2.2), False),                 # fp8's median, all over
])
def test_per_request_and_p90_gaps_decide(monkeypatch, gaps, correct):
    """The cell's loop checks the largest per-request median gap against
    ``logit_gap_request_median_limit`` and the 90th percentile against
    ``logit_gap_p90_limit`` (the widest gap is not checked): a wrong
    request, the late ring positions served wrongly, or every token a
    little lower each fail the run; a few far tokens do not."""
    conf = tiny_conf()
    run = tiny.make_run(tiny.served_cell("nemotron_3_nano.robot_chat", 16,
                                         2), conf)
    monkeypatch.setattr(wave_serve, "logit_gaps",
                        lambda run, st: (gaps, None))
    bench_run.execute(run)
    line = bench_run.result_line(run, [], {})
    assert run.checks["logit_gap_request_median"]["value"] == \
        float(np.median(gaps, axis=1).max())
    assert run.checks["logit_gap_p90"]["value"] == \
        float(np.quantile(gaps, 0.9))
    assert line["correct"] == correct


# -------------------------------------------------------------- roofline
class StubTrace:
    """``n`` launches of ``kernel``, each of one millisecond."""

    def __init__(self, n: int, kernel: str = "moe_gemm_kernel"):
        self.n, self.kernel = n, kernel

    def time_of(self, needle: str) -> tuple[int, float]:
        n = self.n if needle in self.kernel else 0
        return n, n * 1e-3


def stub_run(trace, waves: int = 2):
    conf = replica.load("configs", "nemotron_3_nano")
    state = types.SimpleNamespace(
        prompt_len=128, waves=[Wave(32, 0.0, 63, 0.0, float(i), float(i))
                               for i in range(waves)])
    return types.SimpleNamespace(conf=conf, state=state, trace_obj=trace,
                                 traced=lambda start: True,
                                 device=torch.device("cpu"))


@pytest.fixture
def counters(monkeypatch):
    """The program's counters on the CPU, logged: 10 launches of 768
    rows touching 120 experts, then 40 of 192 touching 90."""
    monkeypatch.setattr(layers, "EXPERT_COUNTERS", {})
    c = layers.expert_counters("cpu")
    for rows, touched in [(768, 120)] * 10 + [(192, 90)] * 40:
        counts = torch.zeros(128, dtype=torch.int32)
        counts[:touched] = rows // touched
        counts[0] += rows - counts.sum()
        layers._count_experts(c, 0 if rows > 192 else 1, counts)
    return c


def pair(rows, touched, d=2688, f=1856):
    nbytes = touched * 2 * d * f * 2 + rows * (2 * d + 4 * f + 4 * d)
    return max(nbytes / 3.35e12, 4 * rows * d * f / 989e12)


def test_the_log_holds_each_launch(counters):
    assert int(counters.at) == 50
    assert counters.log[:10].tolist() == [[768, 120]] * 10
    assert counters.log[10:50].tolist() == [[192, 90]] * 40
    assert counters.phase.tolist() == [[10, 7680, 1200, 540],
                                       [40, 7680, 3600, 560]]


@pytest.mark.parametrize("traced,prefills", [(12, 0), (45, 5), (50, 10)])
def test_the_roofline_reads_the_newest_launches(counters, traced,
                                                prefills):
    """The traced launches are the log's newest: half the kernel's
    launches in the trace, each counted by its own routing."""
    read = bench_run.load_module("metrics", "expert_gemm_roofline").read
    got = read(stub_run(StubTrace(2 * traced)))
    want = 100.0 * (prefills * pair(768, 120)
                    + (traced - prefills) * pair(192, 90)) \
        / (2 * traced * 1e-3)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.0 < got < 100.0


def test_the_log_wraps(monkeypatch, counters):
    read = bench_run.load_module("metrics", "expert_gemm_roofline").read
    monkeypatch.setattr(layers, "EXPERT_LOG", 16)
    monkeypatch.setattr(layers, "EXPERT_COUNTERS", {})
    c = layers.expert_counters("cpu")
    counts = torch.zeros(128, dtype=torch.int32)
    for touched in range(1, 21):            # 20 launches into 16 rows
        counts.zero_()
        counts[:touched] = 1
        layers._count_experts(c, 1, counts)
    got = read(stub_run(StubTrace(2 * 16)))
    want = 100.0 * sum(pair(t, t) for t in range(5, 21)) / (32 * 1e-3)
    assert got == pytest.approx(want, rel=1e-12)
    assert read(stub_run(StubTrace(2 * 17))) is None
    # an odd count: the newest 16 pairs' bounds over 33 kernels' time
    odd = read(stub_run(StubTrace(2 * 16 + 1)))
    assert odd == pytest.approx(want * 32 / 33, rel=1e-12)


def test_the_roofline_reads_nothing_without_the_kernel_or_counters(
        counters, monkeypatch):
    read = bench_run.load_module("metrics", "expert_gemm_roofline").read
    assert read(stub_run(StubTrace(2 * 23 * 7, "ssd_scan_kernel"))) is None
    assert read(stub_run(None)) is None
    assert read(stub_run(StubTrace(2 * 51))) is None   # more than logged
    assert read(stub_run(StubTrace(1))) is None        # no whole pair
    monkeypatch.setattr(layers, "EXPERT_COUNTERS", {})
    assert read(stub_run(StubTrace(2 * 7))) is None
    monkeypatch.delattr(layers, "EXPERT_COUNTERS")      # as the parent
    assert read(stub_run(StubTrace(2 * 7))) is None
