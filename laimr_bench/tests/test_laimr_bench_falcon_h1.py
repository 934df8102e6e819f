"""The ``parallel_hybrid`` family (Falcon-H1-34B-Instruct) and its two
SSD rooflines, on the CPU at toy widths.

The configuration's file at toy widths (2 layers) is served through its
cell's loop with the plain kernels: the port's tree is the harness's
(the published one's 33.64 B parameters too), its reference agrees with
the port, the served cell comes out correct. At full size every one of
the 72 layers launches ``flash_attention`` and ``ssd_scan``.
``ssd_step_roofline`` and ``ssd_scan_wide_roofline`` read a stub trace,
and nothing where it does not hold one launch per layer and traced step
or wave."""
import copy
import dataclasses
import types

import pytest
import torch

from laimr_bench import families, replica, run as bench_run
from laimr_bench.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from laimr_bench.families import parallel_hybrid
from laimr_bench.loops.wave_serve import Wave
from laimr_bench.metrics import counts
from laimr_bench.reference import model_ref
from laimr_bench.run import load_module
from laimr_bench.tests import tiny
from repro_torch.models import model, transformer

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=256,
            intermediate_size=48, mamba_n_heads=4, mamba_d_head=16,
            mamba_d_state=16, mamba_n_groups=2, rope_theta=10000)
CELL = "falcon_h1_34b.robot_chat"


def tiny_conf() -> dict:
    c = copy.deepcopy(replica.load("configs", "falcon_h1_34b"))
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


def test_make_params_draws_the_ports_tree():
    cfg = replica.arch_config(tiny_conf())
    want = shapes(transformer.init_params(cfg, device="meta"))
    got = shapes(replica.make_params("parallel_hybrid", cfg, 2**31 + 1,
                                     "cpu"))
    assert got == want


def test_the_published_tree_has_the_published_size():
    cfg = replica.arch_config(replica.load("configs", "falcon_h1_34b"))
    rand, fixed = families.weights("parallel_hybrid", cfg)
    n = sum(torch.Size(s).numel() for s, _ in rand.values()) \
        + sum(torch.Size(f[1]).numel() for _, f in fixed)
    assert n == model.param_count(cfg) == 33_642_516_224
    assert cfg.n_layers == 72 and cfg.ssm_state == 256


def test_the_reference_equals_the_port():
    conf = tiny_conf()
    cfg = replica.arch_config(conf)
    params = replica.make_params("parallel_hybrid", cfg, 2**31 + 7, "cpu")
    tokens = replica.prompts(5, 2, 70, cfg.vocab_size, "cpu")
    want, _ = model.forward(params, cfg, {"tokens": tokens}, kernels="ref")
    got = model_ref.logits(conf, params, tokens, 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_counts_are_the_sum_of_the_parts():
    """A layer's FLOPs: the attention's (projections at 20 x 128 heads,
    causal pairs), the mixer's at its own widths (32 heads of 128, in_proj
    9,248 wide) and the MLP's."""
    dims = replica.dims(replica.load("configs", "falcon_h1_34b"))
    d, f = 5120, 21504
    w = parallel_hybrid.widths(dims)
    assert (w["heads"], w["d_in"], w["proj"]) == (32, 4096, 9248)
    attn = 2 * (d * 20 * 128 + 2 * d * 4 * 128 + 20 * 128 * d)
    mixer = 2 * (d * 9248 + 4 * (4096 + 2 * 2 * 256) + 4096 * d) \
        + 5 * 32 * 128 * 256
    pos = 150
    assert parallel_hybrid.layer_decode_flops(dims, pos) == \
        attn + 4 * 20 * 128 * (pos + 1) + mixer + 6 * d * f
    assert counts.prefill_flops("parallel_hybrid", dims, 16, 128) == 72 * (
        parallel_hybrid.layer_prefill_flops(dims, 16, 128)) \
        + 16 * counts.head_flops(dims)


def test_launches_at_full_size():
    dims = replica.dims(replica.load("configs", "falcon_h1_34b"))
    assert families.launches("parallel_hybrid", dims,
                             "flash_attention") == 72
    assert families.launches("parallel_hybrid", dims, "ssd_scan") == 72


def test_the_kind_refuses_what_it_does_not_describe():
    cfg = replica.arch_config(tiny_conf())
    with pytest.raises(ValueError, match="parallel_hybrid"):
        parallel_hybrid.check(dataclasses.replace(cfg, ssm_gate_first=False))


def test_a_served_cell_is_correct():
    """Full and partial waves decoding 6 tokens past a 16-token prompt,
    through every layer's ring, conv buffer and SSM state."""
    run = tiny.make_run(tiny.served_cell(CELL, 16, 6), tiny_conf())
    bench_run.execute(run)
    line = bench_run.result_line(run, [], {})
    assert line["correct"], run.checks
    assert run.attempted > 0 and run.failed == 0
    assert any(w.b == 4 for w in run.state.waves)
    assert set(run.checks) == {"route_mismatched", "logit_gap"}


# ------------------------------------------------------------ rooflines
class StubTrace:
    """``n`` launches of ``kernel``, each of one millisecond."""

    t_start = 0.0

    def __init__(self, n: int, kernel: str):
        self.n, self.kernel = n, kernel

    def time_of(self, needle: str) -> tuple[int, float]:
        n = self.n if needle in self.kernel else 0
        return n, n * 1e-3


def stub_run(trace, waves: int = 2, steps: int = 3):
    conf = replica.load("configs", "falcon_h1_34b")
    state = types.SimpleNamespace(
        prompt_len=128, waves=[Wave(16, 0.0, 63, 0.0, float(i), float(i))
                               for i in range(waves)])
    spans = types.SimpleNamespace(items=[("decode_step", float(i),
                                          float(i) + 0.5)
                                         for i in range(steps)])
    return types.SimpleNamespace(
        conf=conf, state=state, trace_obj=trace, spans=spans,
        cell=replica.load("workloads", CELL), traced=lambda start: True)


def test_the_step_roofline_is_the_states_bytes_over_the_time():
    metric = load_module("metrics", "ssd_step_roofline")
    run = stub_run(StubTrace(72 * 3, "ssd_step_kernel<2>"), steps=3)
    per = 8 * 16 * 32 * 128 * 256 + 8 * 16 * 32 * 128 + 8 * 16 * 2 * 256 \
        + 4 * 16 * 32
    want = 100.0 * per / PEAK_HBM_BYTES_PER_S / 1e-3
    assert metric.read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


@pytest.mark.parametrize("n,steps", [(0, 3), (72 * 3 - 1, 3), (72 * 2, 3),
                                     (72 * 3, 0)])
def test_the_step_roofline_reads_nothing_off_the_count(n, steps):
    metric = load_module("metrics", "ssd_step_roofline")
    assert metric.read(stub_run(StubTrace(n, "ssd_step_kernel<2>"),
                                steps=steps)) is None


def test_the_wide_scan_roofline_takes_any_whole_slices():
    metric = load_module("metrics", "ssd_scan_wide_roofline")
    nbytes, ops = counts.ssd_bytes_ops(16, 128, 32, 128, 2, 256)
    one = counts.bound_s(nbytes, ops, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S)
    for slices in (1, 2):
        n = 72 * 2 * slices
        got = metric.read(stub_run(StubTrace(n, "ssd_scan_kernel"), 2))
        assert got == pytest.approx(100.0 * 72 * 2 * one / (n * 1e-3),
                                    rel=1e-12)
    for n in (0, 72 * 2 + 1):
        assert metric.read(stub_run(StubTrace(n, "ssd_scan_kernel"),
                                    2)) is None
    assert metric.read(stub_run(StubTrace(144, "ssd_scan_kernel"),
                                0)) is None
