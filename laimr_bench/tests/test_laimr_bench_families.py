"""Weights, references, counts and rooflines go by model family
(``families/<layer_kind>.py``, ``reference/<layer_kind>.py``).

The two families the cells use draw the same trees and count the same
FLOPs as before the lookup by family (pinned values). A family that
mixes ``mamba2`` and ``attn`` layers, registered under a new name with
its ``kinds`` alone, runs through the harness with no edit to it:
weights of the port's shapes, a reference that agrees with the port,
counts and rooflines that go by layer, and a served cell that comes out
correct. The fp8 control rounds a layer at a time, by its kind's rule,
and computes what rounding the whole tree first computed."""
import hashlib
import sys
import types

import pytest
import torch

from laimr_bench import families, replica, run as bench_run
from laimr_bench.families import mamba2 as mamba2_family
from laimr_bench.loops.wave_serve import Wave
from laimr_bench.metrics import counts
from laimr_bench.reference import model_ref
from laimr_bench.tests import tiny
from repro_torch.models import model, transformer

MIXED = "mixed_probe"


def digest(tree) -> str:
    """sha256 of every leaf's path, dtype, shape and bytes, in path
    order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            t = node.detach().contiguous().cpu()
            h.update(f"{path}|{t.dtype}|{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()


# ------------------------------------------------------------------ pins
#: digests of ``make_params`` of the tiny configurations at seed
#: 2**31 + 11, as drawn before weights went by family
TREE_DIGESTS = {
    "stablelm_3b":
        "762bafc4b50ba051c2d984c8e60ca3a4d4568d26903cb853c68b12cd1a17c1a3",
    "mamba2_370m":
        "b96ff04b3937382bd6c823053cde728610b77b384954aba961576e992cfee997",
}

#: model FLOPs at the cells' shapes (full-width configurations), as
#: counted before counts went by family: (config, b or rows, s or pos)
PREFILL_FLOPS = {
    ("stablelm_3b", 32, 640): 106097289461760,
    ("mamba2_370m", 64, 128): 5708965740544,
    ("mamba2_370m", 32, 2048): 45622290808832,
}
DECODE_FLOPS = {
    ("stablelm_3b", 32, 640): 177366630400,
    ("stablelm_3b", 32, 703): 178027233280,
    ("mamba2_370m", 64, 128): 51141148672,
    ("mamba2_370m", 64, 191): 51141148672,
    ("mamba2_370m", 32, 2048): 25570574336,
    ("mamba2_370m", 32, 2055): 25570574336,
}


@pytest.mark.parametrize("arch", sorted(TREE_DIGESTS))
def test_the_families_draw_the_trees_they_drew_before(arch):
    conf = tiny.conf(arch)
    params = replica.make_params(conf["layer_kind"],
                                 replica.arch_config(conf), 2**31 + 11,
                                 "cpu")
    assert digest(params) == TREE_DIGESTS[arch]


@pytest.mark.parametrize("key", sorted(PREFILL_FLOPS))
def test_prefill_counts_are_those_counted_before(key):
    arch, b, s = key
    conf = replica.load("configs", arch)
    got = counts.prefill_flops(conf["layer_kind"], replica.dims(conf), b, s)
    assert got == PREFILL_FLOPS[key]


@pytest.mark.parametrize("key", sorted(DECODE_FLOPS))
def test_decode_counts_are_those_counted_before(key):
    arch, rows, pos = key
    conf = replica.load("configs", arch)
    got = counts.decode_flops(conf["layer_kind"], replica.dims(conf), rows,
                              pos)
    assert got == DECODE_FLOPS[key]


@pytest.mark.parametrize("call", [
    lambda: families.get("rglru"),
    lambda: counts.decode_flops("rglru", {}, 1, 1),
    lambda: replica.arch_config(dict(tiny.conf("mamba2_370m"),
                                     layer_kind="rglru")),
])
def test_a_family_without_a_module_raises_and_names_itself(call):
    with pytest.raises(ValueError, match="rglru"):
        call()


def test_a_stack_the_family_does_not_describe_is_refused():
    conf = tiny.conf("mamba2_370m")
    with pytest.raises(ValueError, match="not attn"):
        replica.arch_config(dict(conf, layer_kind="attn"))


# ------------------------------------------------------- a mixed family
def mixed_family() -> types.ModuleType:
    """A family of ``mamba2`` and ``attn`` layers in the port's order
    (the configuration's pattern, repeated): its ``kinds`` alone, the
    weights, reference and counts being the two kinds' own."""
    fam = types.ModuleType(f"laimr_bench.families.{MIXED}")

    def kinds(dims):
        pattern = dims["layer_pattern"]
        return [pattern[i % len(pattern)] for i in range(dims["n_layers"])]
    fam.kinds = kinds
    return fam


@pytest.fixture
def mixed(monkeypatch) -> dict:
    """The mixed family registered by name, and a tiny configuration of
    it: Mamba2-370m's file with four layers that alternate ``mamba2``
    and ``attn``, the attention layers with grouped heads and a SwiGLU
    MLP."""
    monkeypatch.setitem(sys.modules, f"laimr_bench.families.{MIXED}",
                        mixed_family())
    conf = tiny.conf("mamba2_370m")
    attn_keys = dict(layer_pattern=["mamba2", "attn"], n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=128, rope_theta=1e4,
                     use_rope=True)
    conf = dict(conf, name=MIXED, layer_kind=MIXED,
                model=dict(conf["model"], n_layer=4, **attn_keys),
                port_fields=dict(conf["port_fields"],
                                 **{k: k for k in attn_keys}))
    return conf


def shapes(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(node.shape), node.dtype)
    walk(tree, ())
    return out


def test_a_mixed_family_draws_the_ports_tree(mixed):
    cfg = replica.arch_config(mixed)
    assert transformer.layer_kinds(cfg) == ["mamba2", "attn"] * 2
    params = replica.make_params(MIXED, cfg, 5, "cpu")
    want = transformer.init_params(cfg, device="meta")
    assert shapes(params) == shapes(want)


def test_a_mixed_reference_equals_the_port(mixed):
    cfg = replica.arch_config(mixed)
    params = replica.make_params(MIXED, cfg, 2**31 + 7, "cpu")
    tokens = replica.prompts(5, 3, 70, cfg.vocab_size, "cpu")
    want, _ = model.forward(params, cfg, {"tokens": tokens}, kernels="ref")
    got = model_ref.logits(mixed, params, tokens, 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_mixed_count_is_the_sum_of_its_layers(mixed):
    dims = replica.dims(mixed)
    b, s, rows, pos = 3, 40, 5, 17
    half = dict(dims, n_layers=2)
    head = counts.head_flops(dims)
    assert counts.prefill_flops(MIXED, dims, b, s) == \
        counts.prefill_flops("attn", half, b, s) \
        + counts.prefill_flops("mamba2", half, b, s) - b * head
    assert counts.decode_flops(MIXED, dims, rows, pos) == \
        counts.decode_flops("attn", half, rows, pos) \
        + counts.decode_flops("mamba2", half, rows, pos) - rows * head


def test_a_mixed_stack_launches_each_kernel_from_its_own_layers(mixed):
    dims = replica.dims(mixed)
    assert families.kinds(MIXED, dims) == ["mamba2", "attn"] * 2
    assert families.launches(MIXED, dims, "ssd_scan") == 2
    assert families.launches(MIXED, dims, "flash_attention") == 2
    assert families.launches("mamba2", dims, "ssd_scan") == 4
    assert families.launches("attn", dims, "ssd_scan") == 0


def test_a_served_cell_of_a_mixed_family_is_correct(mixed):
    """One token out: decoding a full wave through an attention layer
    would meet the program's ring defect (PERF.md, defect 1)."""
    run = tiny.make_run(tiny.served_cell("stablelm_3b.robot_burst", 16, 1),
                        mixed)
    bench_run.execute(run)
    line = bench_run.result_line(run, [], {})
    assert line["correct"], run.checks
    assert run.attempted > 0 and run.failed == 0


# ---------------------------------------------------------------- rooflines
class StubTrace:
    """A device trace that holds ``n`` launches of every kernel, each of
    one millisecond."""

    def __init__(self, n: int):
        self.n = n

    def time_of(self, needle: str) -> tuple[int, float]:
        return self.n, self.n * 1e-3


def stub_run(conf, n_kernels: int, waves: int = 3):
    state = types.SimpleNamespace(
        prompt_len=64, waves=[Wave(4, 0.0, 0, 0.0, float(i), float(i))
                              for i in range(waves)])
    return types.SimpleNamespace(conf=conf, state=state,
                                 trace_obj=StubTrace(n_kernels),
                                 traced=lambda start: True)


@pytest.mark.parametrize("metric", ["ssd_scan_roofline",
                                    "flash_attention_roofline"])
def test_a_roofline_on_a_mixed_stack_expects_its_layers_launches(mixed,
                                                                  metric):
    reader = bench_run.load_module("metrics", metric).read
    dims = replica.dims(mixed)
    assert reader(stub_run(mixed, dims["n_layers"] * 3)) is None
    got = reader(stub_run(mixed, 2 * 3))
    if metric == "ssd_scan_roofline":
        k = counts.ssm_dims(dims)
        nbytes, ops = counts.ssd_bytes_ops(4, 64, k["heads"],
                                           dims["ssm_head_dim"],
                                           dims["ssm_groups"],
                                           dims["ssm_state"])
    else:
        nbytes, ops = counts.flash_bytes_ops(4, 64, dims["n_heads"],
                                             dims["head_dim"],
                                             hkv=dims["n_kv_heads"])
    bound = counts.bound_s(nbytes, ops, 989e12, 3.35e12)
    assert got == pytest.approx(100.0 * 3 * 2 * bound / (6 * 1e-3),
                                rel=1e-12)


# ---------------------------------------------------------------- control
def test_a_family_names_the_dims_of_its_fp8_scales():
    """A stacked expert weight (E, d, f) is rounded per expert and output
    channel where its rule says so; by the rule for a projection its
    scale would span the experts, and a small expert beside a large one
    would round to nothing."""
    def rule(path, leaf):
        return (1,) if path[-2:] == ("moe", "wi") else None
    g = torch.Generator().manual_seed(0)
    wi = torch.randn(3, 16, 8, generator=g)
    wi[0] *= 1e6
    params = {"layers": [{"moe": {"wi": wi}}]}

    def small_error(rule):
        q = model_ref.quantize_fp8(params, rule)["layers"][0]["moe"]["wi"]
        return float((q[1:] - wi[1:]).norm() / wi[1:].norm())
    assert small_error(rule) < 0.1
    assert small_error(None) > 0.5


CONTROL_CONFS = ["stablelm_3b", "mamba2_370m", MIXED]


def control_case(arch, request):
    conf = request.getfixturevalue("mixed") if arch == MIXED \
        else tiny.conf(arch)
    cfg = replica.arch_config(conf)
    params = replica.make_params(conf["layer_kind"], cfg, 2**31 + 3, "cpu")
    tokens = replica.prompts(9, 3, 70, cfg.vocab_size, "cpu")
    return conf, params, tokens


@pytest.mark.parametrize("arch", CONTROL_CONFS)
def test_the_control_rounded_by_layer_equals_the_whole_tree_rounded(
        arch, request):
    """The control rounds each layer as the pass reads it, and computes
    bit for bit what the pass over the whole tree rounded first did."""
    conf, params, tokens = control_case(arch, request)
    got = model_ref.logits(conf, params, tokens, 5, control=True)
    want = model_ref.logits(conf, model_ref.quantize_fp8(params), tokens, 5)
    assert torch.equal(got, want)
    assert not torch.equal(got, model_ref.logits(conf, params, tokens, 5))


@pytest.mark.parametrize("arch", CONTROL_CONFS)
def test_the_control_holds_one_layer_in_float32_at_a_time(
        arch, request, monkeypatch):
    conf, params, tokens = control_case(arch, request)
    rounded = []
    whole = model_ref.quantize_fp8

    def spy(tree, rule=None):
        rounded.append(sorted(tree))
        return whole(tree, rule)
    monkeypatch.setattr(model_ref, "quantize_fp8", spy)
    model_ref.logits(conf, params, tokens, 5, control=True)
    layer_keys = [sorted(p) for p in params["layers"]]
    assert rounded == [sorted(k for k in params if k != "layers")] \
        + layer_keys


def test_the_control_rounds_a_layer_by_its_kinds_rule(monkeypatch):
    """A kind's ``fp8_in_dims`` reaches the leaves of its own layers,
    with paths inside the layer (and, the kind being the family here,
    the embedding's and the head's)."""
    conf, params, tokens = control_case("mamba2_370m", None)
    seen = []

    def rule(path, leaf):
        seen.append(path)
        return (1,) if path == ("mixer", "in_proj") else None
    monkeypatch.setattr(mamba2_family, "fp8_in_dims", rule, raising=False)
    got = model_ref.logits(conf, params, tokens, 5, control=True)
    assert ("mixer", "in_proj") in seen and ("embed",) in seen
    assert not any("layers" in path for path in seen)
    want_tree = dict(model_ref.quantize_fp8(
        {k: v for k, v in params.items() if k != "layers"}, rule),
        layers=[model_ref.quantize_fp8(p, rule) for p in params["layers"]])
    monkeypatch.delattr(mamba2_family, "fp8_in_dims")
    want = model_ref.logits(conf, want_tree, tokens, 5)
    assert torch.equal(got, want)
    assert not torch.equal(
        got, model_ref.logits(conf, params, tokens, 5, control=True))
