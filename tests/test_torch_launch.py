"""The port's launch layer against the reference's.

* ``op_analysis``: the reference's ``tests/test_sharding.py`` cost cases
  as eager loops (no trip-count rule: a Python loop counts each pass),
  per-device counts on a fake data mesh, and the FLOPs of a reduced
  StableLM-3B, Mamba2-370m, RecurrentGemma-2B, DBRX-132B and
  Whisper-small forward against ``repro.launch.hlo_analysis`` of the
  reference's compiled CPU HLO of the same forward.
* ``specs``: every stand-in's shape and dtype equals the reference's
  ``ShapeDtypeStruct`` through the layer mapping; ``applicability``
  agrees on all 40 (arch x shape) pairs.
* ``dryrun``: the CLI in child processes, reduced configs on 2x2 and
  2x2x2 meshes and the reference's own integration cases at full size.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.distributed import sharding as rs
from repro.launch import dryrun as ref_dryrun
from repro.launch import hlo_analysis
from repro.launch import specs as ref_specs
from repro_torch.configs.base import REFERENCE_IDS, SHAPES, get_config, reduced
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, mesh as meshes, op_analysis, specs
from repro_torch.models import model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- op analysis
def test_mm_flops_exact():
    m, k, n = 64, 128, 32
    a, b = torch.ones((m, k)), torch.ones((k, n))
    _, c = op_analysis.analyze(torch.matmul, a, b)
    assert c.flops == 2 * m * k * n
    assert c.torch_flops == 2 * m * k * n
    assert c.bytes == 4 * (m * k + k * n + m * n)


def _loop(x, n):
    for _ in range(n):
        x = x @ x
    return x


def test_loop_counts_every_pass():
    x = torch.ones((32, 32), device="meta")
    _, c = op_analysis.analyze(_loop, x, 7)
    assert c.flops == 7 * 2 * 32 ** 3


def test_deeper_loop_scales_linearly():
    x = torch.ones((16, 16), device="meta")
    c2 = op_analysis.analyze(_loop, x, 2)[1].flops
    c8 = op_analysis.analyze(_loop, x, 8)[1].flops
    assert c8 == 4 * c2


def test_bytes_positive_and_no_collectives_on_one_device():
    a = torch.ones((128, 128))
    _, c = op_analysis.analyze(lambda t: torch.tanh(t) * 2.0, a)
    assert c.bytes == 2 * 2 * 128 * 128 * 4
    assert c.collectives == {}
    assert c.temp_peak >= 128 * 128 * 4


def test_views_are_free_and_writes_count_their_bytes():
    cache = torch.zeros((4, 64, 8))
    row = torch.ones((4, 8))
    idx = torch.arange(4)

    def write(cache, row):
        v = cache.view(4, 64 * 8).transpose(0, 1)   # views: free
        cache[idx, idx] = row                        # 2 x the row bytes
        return v
    _, c = op_analysis.analyze(write, cache, row)
    assert c.bytes == 2 * row.numel() * 4


@pytest.fixture
def data_mesh():
    meshes.destroy()
    mesh = meshes.make_mesh((4, 1), ("data", "model"), device="cpu")
    yield mesh
    meshes.destroy()


def test_per_device_flops_of_a_batch_sharded_product(data_mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    x = torch.ones((64, 32), device="meta")
    w = torch.ones((32, 16), device="meta")
    one = op_analysis.analyze(torch.matmul, x, w)[1]
    xs = sharding.distribute(x, data_mesh, ("data", None))
    ws = sharding.distribute(w, data_mesh, (None, None))
    with implicit_replication():
        out, four = op_analysis.analyze(torch.matmul, xs, ws)
    assert tuple(out.to_local().shape) == (16, 16)
    assert four.flops == one.flops / 4
    assert four.collectives == {}


def test_all_gather_counts_operand_bytes(data_mesh):
    from torch.distributed.tensor import Replicate
    x = sharding.distribute(torch.ones((64, 32), device="meta"), data_mesh,
                            ("data", None))
    _, c = op_analysis.analyze(
        lambda t: t.redistribute(data_mesh, [Replicate(), Replicate()])
        .to_local(), x)
    assert c.collectives == {"all-gather": 16 * 32 * 4}
    assert c.collective_bytes == 16 * 32 * 4


# FLOPs of the same reduced forward: the port's op analysis on meta
# tensors against the reference's HLO analysis of its compiled CPU
# program. Equal for every model but Mamba-2, whose plain scan reads the
# state with a multiply and a sum (no product) where the reference's
# lax.scan body has a dot: 2 B L H P N fewer, 1.7% of the forward here.
FLOP_REL = {"stablelm_3b": 0.0, "recurrentgemma_2b": 0.0, "dbrx_132b": 0.0,
            "whisper_small": 0.0, "mamba2_370m": 0.02}


@pytest.mark.parametrize("arch", sorted(FLOP_REL))
def test_forward_flops_match_reference_hlo(arch):
    from repro.models import model as ref_model
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    b, s = 2, 64
    if cfg.is_encoder_decoder:
        rbatch = {"frames": jax.ShapeDtypeStruct((b, s, rcfg.d_model),
                                                 jnp.float32),
                  "tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32)}
        batch = {"frames": specs.sds((b, s, cfg.d_model), "float32"),
                 "tokens": specs.sds((b, 16), torch.int32)}
    else:
        rbatch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        batch = {"tokens": specs.sds((b, s), torch.int32)}
    txt = jax.jit(lambda p, bt: ref_model.forward(p, rcfg, bt)).lower(
        ref_model.param_shapes(rcfg), rbatch).compile().as_text()
    want = hlo_analysis.analyze(txt).flops
    params = model.init_params(cfg, device="meta")
    _, c = op_analysis.analyze(
        lambda: model.forward(params, cfg, batch, kernels="ref"))
    assert c.flops == c.torch_flops
    assert abs(c.flops - want) <= FLOP_REL[arch] * want, (c.flops, want)
    assert c.flops <= want


# ------------------------------------------------------------------ specs
def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {rs._path_str(p): leaf for p, leaf in flat}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_specs_match_reference_shape_dtype_structs(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        got = specs.train_batch_specs(cfg, shape)
        want = ref_specs.train_batch_specs(rcfg, shape)
    elif shape.kind == "prefill":
        got = specs.prefill_batch_specs(cfg, shape)
        want = ref_specs.prefill_batch_specs(rcfg, shape)
    else:
        got = dict(zip(("tokens", "pos"),
                       specs.decode_token_specs(cfg, shape)))
        want = dict(zip(("tokens", "pos"),
                        ref_specs.decode_token_specs(rcfg, shape)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_param_and_cache_specs_match_reference(arch):
    from test_torch_sharding import ref_path
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    want = _ref_flat(ref_specs.params_specs(rcfg))
    got = dict(sharding._tree_paths(specs.params_specs(cfg)))
    assert len(got) >= len(want)
    for path, t in got.items():
        rpath, lead = ref_path(cfg, path)
        assert tuple(want[rpath].shape[lead:]) == tuple(t.shape), path
        assert str(t.dtype).split(".")[-1] == str(want[rpath].dtype), path
    wcache = _ref_flat(ref_specs.cache_specs(rcfg, 4, 64))
    for path, t in sharding._tree_paths(specs.cache_specs(cfg, 4, 64)):
        rpath, lead = ref_path(cfg, path, cache=True)
        assert tuple(wcache[rpath].shape[lead:]) == tuple(t.shape), path
        assert str(t.dtype).split(".")[-1] == str(wcache[rpath].dtype)
    ostate = specs.opt_state_specs(cfg)
    assert ostate["step"].dtype == torch.int32
    assert tuple(ostate["step"].shape) == ()


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_applicability_matches_reference(arch, shape_name):
    assert dryrun.applicability(arch, shape_name) == \
        ref_dryrun.applicability(arch, shape_name)
    assert dryrun.config_for(arch, shape_name).name == \
        ref_dryrun.config_for(arch, shape_name).name


def test_step_fn_for_runs_reduced_steps_on_the_cpu():
    cfg = reduced(get_config("stablelm_3b"))
    shape = dataclasses_replace(SHAPES["decode_32k"], seq_len=16,
                                global_batch=2)
    fn, args = specs.step_fn_for(cfg, shape)
    params = model.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((2,), dtype=torch.int32)
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    logits, _ = fn(params, tokens, cache, torch.zeros((2,), dtype=torch.int32))
    assert logits.shape == (2, cfg.vocab_size)
    assert len(args) == 4 and args[2]["layers"][0]["k"].device.type == "meta"


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


# ----------------------------------------------------------------- dry run
def _run_cli(tmp_path, *argv, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--out", str(tmp_path), "--force", *argv],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("mesh_shape,mesh_kind,n", [("2x2", "single", 4),
                                                    ("2x2x2", "multi", 8)])
def test_reduced_dryrun_on_small_meshes(tmp_path, mesh_shape, mesh_kind, n):
    archs = ["stablelm_3b", "mamba2_370m", "recurrentgemma_2b",
             "dbrx_132b", "whisper_small"]
    out = _run_cli(tmp_path, "--reduced", "--mesh-shape", mesh_shape,
                   "--mesh", mesh_kind, "--arch", ",".join(archs),
                   "--shape", "train_4k,decode_32k", "--jobs", "2",
                   timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    for arch in archs:
        for shape in ("train_4k", "decode_32k"):
            rec = json.load(open(tmp_path / f"{arch}__{shape}__"
                                 f"{mesh_kind}.json"))
            assert rec["status"] == "ok", (arch, shape, rec.get("error"))
            assert rec["n_devices"] == n
            assert rec["flops"] > 0 and rec["hlo_bytes"] > 0
            assert rec["mesh_shape"] == [int(x) for x in
                                         mesh_shape.split("x")]
            if shape == "train_4k":
                assert rec["collective_bytes_total"] > 0


@pytest.mark.parametrize("shape,mesh", [("decode_32k", "single"),
                                        ("train_4k", "multi")])
def test_dryrun_runs_full_size(tmp_path, shape, mesh):
    out = _run_cli(tmp_path, "--arch", "stablelm_3b", "--shape", shape,
                   "--mesh", mesh, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.load(open(tmp_path / f"stablelm_3b__{shape}__{mesh}.json"))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)
    assert rec["flops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    if shape == "train_4k":
        # FSDP + TP training must communicate
        assert rec["collective_bytes_total"] > 1e9


def test_dryrun_skip_reasons(tmp_path):
    out = _run_cli(tmp_path, "--arch", "phi3_medium_14b", "--shape",
                   "long_500k", "--mesh", "single", timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.load(open(tmp_path / "phi3_medium_14b__long_500k__single.json"))
    assert rec["status"] == "skip"
    assert "sub-quadratic" in rec["reason"]
