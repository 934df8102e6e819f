"""A run loads neither JAX nor the JAX package ``repro``: the harness and
every module a cell loads are imported in a fresh interpreter, and no
loaded module's top-level name is one of them (compared whole, since
the port's name begins with the JAX package's)."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from laimr_bench import run, replica, common
from laimr_bench.loops import wave_serve, route_replay
from laimr_bench.reference import model_ref, route_ref
from laimr_bench.traffic import schedule
bench = json.load(open({manifest!r}))
for m in bench["per_layer"]:
    run.load_module("metrics", m["name"])
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.engine import ServingEngine
from repro_torch.models import model
from repro_torch.kernels import ops
import importlib
for w in bench["workloads"]:
    conf = replica.load("configs", w["config"])
    replica.arch_config(conf)
    importlib.import_module("laimr_bench.reference." + conf["layer_kind"])
print(json.dumps(common.forbidden_loaded()))
"""


def test_no_jax_and_no_reference_package_is_loaded():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        manifest=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from laimr_bench import common
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in common.forbidden_loaded()
