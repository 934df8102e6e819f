"""A run loads neither JAX nor the JAX package ``repro``: the harness and
every module a cell loads are imported in a fresh interpreter, and no
loaded module's top-level name is one of them (compared whole, since
the port's name begins with the JAX package's). A run looks last, once
its result line is made and every metric reader has run, and prints no
result where it finds one."""
import contextlib
import io
import json
import subprocess
import sys
import time
import types
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

#: a traced run of a tiny served cell on the CPU, through
#: ``run_and_report``, in a fresh interpreter
TRACED = r"""
import contextlib, io, json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from laimr_bench import common, run
from laimr_bench.tests import tiny
cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
r = tiny.make_run(cell, tiny.conf("mamba2_370m"), seconds=1.0)
r.trace = True
out = io.StringIO()
with contextlib.redirect_stdout(out), \
        contextlib.redirect_stderr(io.StringIO()):
    rc = run.run_and_report(r, time.time())
line = json.loads(out.getvalue().strip().splitlines()[-1])
print(json.dumps([rc, sorted(line["metrics"]), common.forbidden_loaded()]))
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


def test_a_traced_run_loads_nothing_forbidden_by_its_result_line():
    code = TRACED.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    rc, metrics, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and metrics and found == [], out.stdout


def test_a_module_loaded_by_a_reader_stops_the_result(monkeypatch):
    """The check runs after the metric readers: one that loads a
    forbidden module ends the run with no result line."""
    from laimr_bench import run as bench_run
    from laimr_bench.tests import tiny

    def loads_flax(run):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return 1.0
    monkeypatch.setattr(bench_run, "load_module", lambda kind, name:
                        types.SimpleNamespace(read=loads_flax))
    cell = tiny.served_cell("mamba2_370m.robot_chat", prompt=24, output=5)
    run = tiny.make_run(cell, tiny.conf("mamba2_370m"), seconds=1.0)
    run.trace = True
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.run_and_report(run, time.time())
    assert rc == 4 and "flax" in sys.modules
    assert '"correct"' not in out.getvalue()
