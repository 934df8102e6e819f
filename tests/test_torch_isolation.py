"""The port stands alone: nothing under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``,
so the port runs on a machine that has neither.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    """Top-level package names of every import statement in ``path``,
    wherever it sits (module level, function body, conditional)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_the_slice_modules():
    want = ["core/queueing.py", "core/latency_model.py", "core/scheduler.py",
            "core/telemetry.py", "core/catalogue.py", "core/workload.py",
            "core/router.py", "core/autoscaler.py", "core/simulator.py",
            "control/admission.py", "control/plane.py", "control/fleet.py",
            "control/policies/base.py", "control/policies/route_best.py",
            "control/policies/guarded.py", "control/policies/__init__.py",
            "serving/batch_router.py", "kernels/ref.py", "kernels/ops.py",
            "kernels/routing_score.py", "kernels/routing_decide.py",
            "kernels/_build.py", "kernels/csrc/routing.cu", "convert.py"]
    missing = [m for m in want if not (PORT / m).is_file()]
    assert not missing, missing


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    if True:\n        from jax import numpy\n"
                   "import repro.core\nfrom . import sibling\n")
    assert imported_roots(src) == {"jax", "repro"}


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.serving, repro_torch.core.simulator\n"
            "import repro_torch.kernels.ops, repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
