"""The port stands alone: nothing under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``,
so the port runs on a machine that has neither.

Also the port's kernel-oracle rule: every ``__global__`` kernel in
``src/repro_torch/kernels/csrc/*.cu`` has a wrapper that counts its
launches, a plain version ``<wrapper>_ref`` in ``kernels/ref.py``, and a
``tests/test_torch_*.py`` file that names both; and its rng-discipline
rule: no ``torch.manual_seed`` (the global stream) and no
``torch.Generator`` that is not seeded where it is made.
"""
import ast
import importlib
import os
import pkgutil
import re
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
            "control/policies/safetail.py", "control/policies/reliable.py",
            "control/policies/hybrid.py", "control/policy.py",
            "core/capacity.py",
            "serving/batch_router.py", "kernels/ref.py", "kernels/ops.py",
            "kernels/routing_score.py", "kernels/routing_decide.py",
            "kernels/_build.py", "kernels/csrc/routing.cu", "convert.py",
            "configs/__init__.py", "configs/base.py",
            "configs/stablelm_3b.py", "kernels/flash_attention.py",
            "kernels/decode_attention.py", "kernels/csrc/attention.cu",
            "models/__init__.py", "models/layers.py",
            "models/transformer.py", "models/model.py",
            "serving/engine.py", "models/ssm.py", "kernels/ssd_scan.py",
            "kernels/csrc/ssd.cu", "configs/mamba2_370m.py",
            "core/jaxsim.py", "models/rglru.py",
            "configs/recurrentgemma_2b.py", "configs/gemma2_27b.py",
            "configs/phi3_medium_14b.py", "configs/chameleon_34b.py",
            "configs/nemotron_4_340b.py", "configs/dbrx_132b.py",
            "configs/arctic_480b.py", "configs/whisper_small.py",
            "models/encdec.py", "kernels/fused.py", "training/__init__.py",
            "training/data.py", "training/optimizer.py",
            "training/checkpoint.py", "training/train.py",
            "distributed/__init__.py", "distributed/sharding.py",
            "launch/__init__.py", "launch/mesh.py", "launch/specs.py",
            "launch/op_analysis.py", "launch/dryrun.py",
            "configs/nemotron_3_nano.py", "kernels/moe_gemm.py",
            "configs/falcon_h1_34b.py"]
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
            "import repro_torch.models.model, repro_torch.configs\n"
            "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
            "import repro_torch.core.jaxsim, repro_torch.models.rglru\n"
            "import repro_torch.kernels.fused, repro_torch.training.data\n"
            "import repro_torch.training.optimizer\n"
            "import repro_torch.training.checkpoint\n"
            "import repro_torch.training.train\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
            "import repro_torch.launch.op_analysis\n"
            "import repro_torch.launch.dryrun\n"
            "from repro_torch.configs import get_config, PORTED\n"
            "[get_config(a) for a in PORTED]\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ------------------------------------------------------ kernel-oracle rule --
GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def cuda_kernels() -> list[str]:
    """Names of every ``__global__`` function in the port's CUDA
    sources."""
    names = []
    for src in sorted((PORT / "kernels" / "csrc").glob("*.cu")):
        names += GLOBAL_RE.findall(src.read_text())
    return names


def wrapper_of(kernel: str):
    """The Python function that launches ``kernel`` (its name without
    ``_kernel``) in some module of ``repro_torch.kernels``, or None."""
    import repro_torch.kernels as pkg
    name = kernel.removesuffix("_kernel")
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        fn = getattr(mod, name, None)
        if callable(fn) and isinstance(getattr(fn, "launches", None), int):
            return fn
    return None


def test_kernel_scan_sees_every_kernel():
    assert cuda_kernels() == ["flash_attention_kernel",
                              "decode_attention_kernel",
                              "moe_gemm_kernel",
                              "routing_score_kernel", "routing_guard_kernel",
                              "routing_topk_kernel", "routing_attain_kernel",
                              "ssd_scan_kernel", "ssd_conv_step_kernel",
                              "ssd_step_kernel", "ssd_gated_norm_kernel"]


@pytest.mark.parametrize("kernel", cuda_kernels())
def test_kernel_has_counted_wrapper_plain_version_and_test(kernel):
    from repro_torch.kernels import ref
    name = kernel.removesuffix("_kernel")
    assert wrapper_of(kernel) is not None, \
        f"{kernel}: no wrapper {name} with a .launches counter"
    assert callable(getattr(ref, f"{name}_ref", None)), \
        f"{kernel}: no plain version {name}_ref in kernels/ref.py"
    wrapper_re = re.compile(rf"\b{name}\b")
    naming = [p.name for p in sorted((ROOT / "tests").glob("test_torch_*.py"))
              if f"{name}_ref" in p.read_text()
              and wrapper_re.search(p.read_text())]
    assert naming, f"{kernel}: no tests/test_torch_*.py names both " \
        f"{name} and {name}_ref"


# ------------------------------------------------------- rng-discipline --
def rng_findings(path: Path) -> list[str]:
    """Calls in ``path`` that draw from an unseeded torch stream:
    ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]`` (the global
    generator) and any ``torch.Generator(...)`` that is not seeded in
    the same expression (``torch.Generator(device).manual_seed(seed)``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    seeded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "manual_seed" \
                and isinstance(node.func.value, ast.Call):
            seeded.add(id(node.func.value))
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = ast.unparse(node.func)
        if name in ("torch.manual_seed", "torch.cuda.manual_seed",
                    "torch.cuda.manual_seed_all", "torch.seed",
                    "torch.random.manual_seed"):
            found.append(f"{path.name}:{node.lineno} {name}")
        elif name in ("torch.Generator", "Generator") \
                and id(node) not in seeded:
            found.append(f"{path.name}:{node.lineno} unseeded {name}")
    return found


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_rng_discipline(path):
    assert not rng_findings(path)


def test_rng_scan_sees_unseeded_generators(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import torch\n"
        "torch.manual_seed(0)\n"
        "g = torch.Generator()\n"
        "h = torch.Generator(device='cuda').manual_seed(3)\n"
        "def f():\n    return torch.Generator('cpu')\n")
    assert [f.split(" ", 1)[1] for f in rng_findings(src)] == [
        "torch.manual_seed", "unseeded torch.Generator",
        "unseeded torch.Generator"]
