"""Multi-pod dry run of the port: run every (architecture x input shape)
step on the production meshes over a fake process group and record its
per-device memory, op costs and collectives.

The twin of the reference's ``repro.launch.dryrun``. Where the reference
lowers and compiles on 256 or 512 fake host devices, the port lays the
step's inputs out as DTensors over a 16x16 (or 2x16x16) ``DeviceMesh`` of
torch's fake process group, on the ``meta`` device, and runs the step
eagerly under ``implicit_replication``, the op analysis
(``repro_torch.launch.op_analysis``) and ``CommDebugMode``. Each rank's
local shapes are rank 0's; nothing is allocated and no card is needed.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch all --shape all --mesh single,multi --out results/dryrun_torch

Each combination runs in a child process of its own (the fake group is
global to its process) and writes ``<arch>__<shape>__<mesh>.json`` with
the reference's keys:

  status            ok | skip (``reason``) | error (``error``, ``traceback``)
  memory            per-device ``argument_bytes`` / ``output_bytes``
                    (local shard sizes) and ``temp_bytes`` (the peak of
                    live bytes the step's ops materialised)
  flops             per-device product FLOPs (op analysis)
  hlo_bytes         per-device HBM-traffic proxy (op analysis; the
                    reference's key)
  torch_flops       FlopCounterMode's formulas over the same ops
  collectives       per-kind operand bytes; ``collective_bytes_total``
  comm_counts       CommDebugMode's count of each collective op
  n_devices, wall_s

Every figure is accounting over shapes on meta tensors, not a
measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, REFERENCE_IDS, SHAPES,
                                      ArchConfig, get_config)

# --------------------------------------------------------------- skips
LONG_OK = {"mamba2_370m", "recurrentgemma_2b", "gemma2_27b"}


def applicability(arch_id: str, shape_name: str) -> str | None:
    """Return a skip reason, or None if the pair must run."""
    if arch_id not in REFERENCE_IDS:
        return ("SKIP: the reference's dry run has no such architecture; "
                "the dropless expert layer and the parallel hybrid layer "
                "have no sharding rules yet")
    if shape_name == "long_500k":
        if arch_id == "whisper_small":
            return ("SKIP: enc-dec with full-attention encoder; 512k frames "
                    "is the quadratic regime long_500k excludes (DESIGN §4)")
        if arch_id not in LONG_OK:
            return ("SKIP: pure full-attention decoder; long_500k requires "
                    "sub-quadratic attention (DESIGN §4)")
    return None


def config_for(arch_id: str, shape_name: str) -> ArchConfig:
    if arch_id == "gemma2_27b" and shape_name == "long_500k":
        from repro_torch.configs.gemma2_27b import CONFIG_SW
        return CONFIG_SW          # sliding-window variant (beyond-paper)
    return get_config(arch_id)


def kernels_for(cfg: ArchConfig, shape, opts: tuple = ()) -> str:
    """The model path the step runs: the plain versions (``"ref"``), as
    the reference lowers its ``ops`` default, or ``"fused"`` under
    ``--opt fused_attn``. A model with Mamba-2 layers takes ``"fused"``
    (the SSD chunked by 64, ``kernels/fused.py``) at train and prefill
    shapes too: its plain scan is a Python loop of one eager step per
    token and layer (32768 x 48 at prefill_32k), where the reference's
    is one ``lax.scan`` body with a trip count."""
    if "fused_attn" in opts:
        return "fused"
    if shape.kind != "decode" and "mamba2" in cfg.layer_pattern:
        return "fused"
    return "ref"


# ------------------------------------------------------------- dry run
def build_inputs(cfg: ArchConfig, shape, mesh, args, layout=None):
    """``specs.step_fn_for``'s argument tuple distributed over ``mesh``
    (placed on ``layout`` when given): FSDP on for training,
    ``cfg.serve_fsdp`` for serving, the decode cache context-sharded
    when ``global_batch == 1``."""
    from repro_torch.distributed import sharding
    kw = {"layout": layout}
    if shape.kind == "train":
        p, o, b = args
        return (sharding.distribute_params(p, mesh, fsdp=True, **kw),
                sharding.distribute_opt_state(o, mesh, fsdp=True, **kw),
                sharding.distribute_batch(b, mesh, **kw))
    fsdp_serve = cfg.serve_fsdp
    if shape.kind == "prefill":
        p, b = args
        return (sharding.distribute_params(p, mesh, fsdp=fsdp_serve, **kw),
                sharding.distribute_batch(b, mesh, **kw))
    p, tokens, cache, pos = args
    long_ctx = shape.global_batch == 1
    return (sharding.distribute_params(p, mesh, fsdp=fsdp_serve, **kw),
            sharding.distribute_batch(tokens, mesh, **kw),
            sharding.distribute_cache(cache, mesh, cfg,
                                      long_context=long_ctx, **kw),
            sharding.distribute_batch(pos, mesh, **kw))


def lay_out(cfg: ArchConfig, shape, mesh, args):
    """(inputs, layout): on a multi-pod mesh the inputs go onto its
    :func:`sharding.flat_batch_mesh` when every spec names pod and data
    together (all but ``long_500k``'s context-sharded cache, which names
    data alone), else onto the 3-D mesh itself."""
    from repro_torch.distributed import sharding
    layout = sharding.flat_batch_mesh(mesh)
    if layout is not None:
        try:
            return build_inputs(cfg, shape, mesh, args, layout), layout
        except ValueError:
            pass
    return build_inputs(cfg, shape, mesh, args), mesh


def _local_bytes(tree) -> int:
    """Bytes of the distinct local shards in a tree of (D)Tensors."""
    import torch
    from torch.utils._pytree import tree_leaves
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def run_one(arch_id: str, shape_name: str, mesh_kind: str,
            opts: tuple = (), mesh_shape: tuple | None = None,
            device="cuda", small: bool = False) -> dict:
    """One combination, in this process (which must hold no process
    group: the mesh makes one). ``small`` runs the config's
    ``reduced`` variant (tests)."""
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                 "opts": list(opts)}
    reason = applicability(arch_id, shape_name)
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import op_analysis, specs
    shape = SHAPES[shape_name]
    cfg = config_for(arch_id, shape_name)
    if small:
        from repro_torch.configs.base import reduced
        cfg = reduced(cfg)
    t0 = time.time()
    try:
        if mesh_shape is not None:
            rec["mesh_shape"] = list(mesh_shape)
            axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
                else ("data", "model")
            mesh = meshes.make_mesh(tuple(mesh_shape), axes, device)
        else:
            mesh = meshes.make_production_mesh(
                multi_pod=(mesh_kind == "multi"), device=device)
        kernels = kernels_for(cfg, shape, opts)
        rec["kernels"] = kernels
        fn, args = specs.step_fn_for(cfg, shape, kernels)
        args, layout = lay_out(cfg, shape, mesh, args)
        rec["layout"] = list(layout.mesh_dim_names)
        rec["memory"] = {"argument_bytes": _local_bytes(args)}
        # pin the residual stream's batch sharding (see sharding.py);
        # long_500k has batch=1 and context-shards the cache instead.
        if shape.global_batch > 1:
            sharding.set_activation_batch_axes(sharding.batch_axes(mesh))
        else:
            sharding.set_activation_batch_axes(None)
        if "moe" in opts:
            n_groups = 1
            for a in sharding.batch_axes(mesh):
                n_groups *= sharding.axis_sizes(mesh)[a]
            sharding.set_moe_expert_axis("model", groups=n_groups)
        counter = op_analysis.OpCounter()
        comm = CommDebugMode()
        try:
            with implicit_replication(), comm, counter:
                out = fn(*args)
        finally:
            sharding.set_activation_batch_axes(None)
            sharding.set_moe_expert_axis(None, groups=1)
        costs = counter.costs
        rec["wall_s"] = round(time.time() - t0, 1)
        rec["status"] = "ok"
        rec["variant"] = cfg.name
        rec["memory"]["output_bytes"] = _local_bytes(out)
        rec["memory"]["temp_bytes"] = int(costs.temp_peak)
        rec["flops"] = float(costs.flops)            # per device
        rec["hlo_bytes"] = float(costs.bytes)        # HBM-traffic proxy
        rec["torch_flops"] = float(costs.torch_flops)
        rec["collectives"] = {k: int(v) for k, v in costs.collectives.items()}
        rec["collective_bytes_total"] = int(costs.collective_bytes)
        rec["comm_counts"] = {str(k): int(v) for k, v in
                              comm.get_comm_counts().items()}
        rec["n_devices"] = int(mesh.size())
        del out, args
        torch.distributed.destroy_process_group()
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _summary(rec: dict) -> str:
    if rec["status"] == "ok":
        gf = rec.get("flops", 0) / 1e12
        cb = rec.get("collective_bytes_total", 0) / 1e9
        return f"flops={gf:.3f}T coll={cb:.3f}GB wall={rec['wall_s']}s"
    if rec["status"] == "error":
        return rec["error"][:160]
    return ""


def run_child(arch: str, shape: str, mesh_kind: str, out: str,
              opts: tuple = (), mesh_shape: str = "", device="cuda",
              timeout: float = 1800.0, small: bool = False) -> dict:
    """``run_one`` in a child process; its record, also written to
    ``out/<arch>__<shape>__<mesh>.json``. A child that dies or times out
    gives an ``error`` record."""
    path = os.path.join(out, f"{arch}__{shape}__{mesh_kind}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
           "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
           "--out", out, "--device", str(device)]
    if opts:
        cmd += ["--opt", ",".join(opts)]
    if mesh_shape:
        cmd += ["--mesh-shape", mesh_shape]
    if small:
        cmd.append("--reduced")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        err = proc.stderr[-2000:] if proc.returncode else ""
    except subprocess.TimeoutExpired:
        err = f"TimeoutExpired: child ran over {timeout} s"
    if not err and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "opts": list(opts), "status": "error",
           "error": err or "child wrote no record",
           "wall_s": round(time.time() - t0, 1)}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary_table(out: str) -> str:
    """A markdown table of the records in ``out``: one row per (arch,
    shape), each figure "single / multi" per device; skipped pairs
    listed under it."""
    import glob
    recs = {}
    for path in glob.glob(os.path.join(out, "*__*__*.json")):
        with open(path) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec

    def cell(arch, shape, key, scale, fmt):
        vals = []
        for mesh_kind in ("single", "multi"):
            rec = recs.get((arch, shape, mesh_kind))
            if rec is None:
                vals.append("-")
            elif rec["status"] != "ok":
                vals.append(rec["status"])
            else:
                v = rec["memory"]["argument_bytes"] if key == "args" \
                    else rec[key]
                vals.append(fmt.format(v / scale))
        return " / ".join(vals)
    lines = ["| arch | shape | TFLOPs | HBM GB | collective GB | "
             "argument GB |", "|---|---|---|---|---|---|"]
    skips = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if applicability(arch, shape):
                skips.append(f"{arch} {shape}")
                continue
            cells = [cell(arch, shape, key, scale, fmt) for key, scale, fmt
                     in (("flops", 1e12, "{:.3f}"),
                         ("hlo_bytes", 1e9, "{:.1f}"),
                         ("collective_bytes_total", 1e9, "{:.2f}"),
                         ("args", 1e9, "{:.2f}"))]
            lines.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n\nskip (both meshes): " + ", ".join(skips)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    help="comma list from {single,multi}")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="recompute existing results")
    ap.add_argument("--opt", default="",
                    help="comma list of optimisations, e.g. moe,fused_attn")
    ap.add_argument("--mesh-shape", default="",
                    help="override the mesh, e.g. 32x8 or 2x2x2")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cpu needs no card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="child processes at a time")
    ap.add_argument("--reduced", action="store_true",
                    help="run each config's reduced variant (tests)")
    ap.add_argument("--summary", action="store_true",
                    help="print a markdown table of the records in --out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summary:
        print(summary_table(args.out))
        return
    opts = tuple(o for o in args.opt.split(",") if o)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) \
        if args.mesh_shape else None
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        rec = run_one(args.arch, args.shape, args.mesh, opts=opts,
                      mesh_shape=mesh_shape, device=args.device,
                      small=args.reduced)
        path = os.path.join(args.out,
                            f"{args.arch}__{args.shape}__{args.mesh}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    todo = []
    for arch in archs:
        arch = arch.replace("-", "_")
        for shape in shapes:
            for mesh_kind in args.mesh.split(","):
                path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_kind}.json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        old = json.load(f)
                    print(f"[cached] {arch:20s} {shape:12s} {mesh_kind:6s} "
                          f"-> {old['status']}", flush=True)
                    continue
                todo.append((arch, shape, mesh_kind))

    def one(job):
        arch, shape, mesh_kind = job
        if applicability(arch, shape):     # no child for a skip
            rec = run_one(arch, shape, mesh_kind, opts=opts)
            with open(os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_kind}.json"),
                    "w") as f:
                json.dump(rec, f, indent=1)
        else:
            rec = run_child(arch, shape, mesh_kind, args.out, opts,
                            args.mesh_shape, args.device,
                            small=args.reduced)
        print(f"[{rec['status']:5s}] {arch:20s} {shape:12s} "
              f"{mesh_kind:6s} {_summary(rec)}", flush=True)
        return rec

    if args.jobs > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(one, todo))
    else:
        for job in todo:
            one(job)


if __name__ == "__main__":
    main()
