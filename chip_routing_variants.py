#!/usr/bin/env python3
"""Time variants of the routing kernels against each other on one GPU.

    python3 chip_routing_variants.py [--parent DIR] [--rounds N]

Builds ``src/repro_torch/kernels/csrc/routing.cu`` and variants of it made
by text edits (``VARIANTS``), plus the ``routing.cu`` of another checkout
at DIR when given (an earlier design, called through its own launcher
signatures), one ``nvcc`` each, all started together, into
``build/torch_kernels/variants/``. Prints each body's registers and
spills, then times every variant of ``routing_attain`` and
``routing_guard`` (and ``routing_score`` / ``routing_topk`` of this tree
and DIR) at ``chip_smoke.py``'s shapes in turns in one process (the order
reversed every round, a one-element ``fill_`` beside them as the launch
floor), after holding every variant's outputs to this tree's bit for bit.
One JSON line per shape with every round's device ms; the card's
``nvidia-smi`` name and power limit first. Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "torch_kernels" / "variants"

# name -> (kernels it takes part in, text edits of this tree's routing.cu)
VARIANTS = {
    "this": (("attain", "guard", "score", "topk"), []),
    # attain: two candidates a batch, as the other modes (spills)
    "attain_two": (("attain",), [(
        "constexpr int H = M == Mode::kAttain ? 1 : (G < kBatch ? G : kBatch);",
        "constexpr int H = G < kBatch ? G : kBatch;")]),
    # attain: p evaluated for every feasible pair, no bound
    "attain_no_bound": (("attain",), [(
        "__fsub_rn(row_pmax, kAttainBand), acc);", "-kBig, acc);")]),
    # attain: each lane evaluates p for its own pairs in wide rows too
    "attain_per_lane": (("attain",), [
        ("constexpr bool kSlotP = M == Mode::kAttain && G == 1;",
         "constexpr bool kSlotP = M == Mode::kAttain;"),
        ("constexpr bool kList = M == Mode::kAttain && G == 4;",
         "constexpr bool kList = false;"),
        ("const int list = M == Mode::kAttain && wide ? a.rows * lanes * "
         "group * 4\n                                              : 0;",
         "const int list = 0;")]),
    # guard: block sizes, no staging, upstream scored only where it fires
    "guard_32": (("guard",), [("constexpr int kGuardThreads = 128;",
                               "constexpr int kGuardThreads = 32;")]),
    "guard_64": (("guard",), [("constexpr int kGuardThreads = 128;",
                               "constexpr int kGuardThreads = 64;")]),
    "guard_256": (("guard",), [("constexpr int kGuardThreads = 128;",
                                "constexpr int kGuardThreads = 256;")]),
    "guard_unstaged": (("guard",), [("constexpr int kGuardStageMax = 32;",
                                     "constexpr int kGuardStageMax = 0;")]),
    "guard_on_fire": (("guard",), [
        ("""  float g_up = score<kStaged>(c, table, a.T, uu, lam_u, &rho_u);
  if (!(rho_h < 1.0f)) g_home = kUnstable;
  if (!(rho_u < 1.0f)) g_up = kUnstable;""",
         "  if (!(rho_h < 1.0f)) g_home = kUnstable;"),
        ("  const bool off = g_inst > tau && u >= 0;\n",
         """  const bool off = g_inst > tau && u >= 0;
  float g_up = g_home;
  if (off) {
    g_up = score<kStaged>(c, table, a.T, u, lam_u, &rho_u);
    if (!(rho_u < 1.0f)) g_up = kUnstable;
  }
""")]),
}
_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# an earlier checkout's launchers: guard without I, attain without a plan
EARLIER = {"laimr_routing_guard": [_V, _I, _I] + [_V] * 10 + [_I] * 2 + [_V] * 4,
           "laimr_routing_attain": ([_V, _I, _I] + [_V] * 7 + [_I] + [_V] * 3
                                    + [_I] * 4 + [_F] + [_V] * 4)}


def edit(src: str, edits: list) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """name -> (loaded library, ptxas bodies), one nvcc each, together."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = OUT / f"routing_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib_{name}.so"))
        for fn, argtypes in _build.SIGNATURES["routing"].items():
            getattr(lib, fn).argtypes = (EARLIER.get(fn, argtypes)
                                         if name == "earlier" else argtypes)
            getattr(lib, fn).restype = _I
        bodies = cs.routing_bodies(log) if name != "earlier" else []
        libs[name] = lib
        cs.emit({"variant": name, "bodies": [
            {k: b.get(k) for k in ("kernel", "group", "staged", "registers",
                                   "spills")} for b in bodies]})
    return libs


def main() -> int:
    import torch
    from repro_torch.kernels import routing_score as trs
    argv = sys.argv[1:]
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv \
        else 3
    parent = Path(argv[argv.index("--parent") + 1]) if "--parent" in argv \
        else None
    if not torch.cuda.is_available():
        print("chip_routing_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (ROOT / "src/repro_torch/kernels/csrc/routing.cu").read_text()
    sources = {n: edit(src, e) for n, (_, e) in VARIANTS.items()}
    if parent is not None:
        sources["earlier"] = (
            parent / "src/repro_torch/kernels/csrc/routing.cu").read_text()
    libs = build(sources)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = []

    def strides(x):
        return (1, 0) if x.ndim == 1 else (x.shape[1], 1)

    def attain_plan(name, r, i):
        """This tree's plan; attain_per_lane's without the column lists."""
        if name == "earlier":
            return []
        p = trs.row_plan(i, "attain")
        lists = (p.rows_per_block * p.lanes * p.group * 4
                 if name == "attain_per_lane" and p.group == 4 else 0)
        smem = p.smem_bytes - lists
        if not p.scratch:
            return [p.lanes, p.rows_per_block, smem, None]
        buf = torch.empty(-(-r // p.rows_per_block) * p.rows_per_block
                          * p.row_bytes, dtype=torch.uint8, device=dev)
        keep.append(buf)
        return [p.lanes, p.rows_per_block, smem, buf.data_ptr()]

    def call(name, op, case, k, margin):
        t = cs.to_dev({n: case[n] for n in (cs.GUARD_ARGS if op == "guard"
                                             else cs.TOPK_ARGS["attain"]
                                             if op == "attain"
                                             else cs.SCORE_ARGS)}, dev)
        keep.append(t)
        r, (i, tt) = t["lam"].shape[0], t["table"].shape
        lrs, lcs = strides(t["lam"])
        shape = (r,) if op in ("guard", "score") else (r, k)
        idx = torch.empty(shape, dtype=torch.int32, device=dev)
        g = torch.empty(shape, device=dev)
        flag = torch.empty(r, dtype=torch.uint8, device=dev)
        outs = [idx.data_ptr(), g.data_ptr(), flag.data_ptr(), stream]
        cols = [t[n].data_ptr() for n in ("alpha", "beta", "gamma", "mu",
                                          "n", "rtt")]
        lib = libs[name]
        if op == "guard":
            dims = [r, tt] if name == "earlier" else [r, i, tt]
            args = ([t["lam"].data_ptr(), lrs, lcs] + cols
                    + [t[n].data_ptr() for n in ("tau", "home", "up",
                                                 "table")] + dims + outs)
            fn = lib.laimr_routing_guard
        else:
            srs = 0 if t["slo"].ndim == 1 else i
            head = [t["lam"].data_ptr(), lrs, lcs] + cols + [
                t["slo"].data_ptr(), srs]
            if op == "attain":
                args = (head + [t["sigma"].data_ptr(), t["avail"].data_ptr(),
                                t["table"].data_ptr(), r, i, tt, k, margin]
                        + attain_plan(name, r, i) + outs)
                fn = lib.laimr_routing_attain
            else:
                p = trs.row_plan(i, op)
                plan = [p.lanes, p.rows_per_block, p.smem_bytes, None]
                tail = [k, margin] if op == "topk" else []
                args = (head + [t["cost"].data_ptr(), t["table"].data_ptr(),
                                r, i, tt] + tail + plan + outs)
                fn = getattr(lib, f"laimr_routing_{op}")

        def run():
            rc = fn(*args)
            if rc != 0:
                raise SystemExit(f"{name} {op}: launch failed ({rc})")
        return run, (idx, g, flag)

    margin = cs.ATTAIN_MARGIN
    shapes = [("attain", "r256_i2", cs.main_path_topk_case("attain", 2), 2),
              ("attain", "r256_i4", cs.main_path_topk_case("attain", 4), 2),
              ("attain", "r4096_i1024", cs.fleet_topk_case("attain", dev)[0],
               2),
              ("attain", "r4096_i1024_k8",
               cs.fleet_topk_case("attain", dev, k=8)[0], 8)]
    for i in (2, 4, cs.GUARD_STAGE_I, cs.GUARD_STAGE_I + 1):
        shapes.append(("guard", f"r256_i{i}", cs.main_path_guard_case(i),
                       None))
    shapes.append(("guard", "r4096_i1024",
                   cs.guard_case(1024, 4096, seed=4096, lam_rows=True), None))
    shapes += [("score", "r256_i4", cs.main_path_case(4), 1),
               ("score", "r4096_i1024", cs.fleet_score_case(dev), 1),
               ("topk", "r256_i4", cs.main_path_topk_case("topk", 4), 2),
               ("topk", "r4096_i1024", cs.fleet_topk_case("topk", dev)[0],
                2)]
    one = torch.zeros(1, device=dev)
    for op, label, case, k in shapes:
        names = [n for n, (ops, _) in VARIANTS.items() if op in ops]
        if parent is not None:
            names.insert(0, "earlier")
        m = margin if op == "attain" else 0.0
        runs = {n: call(n, op, case, k, m) for n in names}
        for fn, _ in runs.values():
            fn()
        torch.cuda.synchronize(dev)
        ref = runs["this"][1]
        for n, (_, got) in runs.items():
            for a, b in zip(got, ref):
                if not torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, b.view(torch.int32)
                                   if b.is_floating_point() else b):
                    raise SystemExit(f"{op} {label}: {n} differs from this "
                                     f"tree's outputs")
        times = {n: [] for n in names + ["launch_floor"]}
        order = names + ["launch_floor"]
        for rnd in range(rounds):
            for n in order if rnd % 2 == 0 else order[::-1]:
                fn = (lambda: one.fill_(1.0)) if n == "launch_floor" \
                    else runs[n][0]
                times[n].append(cs.time_launches(fn, dev))
        cs.emit({"op": op, "shape": label, "k": k, "ms": times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
