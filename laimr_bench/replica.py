"""The system under test for one cell: the port's model configuration,
weights made here from the run's seed, the replica's ``ServingEngine``
and the LA-IMR deployment pair that the admission plane routes over.

Weights are the benchmark's, not the program's: they are drawn on the
device from ``--seed`` in a few large calls, in the dtype they are
served in, and handed as they are to the engine and, after the window,
to the plain reference (``reference/``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch

from laimr_bench import families

BENCH = Path(__file__).resolve().parent

#: keys of a configuration's ``model`` that the port has no field for
#: and computes one way only: the value it computes
PORT_FIXED = {"hidden_act": "silu", "partial_rotary_factor": 1.0,
              "norm_before_gate": True}


def load(kind: str, name: str) -> dict:
    """``laimr_bench/<kind>/<name>.json``."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def dims(conf: dict) -> dict:
    """``conf["model"]`` under the port's field names where
    ``conf["port_fields"]`` maps a key, under its own name otherwise:
    the one spelling that the references and the counts read."""
    fields = conf["port_fields"]
    return {fields.get(k, k): v for k, v in conf["model"].items()}


def _port_norm_eps(norm: str) -> float:
    import inspect

    from repro_torch.models import layers
    fn = layers.rmsnorm if norm == "rmsnorm" else layers.layernorm
    return inspect.signature(fn).parameters["eps"].default


def arch_config(conf: dict):
    """The port's ``ArchConfig`` of ``conf["port_config"]`` with every
    number of ``conf["model"]`` put in through ``conf["port_fields"]``,
    and ``conf["dtype"]``. Raises where a key has no field and the port
    computes it otherwise than the file states (``PORT_FIXED``, the
    norm's epsilon), or where the family ``conf["layer_kind"]``
    (``families/<layer_kind>.py``) does not lay out the port's layers,
    or a kind of layer refuses its shape (its ``check``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_kinds
    fields = conf["port_fields"]
    model = conf["model"]
    for k in set(model) - set(fields):
        if k == "norm_eps":
            port = _port_norm_eps(model["norm"])
        elif k in PORT_FIXED:
            port = PORT_FIXED[k]
        else:
            raise KeyError(f"{conf['name']}: no port field for {k!r}")
        if model[k] != port:
            raise ValueError(f"{conf['name']}: {k} is {model[k]!r}; the "
                             f"port runs {port!r} only")
    # JSON has lists where the port's fields hold tuples
    changes = {fields[k]: tuple(v) if isinstance(v, list) else v
               for k, v in model.items() if k in fields}
    cfg = dataclasses.replace(get_config(conf["port_config"]),
                              dtype=conf["dtype"], **changes)
    family = conf["layer_kind"]
    try:
        want = families.kinds(family, vars(cfg))
        if layer_kinds(cfg) != want:
            raise ValueError(f"the port's layers are {layer_kinds(cfg)}, "
                             f"not {family}: {want}")
        for kind in dict.fromkeys(want):
            getattr(families.get(kind), "check", lambda cfg: None)(cfg)
    except ValueError as e:
        raise ValueError(f"{conf['name']}: {e}") from None
    return cfg


# ------------------------------------------------------------------ weights
def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if key == "layers" else {})
    node[path[-1]] = value


def make_params(family: str, cfg, seed: int, device) -> dict:
    """The program's parameter tree of a stack of ``family`` (the
    configuration's ``layer_kind``; ``families.weights``), drawn from
    ``seed`` by a ``torch.Generator`` on ``device``: every random matrix
    is a view of one flat buffer filled by a single ``randn`` in the
    model dtype and scaled in place; then the fixed leaves in the
    family's order, norms and biases in float32 as the program keeps
    them (in the model dtype where the layer says so), or made from the
    same generator by the layer's own maker (the SSM's per-head
    constants)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rand, fixed = families.weights(family, cfg)
    total = sum(math.prod(s) for s, _ in rand.values())
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    at = 0
    for path, (shape, std) in rand.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(std)
        _put(tree, path, leaf)
        at += n
    for path, (what, shape, dtype_kind) in fixed:
        dt = dtype if dtype_kind == "model" else torch.float32
        if callable(what):
            val = what(gen, shape, device)
        elif what == "zeros":
            val = torch.zeros(shape, dtype=dt, device=device)
        elif what == "ones":
            val = torch.ones(shape, dtype=dt, device=device)
        else:
            raise ValueError(what)
        _put(tree, path, val)
    return tree


# ------------------------------------------------------------ deployment
def pool_specs(conf: dict, cell: dict) -> list[dict]:
    """The cell's LA-IMR deployments as plain numbers, in column order.

    A served cell has two: the card's replica, whose servers are the
    engine's ``slots``, each serving one request per full wave of
    ``service.wave_s`` seconds, and the upstream cloud pool of the same
    model it offloads to. The fleet cell has, per region, one model
    stream, ``edge_per_region`` edge pools and one cloud pool that the
    region's edge pools offload to. A server is busy one wave per
    request, so utilisation is U = lam_tilde * wave: the paper's Eq. 6
    with R_m = wave card-seconds and R_max = 1."""
    rep, up = conf["replica"], conf["upstream"]

    def pool(model, inst, tier, n, rtt, cost, wave):
        return {"model": model, "instance": inst, "tier": tier, "n": n,
                "l_ref": wave, "speedup": 1.0, "r_demand": wave,
                "r_max": 1.0, "background": 0.0, "rtt": rtt, "cost": cost,
                "gamma": rep["gamma"]}
    if "fleet" in cell:
        fl = cell["fleet"]
        wave = float(fl["service_s"])
        out = []
        for r in range(fl["regions"]):
            model = f"{conf['name']}.r{r}"
            out += [pool(model, f"h100-edge-{r}-{j}", "edge",
                         fl["edge_servers"], rep["net_rtt_s"], rep["cost"],
                         wave) for j in range(fl["edge_per_region"])]
            out.append(pool(model, f"h100-cloud-{r}", "cloud",
                            fl["cloud_servers"], up["net_rtt_s"],
                            up["cost"], wave))
        return out
    wave = float(cell["service"]["wave_s"])
    slots = int(cell["engine"]["slots"])
    return [pool(conf["name"], rep["instance"], rep["tier"], slots,
                 rep["net_rtt_s"], rep["cost"], wave),
            pool(conf["name"], up["instance"], up["tier"], up["n_replicas"],
                 up["net_rtt_s"], up["cost"], wave)]


def cluster(specs: list[dict]):
    """The program's ``Cluster`` of ``pool_specs``."""
    from repro_torch.core.catalogue import Cluster, Deployment
    from repro_torch.core.latency_model import InstanceClass, ModelProfile
    from repro_torch.core.scheduler import QualityClass
    models: dict = {}
    deps = []
    for p in specs:
        model = models.setdefault(p["model"], ModelProfile(
            name=p["model"], l_ref=p["l_ref"], r_demand=p["r_demand"],
            accuracy=0.5))
        inst = InstanceClass(name=p["instance"], speedup=p["speedup"],
                             r_max=p["r_max"], background=p["background"],
                             net_rtt=p["rtt"], cost=p["cost"],
                             tier=p["tier"])
        deps.append(Deployment(model, inst, QualityClass.BALANCED,
                               n_replicas=p["n"], n_max=p["n"],
                               gamma=p["gamma"]))
    return Cluster(deps)


def prompts(seed: int, n: int, length: int, vocab: int, device
            ) -> torch.Tensor:
    """(n, length) token ids drawn from ``seed`` on ``device`` in one
    call (a stream of its own, apart from the weights')."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(
        int(seed) ^ 0x5EED)
    return torch.randint(0, vocab, (n, length), generator=gen,
                         device=device, dtype=torch.int64)
