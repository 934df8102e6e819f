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
    norm's epsilon), or where the port's layers are not of
    ``conf["layer_kind"]``."""
    from repro_torch.configs import get_config
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
    changes = {fields[k]: v for k, v in model.items() if k in fields}
    cfg = dataclasses.replace(get_config(conf["port_config"]),
                              dtype=conf["dtype"], **changes)
    if layer_kind(cfg) != conf["layer_kind"]:
        raise ValueError(f"{conf['name']}: the port's layers are "
                         f"{layer_kind(cfg)}, not {conf['layer_kind']}")
    if cfg.layer_pattern == ("attn",) and cfg.head_dim * cfg.n_heads \
            != cfg.d_model:
        raise ValueError(f"{conf['name']}: heads do not tile d_model")
    return cfg


def layer_kind(cfg) -> str:
    (kind,) = set(cfg.layer_pattern)
    return kind


# ------------------------------------------------------------------ weights
def _shapes(cfg) -> tuple[dict, list]:
    """(random leaves: path -> (shape, std), fixed leaves: [(path, value
    maker)]) of the program's parameter tree for a uniform stack of
    ``attn`` or ``mamba2`` layers."""
    d, v = cfg.d_model, cfg.vocab_size
    rand: dict = {("embed",): ((v, d), d ** -0.5)}
    fixed: list = []
    kind = layer_kind(cfg)
    for i in range(cfg.n_layers):
        p = ("layers", i)
        if kind == "attn":
            h, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
            rand[p + ("attn", "wq")] = ((d, h, hd), d ** -0.5)
            rand[p + ("attn", "wk")] = ((d, hkv, hd), d ** -0.5)
            rand[p + ("attn", "wv")] = ((d, hkv, hd), d ** -0.5)
            rand[p + ("attn", "wo")] = ((h, hd, d), (h * hd) ** -0.5)
            rand[p + ("mlp", "wi")] = ((d, f), d ** -0.5)
            rand[p + ("mlp", "wg")] = ((d, f), d ** -0.5)
            rand[p + ("mlp", "wo")] = ((f, d), f ** -0.5)
            for norm in ("norm1", "norm2"):
                fixed += _norm(cfg, p + (norm,), d)
        elif kind == "mamba2":
            d_in = cfg.ssm_expand * d
            heads = d_in // cfg.ssm_head_dim
            gn = cfg.ssm_groups * cfg.ssm_state
            conv_ch = d_in + 2 * gn
            rand[p + ("mixer", "in_proj")] = ((d, 2 * d_in + 2 * gn + heads),
                                              d ** -0.5)
            rand[p + ("mixer", "conv_w")] = ((cfg.conv_width, conv_ch), 0.1)
            rand[p + ("mixer", "out_proj")] = ((d_in, d), d_in ** -0.5)
            fixed += _norm(cfg, p + ("norm1",), d)
            fixed += [(p + ("mixer", "conv_b"), ("zeros", (conv_ch,), "model")),
                      (p + ("mixer", "dt_bias"), ("dt_bias", (heads,), None)),
                      (p + ("mixer", "a_log"), ("a_log", (heads,), None)),
                      (p + ("mixer", "d_skip"), ("ones", (heads,), None)),
                      (p + ("mixer", "norm", "scale"), ("zeros", (d_in,), None))]
        else:
            raise ValueError(f"no weights for layer kind {kind}")
    fixed += _norm(cfg, ("final_norm",), d)
    if not cfg.tie_embeddings:
        rand[("lm_head",)] = ((d, v), d ** -0.5)
    return rand, fixed


def _norm(cfg, path: tuple, d: int) -> list:
    if cfg.norm == "rmsnorm":
        return [(path + ("scale",), ("zeros", (d,), None))]
    return [(path + ("scale",), ("ones", (d,), None)),
            (path + ("bias",), ("zeros", (d,), None))]


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


def make_params(cfg, seed: int, device) -> dict:
    """The program's parameter tree, drawn from ``seed`` by a
    ``torch.Generator`` on ``device``: every random matrix is a view of
    one flat buffer filled by a single ``randn`` in the model dtype and
    scaled in place; norms, biases and the SSM's per-head constants
    (the published Mamba-2 init: dt log-uniform in [1e-3, 1e-1], A =
    -U(1, 16)) in float32 as the program keeps them."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rand, fixed = _shapes(cfg)
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
    for path, (what, shape, kind) in fixed:
        dt = dtype if kind == "model" else torch.float32
        if what == "zeros":
            val = torch.zeros(shape, dtype=dt, device=device)
        elif what == "ones":
            val = torch.ones(shape, dtype=dt, device=device)
        elif what == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            dt_ = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
            val = dt_ + torch.log(-torch.expm1(-dt_))
        elif what == "a_log":
            val = torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen,
                                                    device=device))
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
