"""``h100_catalogue`` against the reference's ``tpu_catalogue``.

Both read ``*__decode_32k__single.json`` dry-run records and turn each
into a deployment whose L_m is the step's roofline bound. The bounds
differ only in their hardware figures (v5e: 197e12 FLOP/s, 819e9 B/s,
50e9 B/s of ICI; H100: ``launch.mesh``'s 989e12, 3.35e12 and 50e9), so
the reference is given the port's records with ``flops``, ``hlo_bytes``
and ``collective_bytes_total`` scaled by 197/989, 819/3350 and 50/50:
then both compute the same bound (to float64 rounding), and the two
catalogues must agree field for field, route identically under all five
policies and simulate the same burst trace to the same P50/P99 and
offloads. The instance class's name is the one field that differs
("h100-pod-slice" against "v5e-pod-slice").
"""
import json

import numpy as np
import pytest

from repro.core import catalogue as ref_catalogue
from repro.core.scheduler import QualityClass as RefQ
from repro_torch.configs.base import REFERENCE_IDS
from repro_torch.core import catalogue
from repro_torch.core.scheduler import QualityClass
from repro_torch.launch import mesh

POLICIES = ("route_best", "guarded_alg1", "safetail", "reliable", "hybrid")
SCALE = {"flops": 197e12 / mesh.PEAK_FLOPS_BF16,
         "hlo_bytes": 819e9 / mesh.HBM_BW,
         "collective_bytes_total": 50e9 / mesh.NET_BW}


def records(seed: int = 0) -> list[dict]:
    """Decode records of all ten archs drawn from a seed, one an error
    (left out by both) and one bound by each term."""
    rng = np.random.default_rng(seed)
    out = []
    for i, arch in enumerate(REFERENCE_IDS):
        rec = {"arch": arch, "shape": "decode_32k", "mesh": "single",
               "status": "ok",
               "flops": float(rng.uniform(1e9, 1e12)),
               "hlo_bytes": float(rng.uniform(1e9, 3e10)),
               "collective_bytes_total": int(rng.uniform(1e6, 1e9))}
        if i == 3:
            rec["flops"] = 5e14                      # compute-bound
        if i == 4:
            rec["collective_bytes_total"] = int(4e10)   # network-bound
        if i == 7:
            rec = {"arch": arch, "shape": "decode_32k", "mesh": "single",
                   "status": "error", "error": "x"}
        out.append(rec)
    return out


def write(dirpath, recs, scale=False) -> None:
    for rec in recs:
        rec = dict(rec)
        if scale and rec["status"] == "ok":
            for k, f in SCALE.items():
                rec[k] = rec[k] * f
        with open(dirpath / f"{rec['arch']}__decode_32k__single.json",
                  "w") as f:
            json.dump(rec, f)


@pytest.fixture
def both(tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    recs = records()
    write(port_dir, recs)
    write(ref_dir, recs, scale=True)
    # a record of another shape is not read
    (port_dir / "stablelm_3b__train_4k__single.json").write_text(
        json.dumps({"arch": "stablelm_3b", "status": "ok", "flops": 1.0,
                    "hlo_bytes": 1.0, "collective_bytes_total": 1}))
    return (catalogue.h100_catalogue(str(port_dir)),
            ref_catalogue.tpu_catalogue(str(ref_dir)))


def test_catalogues_agree_field_for_field(both):
    port, ref = both
    assert len(port) == len(ref) == len(REFERENCE_IDS) - 1
    for p, r in zip(port, ref):
        assert p.model.name == r.model.name
        assert p.model.l_ref == pytest.approx(r.model.l_ref, rel=1e-12)
        for f in ("r_demand", "accuracy", "kv_growth"):
            assert getattr(p.model, f) == getattr(r.model, f), f
        assert p.quality.name == r.quality.name
        assert p.instance.name == "h100-pod-slice"
        assert r.instance.name == "v5e-pod-slice"
        assert p.instance.r_max == pytest.approx(r.instance.r_max,
                                                 rel=1e-12)
        for f in ("speedup", "background", "net_rtt", "cost", "tier"):
            assert getattr(p.instance, f) == getattr(r.instance, f), f
        for f in ("n_replicas", "n_max", "gamma", "startup_delay"):
            assert getattr(p, f) == getattr(r, f), f
        for f in ("alpha", "beta", "mu"):
            assert getattr(p, f) == pytest.approx(getattr(r, f), rel=1e-12)
    assert port.deployments[next(iter(port.deployments))].instance.cost \
        == 256.0
    lanes = [d.quality for d in port]
    assert lanes.count(QualityClass.LOW_LATENCY) == 3
    assert lanes.count(QualityClass.PRECISE) == 3


def test_bound_takes_the_largest_term(tmp_path):
    rec = {"arch": "stablelm_3b", "status": "ok", "flops": 989e12 * 0.002,
           "hlo_bytes": 3.35e12 * 0.003, "collective_bytes_total":
           int(50e9 * 0.001)}
    (tmp_path / "stablelm_3b__decode_32k__single.json").write_text(
        json.dumps(rec))
    (d,) = list(catalogue.h100_catalogue(str(tmp_path)))
    assert d.model.l_ref == pytest.approx(0.003, rel=1e-12)


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        catalogue.h100_catalogue(str(tmp_path))


def fleet_requests(q_enum, request_cls):
    """The request set of ``examples/route_tpu_fleet.py``: 4 per lane."""
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for q in q_enum:
        for _ in range(4):
            t += float(rng.exponential(0.05))
            reqs.append(request_cls(model="any", quality=q, arrival=t,
                                    slo=2.0))
    return reqs, t


def route(cluster, policy, router_cls, params_cls, config_cls, reqs, t,
          **cfg):
    br = router_cls(cluster, params=params_cls(x=3.0),
                    config=config_cls(max_batch=12, policy=policy, **cfg))
    out = []
    for rq in reqs:
        out.extend(br.submit(rq, rq.arrival) or [])
    out.extend(br.flush(t))
    return [(d.req.quality.name, None if d.target_key is None
             else d.target_key.split("@")[0], d.outcome,
             round(d.predicted_latency, 9)) for d in out]


@pytest.mark.parametrize("policy", POLICIES)
def test_batch_router_decides_alike(both, policy):
    from repro.core.router import RouterParams as RefParams
    from repro.core.scheduler import Request as RefRequest
    from repro.serving import AdmissionConfig as RefConfig
    from repro.serving import BatchRouter as RefRouter
    from repro_torch.core.router import RouterParams
    from repro_torch.core.scheduler import Request
    from repro_torch.serving import AdmissionConfig, BatchRouter
    port, ref = both
    reqs, t = fleet_requests(QualityClass, Request)
    rreqs, rt = fleet_requests(RefQ, RefRequest)
    got = route(port, policy, BatchRouter, RouterParams, AdmissionConfig,
                reqs, t, device="cpu")
    want = route(ref, policy, RefRouter, RefParams, RefConfig, rreqs, rt)
    assert got == want


@pytest.mark.parametrize("policy", ["route_best", "guarded_alg1"])
def test_burst_simulation_alike(both, policy):
    from repro.core import ClusterSimulator as RefSim
    from repro.core import SimConfig as RefSimConfig
    from repro.core import bounded_pareto_bursts as ref_bursts
    from repro_torch.core import (ClusterSimulator, SimConfig,
                                  bounded_pareto_bursts)
    port, ref = both
    arr = bounded_pareto_bursts(8.0, 60.0, "stablelm_3b", seed=1)
    rarr = ref_bursts(8.0, 60.0, "stablelm_3b", seed=1)
    assert len(arr) == len(rarr)
    kw = dict(mode="laimr", seed=1, slo=2.0)
    if policy != "route_best":
        kw.update(admission_window=0.1, policy=policy)
    res = ClusterSimulator(port, SimConfig(
        admission_device="cpu", **kw)).run(arr)
    rres = RefSim(ref, RefSimConfig(**kw)).run(rarr)
    s, rs = res.summary(), rres.summary()
    assert s["n"] == rs["n"]
    assert s["p50"] == pytest.approx(rs["p50"], rel=1e-9)
    assert s["p99"] == pytest.approx(rs["p99"], rel=1e-9)
    assert res.offload_fast == rres.offload_fast
    assert len(res.scale_events) == len(rres.scale_events)
