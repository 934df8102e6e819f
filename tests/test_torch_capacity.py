"""The port's Eq. (23) capacity planner against the JAX package's.

``repro_torch.core.capacity`` is host numpy over the port's own latency
law and stability floor. On the instances of ``tests/test_capacity.py``
both packages must return equal ``Plan``s: the same replica layout,
feasibility, objective, worst latency and cost.
"""
import dataclasses

import pytest

import repro.core.capacity as j_cap
import repro.core.catalogue as j_cat
import repro.core.latency_model as j_lm
import repro.core.scheduler as j_sched
import repro_torch.core as t_core
import repro_torch.core.capacity as t_cap
import repro_torch.core.catalogue as t_cat
import repro_torch.core.latency_model as t_lm
import repro_torch.core.scheduler as t_sched

PKGS = ((j_cap, j_cat, j_lm, j_sched), (t_cap, t_cat, t_lm, t_sched))


def small_cluster(cat, lm, sched, n_max=4):
    return cat.Cluster([
        cat.Deployment(lm.YOLOV5M, lm.PI4_EDGE, sched.QualityClass.BALANCED,
                       n_max=n_max),
        cat.Deployment(lm.YOLOV5M, lm.CLOUD, sched.QualityClass.BALANCED,
                       n_max=n_max),
    ])


def clusters(name: str):
    """Each package's twin of ``name``: "paper" or an n_max for the
    two-pool cluster."""
    out = []
    for _, cat, lm, sched in PKGS:
        out.append(cat.paper_cluster(n_edge_max=4, n_cloud_max=4)
                   if name == "paper"
                   else small_cluster(cat, lm, sched, n_max=int(name)))
    return out


def both(fn_name: str, cluster: str, *args, **kw):
    """``fn_name`` of each package's capacity module on its own twin of
    ``cluster``; returns (jax plan, port plan)."""
    return [getattr(cap, fn_name)(cl, *args, **kw)
            for (cap, *_), cl in zip(PKGS, clusters(cluster))]


def assert_same_plan(got, want) -> None:
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("lam,n_each", [(50.0, 1), (0.5, 2), (1.0, 3)])
def test_evaluate(lam, n_each):
    want, got = [cap.evaluate(cl, {"yolov5m": lam},
                              {d.key: n_each for d in cl}, 2.5, 2.25)
                 for (cap, *_), cl in zip(PKGS, clusters("4"))]
    assert_same_plan(got, want)


@pytest.mark.parametrize("lam", [1.0, 3.0, 6.0])
def test_plan_exhaustive_small(lam):
    want, got = both("plan_exhaustive", "4", {"yolov5m": lam})
    assert_same_plan(got, want)


@pytest.mark.parametrize("lam,n_max,beta", [
    (1.0, 4, 2.5), (3.0, 4, 2.5), (6.0, 4, 2.5), (1.0, 8, 2.5),
    (8.0, 8, 2.5), (3.0, 8, 50.0), (3.0, 8, 0.01)])
def test_plan_greedy(lam, n_max, beta):
    want, got = both("plan_greedy", str(n_max), {"yolov5m": lam},
                     beta=beta)
    assert_same_plan(got, want)


def test_paper_cluster_plan():
    lam = {"efficientdet": 8.0, "yolov5m": 3.0, "faster_rcnn": 1.0}
    want, got = both("plan_greedy", "paper", lam)
    assert got.feasible
    assert_same_plan(got, want)


def test_core_exports_the_planner():
    assert t_core.plan_greedy is t_cap.plan_greedy
    assert t_core.plan_exhaustive is t_cap.plan_exhaustive
    assert t_core.evaluate is t_cap.evaluate
