"""Capacity planning & routing — the paper's Eq. (23) optimisation.

    min_{N, x}  max_t L_t^(N)  +  beta * sum_mi c_mi * N_mi
    s.t.        assignment, capacity, SLO, stability, N integer >= 1.

The paper calls the g(N) objective 'closed-form, differentiable ...
handed for automatic replica-layout tuning'. We provide both solvers:

* :func:`plan_exhaustive` — exact over the (small) integer lattice up to
  n_max per deployment, with traffic split per model across its
  deployments by the same argmin rule the router uses. Ground truth for
  tests and for the paper-scale problem (a handful of pools).
* :func:`plan_greedy` — marginal-value greedy: start at the stability
  floor, repeatedly add the replica with the best latency-reduction per
  cost until the SLO is met everywhere or the budget caps out. This is
  the 'flattens rapidly once rho <= 0.3' observation (§III-G) turned
  into an allocator; it matches the exhaustive optimum on every test
  instance we generate (see tests/test_capacity.py).

Host-side numpy, as in the reference package: the planner runs per
decision in Python, never on the card.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.core.catalogue import Cluster, Deployment
from repro_torch.core.latency_model import g_fixed_replicas_np
from repro_torch.core.queueing import min_stable_replicas


@dataclasses.dataclass
class Plan:
    replicas: dict[str, int]            # deployment key -> N_mi
    objective: float                    # Eq. 23 value
    worst_latency: float
    cost: float
    feasible: bool                      # all SLOs met & stable


def _latency(dep: Deployment, lam: float, n: int) -> float:
    if lam <= 0.0:
        return float(dep.alpha) + dep.instance.net_rtt
    return float(g_fixed_replicas_np(lam, np.array([n]), dep.model,
                                     dep.instance, dep.gamma)[0])


def _slo(dep: Deployment, x: float) -> float:
    return x * (dep.model.l_ref / dep.instance.speedup)


def evaluate(cluster: Cluster, lam_by_model: dict[str, float],
             replicas: dict[str, int], beta: float, x: float) -> Plan:
    """Objective Eq. 23 for a given layout; traffic per model is split
    across that model's deployments proportional to pool capacity."""
    worst, cost, feasible = 0.0, 0.0, True
    for model_name, lam in lam_by_model.items():
        deps = cluster.for_model(model_name)
        caps = np.array([replicas[d.key] * d.mu for d in deps])
        shares = caps / caps.sum() if caps.sum() > 0 else np.ones(len(deps)) / len(deps)
        for d, share in zip(deps, shares):
            n = replicas[d.key]
            g = _latency(d, lam * float(share), n)
            worst = max(worst, g)
            if not np.isfinite(g) or g > _slo(d, x):
                feasible = False
    for d in cluster:
        cost += d.instance.cost * replicas[d.key]
    obj = worst + beta * cost if np.isfinite(worst) else np.inf
    return Plan(dict(replicas), obj, worst, cost, feasible)


def plan_exhaustive(cluster: Cluster, lam_by_model: dict[str, float],
                    beta: float = 2.5, x: float = 2.25,
                    prefer_feasible: bool = True) -> Plan:
    """Exact search over N in [1, n_max]^|deployments| (paper-scale only)."""
    deps = list(cluster)
    best: Optional[Plan] = None
    for combo in itertools.product(*[range(1, d.n_max + 1) for d in deps]):
        layout = {d.key: n for d, n in zip(deps, combo)}
        plan = evaluate(cluster, lam_by_model, layout, beta, x)
        if best is None:
            best = plan
            continue
        if prefer_feasible and plan.feasible != best.feasible:
            if plan.feasible:
                best = plan
            continue
        if plan.objective < best.objective:
            best = plan
    assert best is not None
    return best


def plan_greedy(cluster: Cluster, lam_by_model: dict[str, float],
                beta: float = 2.5, x: float = 2.25,
                max_steps: int = 512) -> Plan:
    """Marginal-value greedy allocator.

    Start every pool at its stability floor (Eq. 25), then add whichever
    single replica most reduces the objective; stop when no addition
    helps or everything is feasible and additions only add cost.
    """
    deps = list(cluster)
    layout: dict[str, int] = {}
    for d in deps:
        lam = lam_by_model.get(d.model.name, 0.0)
        caps = sum(dd.n_max * dd.mu for dd in cluster.for_model(d.model.name))
        share = (d.n_max * d.mu / caps) if caps > 0 else 1.0
        # host planning: the stability floor is computed on the CPU
        floor = int(min_stable_replicas(lam * share, d.mu, device="cpu")) \
            if lam > 0 else 1
        layout[d.key] = max(1, min(floor, d.n_max))
    plan = evaluate(cluster, lam_by_model, layout, beta, x)
    for _ in range(max_steps):
        candidates: list[Plan] = []
        for d in deps:
            if layout[d.key] >= d.n_max:
                continue
            trial = dict(layout)
            trial[d.key] += 1
            candidates.append(evaluate(cluster, lam_by_model, trial, beta, x))
        if not candidates:
            break
        if not plan.feasible:
            # Feasibility first: march down worst-latency until every SLO
            # holds, even if the cost term makes the objective worse.
            best = min(candidates,
                       key=lambda p: (not p.feasible, p.worst_latency,
                                      p.objective))
            if best.feasible or best.worst_latency < plan.worst_latency - 1e-12:
                layout, plan = dict(best.replicas), best
                continue
            break
        best = min(candidates, key=lambda p: p.objective)
        if best.feasible and best.objective < plan.objective - 1e-12:
            layout, plan = dict(best.replicas), best
            continue
        break
    return plan
