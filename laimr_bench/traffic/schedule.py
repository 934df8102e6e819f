"""The one general traffic generator: a cell's ``traffic`` parameters in,
arrival times out.

A cell names an arrival process of ``generators`` and its parameters,
a ``trace_seed`` and a ``period_s``. The process is drawn once from the
trace seed over one period, and the period repeats to fill the run. So
every run offers the same arrivals, whatever its ``--seed``, which draws
the prompts and the weights. A tail read from a handful of bursts
swings with where the bursts fall: with the period rotated by a seed,
the served cells' 95th percentiles spread by up to a quarter between
seeds, far more than between two runs of one seed.
"""
from __future__ import annotations

import numpy as np

from laimr_bench.traffic import generators

PROCESSES = {
    "bounded_pareto_bursts": generators.bounded_pareto_bursts,
    "flash_crowd": generators.flash_crowd_arrivals,
    "poisson": generators.poisson_arrivals,
}


def period(traffic: dict) -> np.ndarray:
    """One period of the cell's arrival process, from its trace seed."""
    fn = PROCESSES[traffic["process"]]
    return fn(horizon=float(traffic["period_s"]),
              seed=int(traffic["trace_seed"]), **traffic["params"])


def arrivals(traffic: dict, seconds: float) -> np.ndarray:
    """Arrival times on [0, seconds): the period, repeated."""
    span = float(traffic["period_s"])
    one = period(traffic)
    reps = int(np.ceil(seconds / span))
    ts = np.concatenate([one + k * span for k in range(reps)])
    return ts[ts < seconds]
