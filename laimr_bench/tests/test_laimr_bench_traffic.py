"""The benchmark's copy of the arrival generators draws what the
program's draw, and the general generator keeps every seed's set of
arrivals."""
import numpy as np
import pytest

from laimr_bench.traffic import generators, schedule
from repro_torch.core import workload

SEEDS = (0, 7, 2**31 + 11)


@pytest.mark.parametrize("seed", SEEDS)
def test_bounded_pareto_bursts_equal_the_program(seed):
    kw = dict(burst_rate=0.2, pareto_alpha=1.5, burst_lo=2.0, burst_hi=8.0,
              burst_duration=2.0)
    got = generators.bounded_pareto_bursts(10.0, 40.0, seed=seed, **kw)
    want = [a.t for a in workload.bounded_pareto_bursts(
        10.0, 40.0, "m", seed=seed, **kw)]
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_flash_crowd_equals_the_program(seed):
    kw = dict(t_start=20.0, duration=10.0, ramp=2.0)
    got = generators.flash_crowd_arrivals(500.0, 2500.0, 60.0, seed=seed,
                                          **kw)
    want = [a.t for a in workload.flash_crowd_arrivals(
        500.0, 2500.0, 60.0, "m", seed=seed, **kw)]
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_equals_the_program(seed):
    got = generators.poisson_arrivals(30.0, 20.0, seed=seed)
    want = [a.t for a in workload.poisson_arrivals(30.0, 20.0, "m",
                                                   seed=seed)]
    np.testing.assert_array_equal(got, np.asarray(want))


TRAFFIC = {"process": "bounded_pareto_bursts", "trace_seed": 3,
           "period_s": 40.0,
           "params": {"base_lam": 10.0, "burst_rate": 0.2,
                      "pareto_alpha": 1.5, "burst_lo": 2.0, "burst_hi": 8.0,
                      "burst_duration": 2.0}}


def test_the_period_is_the_process_drawn_from_the_trace_seed():
    want = generators.bounded_pareto_bursts(
        10.0, 40.0, seed=3, burst_rate=0.2, pareto_alpha=1.5,
        burst_lo=2.0, burst_hi=8.0, burst_duration=2.0)
    np.testing.assert_array_equal(schedule.arrivals(TRAFFIC, 40.0), want)


def test_a_longer_run_repeats_the_period():
    one = schedule.arrivals(TRAFFIC, 40.0)
    two = schedule.arrivals(TRAFFIC, 100.0)
    np.testing.assert_allclose(two[len(one):2 * len(one)] - 40.0, one)
    assert two[-1] < 100.0 and np.all(np.diff(two) >= 0)
    np.testing.assert_array_equal(schedule.arrivals(TRAFFIC, 10.0),
                                  one[one < 10.0])
