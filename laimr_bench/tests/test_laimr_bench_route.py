"""The routing reference replays the port's plain route (the fused
policies on ``backend="ref"``) decision for decision: the served cell's
``guarded_alg1`` and the fleet's ``hybrid`` (guard steady, SafeTail's
copies in bursts), driven by the benchmark's own loops on the CPU."""
import numpy as np
import pytest

from laimr_bench import run as bench_run
from laimr_bench.reference import route_ref
from laimr_bench.tests import tiny


def fleet_run(seed=2**31 + 9):
    cell = tiny.fleet_cell()
    cell["fleet"]["service_s"] = 0.08
    run = tiny.make_run(cell, tiny.conf("stablelm_3b"), seed=seed,
                        seconds=3.0)
    bench_run.execute(run)
    return run


def test_fleet_decisions_equal_the_program():
    run = fleet_run()
    out = run.state.outcomes
    assert out["offloaded"] > 0 and out["duplicate"] > 0
    assert run.state.switches >= 2
    assert run.checks["route_mismatched"]["value"] == 0
    assert run.checks["switches_off_by"]["value"] == 0


@pytest.mark.parametrize("rate", (40.0, 160.0))
def test_served_decisions_equal_the_program(rate):
    cell = tiny.served_cell("mamba2_370m.robot_chat", 16, 3, rate=rate)
    cell["check"]["logit_gap_limit"] = 1.0
    run = tiny.make_run(cell, tiny.conf("mamba2_370m"))
    bench_run.execute(run)
    st = run.state
    if rate > 100:
        assert np.count_nonzero(st.outcome == 2) > 0
    assert run.checks["route_mismatched"]["value"] == 0


def test_windows_close_as_the_loops_close_them():
    arr = np.array([0.0, 0.004, 0.011, 0.012, 0.013, 0.05])
    got = route_ref.windows(arr, 0.01, 2)
    assert got == [(0.004, 0, 2), (0.012, 2, 4), (0.013 + 0.01, 4, 5),
                   (0.05 + 0.01, 5, 6)]


def test_sliding_rate_counts_the_last_second():
    tel = route_ref.Sliding(2)
    tel.add(np.array([3, 0]), 0.0)
    tel.add(np.array([1, 2]), 0.5)
    np.testing.assert_array_equal(tel.rates(1.0), [4.0, 2.0])
    np.testing.assert_array_equal(tel.rates(1.2), [1.0, 2.0])
