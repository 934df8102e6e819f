"""The port's bucketed twin over the full scenario x config matrix.

Six scenarios (``test_sim_golden.SCENARIOS``) by six configs (scalar
Algorithm 1 and both windowed policies, one pod and two): each cell
runs the port's twin on the CPU, held to the port's event loop within
``jaxsim.TOLERANCES`` and to the JAX twin within ``PARITY_RTOL``
(``n_arrivals`` and ``offload_fast`` exact). The reference runs this
matrix only under ``-m slow``; the port runs it in tier 1, in a file of
its own so that it lands on its own worker.
"""
import pytest

import test_sim_golden as jsg
from test_torch_jaxsim import (assert_equivalent, assert_parity,
                               jax_twin_run, port_run, port_twin)

CONFIGS = [
    pytest.param(0.0, "route_best", 1, id="scalar"),
    pytest.param(0.0, "route_best", 2, id="scalar-pods2"),
    pytest.param(0.1, "route_best", 1, id="route_best-w0.1"),
    pytest.param(0.1, "guarded_alg1", 1, id="guarded-w0.1"),
    pytest.param(0.1, "route_best", 2, id="route_best-w0.1-pods2"),
    pytest.param(0.1, "guarded_alg1", 2, id="guarded-w0.1-pods2"),
]


@pytest.mark.parametrize("window,policy,pods", CONFIGS)
@pytest.mark.parametrize("name", jsg.SCENARIOS)
def test_within_tolerances_of_the_event_loop(name, window, policy, pods):
    oracle, n = port_run(name, window, policy, pods, "event")
    assert_equivalent(oracle, port_twin(name, window, policy, pods), n,
                      f"{name} w={window} {policy} pods={pods}")


@pytest.mark.parametrize("window,policy,pods", CONFIGS)
@pytest.mark.parametrize("name", jsg.SCENARIOS)
def test_parity_with_the_jax_twin(name, window, policy, pods):
    assert_parity(port_twin(name, window, policy, pods),
                  jax_twin_run(name, window, policy, pods),
                  f"{name} w={window} {policy} pods={pods}")


def largest_gaps() -> dict:
    """The largest relative gaps over the matrix: the port's twin
    against the JAX twin (P50, P99, per sample) and against the port's
    event loop (P50, P99, and the offload rate's absolute gap)."""
    import numpy as np
    worst = {}
    for name in jsg.SCENARIOS:
        for param in CONFIGS:
            window, policy, pods = param.values
            got = port_twin(name, window, policy, pods)
            want = jax_twin_run(name, window, policy, pods)
            oracle, n = port_run(name, window, policy, pods, "event")
            gaps = {
                "jax_p50": abs(got.percentile(50) / want.percentile(50) - 1),
                "jax_p99": abs(got.percentile(99) / want.percentile(99) - 1),
                "jax_sample": float(np.max(
                    np.abs(got.latency_trace / want.latency_trace - 1))),
                "jax_offload": abs(got.offload_fast - want.offload_fast),
                "event_p50": abs(got.percentile(50)
                                 / oracle.percentile(50) - 1),
                "event_p99": abs(got.percentile(99)
                                 / oracle.percentile(99) - 1),
                "event_offload": abs(got.offload_fast
                                     - oracle.offload_fast) / n}
            for k, v in gaps.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


if __name__ == "__main__":
    # PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu python \
    #     tests/test_torch_jaxsim_matrix.py
    print(largest_gaps())
