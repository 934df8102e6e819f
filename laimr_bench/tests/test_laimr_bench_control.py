"""The controls come out not correct: the reference in the precision
below the configuration's, put in the program's place.

At toy widths on the CPU (the program in float32 there, so its own gap
is nought): the fp8 control puts other tokens first, and the bfloat16
routing control decides the fleet's windows otherwise. At the cells' own
size on the card (``python3 laimr_bench/control.py``, readings in
``PERF.md``) the control's widest gap lies above each served cell's
limit; the test marked ``cuda`` repeats that for one seed."""
import json

import pytest
import torch

from laimr_bench import control, replica
from laimr_bench.run import Run
from laimr_bench.tests import tiny


@pytest.mark.parametrize("name,arch,out", [
    ("stablelm_3b.robot_burst", "stablelm_3b", 1),
    ("mamba2_370m.robot_history", "mamba2_370m", 4)])
def test_the_fp8_control_departs_from_the_reference(name, arch, out):
    cell = tiny.served_cell(name, 24, out, rate=60.0)
    cell["check"]["tokens"] = 96
    row = control.served(tiny.make_run(cell, tiny.conf(arch)), True)
    assert row["logit_gap"] < 1e-4
    assert row["control_logit_gap"] > 100 * max(row["logit_gap"], 1e-6)


def test_the_bf16_routing_control_decides_otherwise():
    cell = tiny.fleet_cell()
    cell["fleet"]["service_s"] = 0.08
    row = control.fleet(tiny.make_run(cell, tiny.conf("stablelm_3b"),
                                      seconds=2.0), True)
    assert row["route_mismatched"] == 0
    assert row["control_route_mismatched"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stablelm_3b.robot_burst",
                                  "mamba2_370m.robot_chat",
                                  "mamba2_370m.robot_history"])
def test_on_the_card_the_control_fails_the_cells_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    cell = replica.load("workloads", name)
    conf = replica.load("configs", cell["config"])
    run = Run(name=name, cell=cell, conf=conf, seed=7, seconds=10.0,
              trace=False, device=torch.device("cuda", 0))
    row = control.served(run, True)
    limit = cell["check"]["logit_gap_limit"]
    assert row["logit_gap"] <= limit < row["control_logit_gap"], \
        json.dumps(row)
