"""``BENCHMARK.json`` keeps to the contract's form, and finds every file
the harness looks up by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "laimr_bench/run.py"]
    assert BENCH["paths"] == ["laimr_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_cell_reports_what_its_per_layer_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    assert {m["source"] for m in BENCH["end_to_end"]} <= {"host_clock",
                                                         "device_trace"}
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]], (m["name"], cell)
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert sum(cell in v for v in e2e.values()) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_bounds_and_layers():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    spec = json.loads((ROOT / "laimr_bench" / "workloads"
                       / f"{cell}.json").read_text())
    assert spec["config"] == w["config"] and spec["traffic_name"] == \
        w["traffic"] and spec["why"] == w["why"] and w["chips"] == 1
    assert (ROOT / "laimr_bench" / "loops" / f"{spec['loop']}.py").exists()
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).exists()
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (ROOT / "laimr_bench" / "metrics"
                    / f"{m['name']}.py").exists()


def test_configs_name_their_source_and_cuts():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["layers_run"] == conf["layers_published"]
