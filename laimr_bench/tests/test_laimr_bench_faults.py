"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run at toy widths on the CPU (the plain
kernels; the look for a card skipped), with one fault planted in the
program: a decode step that returns its state unchanged, a token or an
admission answer altered where it is produced. The served cells' logit
limit is the cell's own. A clean run of the same cell is correct."""
import json

import pytest
import torch

from laimr_bench import common, run as bench_run
from laimr_bench.tests import tiny
from repro_torch.control.policies import guarded, safetail
from repro_torch.models import ssm
from repro_torch.serving import engine

CELLS = {"stablelm_3b.robot_burst": ("stablelm_3b", 16, 1),
         "mamba2_370m.robot_chat": ("mamba2_370m", 16, 6),
         "mamba2_370m.robot_history": ("mamba2_370m", 40, 4)}


def served(name, rate=60.0):
    arch, prompt, out = CELLS[name]
    run = tiny.make_run(tiny.served_cell(name, prompt, out, rate=rate),
                        tiny.conf(arch))
    bench_run.execute(run)
    return run


def correct(run) -> bool:
    return bench_run.result_line(run, [], common.device_info(
        torch.device("cpu")))["correct"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_clean_run_is_correct(name):
    run = served(name)
    assert correct(run), run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("name", ["mamba2_370m.robot_chat",
                                  "mamba2_370m.robot_history"])
def test_a_step_that_keeps_its_state_is_caught(name, monkeypatch):
    orig = ssm.decode_step

    def frozen(params, cfg, x, state):
        saved = {k: v.clone() for k, v in state.items()}
        out = orig(params, cfg, x, state)
        for k, v in saved.items():
            state[k].copy_(v)
        return out
    monkeypatch.setattr(ssm, "decode_step", frozen)
    run = served(name)
    assert not correct(run)
    assert run.checks["logit_gap"]["value"] > \
        run.checks["logit_gap"]["limit"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_an_altered_token_is_caught(name, monkeypatch):
    vocab = tiny.TINY_MODEL[CELLS[name][0]]["vocab_size"]
    out_len = CELLS[name][2]
    if out_len == 1:
        orig = engine.ServingEngine.generate

        def generate(self, prompts, steps):
            res = orig(self, prompts, steps)
            res.tokens[:, 0] = (res.tokens[:, 0] + 1) % vocab
            return res
        monkeypatch.setattr(engine.ServingEngine, "generate", generate)
    else:
        orig = engine.ServingEngine.step

        def step(self):
            tok = orig(self)
            tok[0] = (tok[0] + 1) % vocab
            self.current[0] = int(tok[0])
            return tok
        monkeypatch.setattr(engine.ServingEngine, "step", step)
    run = served(name)
    assert not correct(run)


def test_an_altered_admission_answer_is_caught(monkeypatch):
    orig = guarded.GuardedAlgorithm1Policy.decide
    calls = {"n": 0}

    def decide(self, reqs, t_now):
        dec = orig(self, reqs, t_now)
        calls["n"] += 1 if t_now > 0 else 0
        if calls["n"] == 5:
            up = int(self.table.upstream[int(dec.primary[0])])
            if dec.offload[0]:
                dec.primary[0], dec.offload[0] = 0, False
            else:
                dec.primary[0], dec.offload[0] = up, True
        return dec
    monkeypatch.setattr(guarded.GuardedAlgorithm1Policy, "decide", decide)
    run = served("mamba2_370m.robot_chat")
    assert run.checks["route_mismatched"]["value"] >= 1
    assert not correct(run)


def test_a_window_of_dropped_copies_in_the_fleet_is_caught(monkeypatch):
    orig = safetail.SafeTailRedundantPolicy.decide
    calls = {"n": 0}

    def decide(self, reqs, t_now):
        dec = orig(self, reqs, t_now)
        calls["n"] += 1
        if calls["n"] >= 3 and t_now > 0 and any(dec.duplicates) \
                and not calls.get("done"):
            dec.duplicates = tuple(() for _ in dec.duplicates)
            calls["done"] = True
        return dec
    monkeypatch.setattr(safetail.SafeTailRedundantPolicy, "decide", decide)
    cell = tiny.fleet_cell()
    cell["fleet"]["service_s"] = 0.08
    run = tiny.make_run(cell, tiny.conf("stablelm_3b"), seconds=3.0)
    bench_run.execute(run)
    assert run.state.outcomes["duplicate"] > 0
    assert run.checks["route_mismatched"]["value"] >= 1
    assert not correct(run)


def test_the_harness_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    rc = bench_run.main(["--workload", "stablelm_3b.robot_burst",
                         "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr().out
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines())
    json.loads((bench_run.BENCH / "workloads"
                / "stablelm_3b.robot_burst.json").read_text())
