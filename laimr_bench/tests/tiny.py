"""Cells of the benchmark cut to a size the CPU runs in seconds, with
the plain kernels: the same code paths as on the card, at toy widths."""
from __future__ import annotations

import copy

import torch

from laimr_bench import replica, run as bench_run

TINY_MODEL = {
    "stablelm_3b": dict(num_hidden_layers=2, hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=4,
                        head_dim=16, intermediate_size=128, vocab_size=256),
    "mamba2_370m": dict(n_layer=2, d_model=64, headdim=16, d_state=16,
                        vocab_size=256),
}


def conf(arch: str) -> dict:
    c = copy.deepcopy(replica.load("configs", arch))
    c["dtype"] = "float32"
    c["model"].update(TINY_MODEL[arch])
    return c


def served_cell(name: str, prompt: int, output: int, slots: int = 4,
                rate: float = 40.0) -> dict:
    c = copy.deepcopy(replica.load("workloads", name))
    c["lengths"] = {"prompt": prompt, "output": output}
    c["engine"] = {"slots": slots, "max_len": prompt + output}
    c["traffic"] = {"process": "poisson", "trace_seed": 3, "period_s": 2.0,
                    "params": {"lam": rate}}
    c["service"] = {"wave_s": 0.05}
    c["check"].update(tokens=24, block_rows=4)
    return c


def fleet_cell() -> dict:
    c = copy.deepcopy(replica.load("workloads", "stablelm_3b.fleet_route"))
    c["traffic"]["period_s"] = 12.0
    c["traffic"]["params"].update(base_lam=400.0, peak_lam=4000.0,
                                  t_start=5.0, duration=1.0, ramp=0.2)
    return c


def make_run(cell: dict, conf_: dict, seed: int = 2**31 + 5,
             seconds: float = 2.0) -> bench_run.Run:
    return bench_run.Run(name=cell["name"], cell=cell, conf=conf_,
                         seed=seed, seconds=seconds, trace=False,
                         device=torch.device("cpu"), kernels="ref")
