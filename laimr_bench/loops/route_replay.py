"""The admission plane alone, at fleet scale: a recorded arrival trace
replayed through ``BatchRouter`` as fast as the plane takes it.

Set-up draws one period of the cell's trace and builds the fleet's
pools; the window replays the
period round after round, each round's timestamps shifted by the
period, until ``--seconds`` of wall time have passed, then closes the
last window. Requests of the robots' regions come in turn. Windows
close in trace time exactly as in the served loop, so every decision is
a function of the trace; no model runs. ``decisions_per_s`` is every
request the plane decided over the wall time of the window.

The plane's work is host work on one thread. Set-up's objects are
collected and frozen out of the collector's later passes, so that none
of them is walked inside the window. The process keeps the CPUs it was
given: the benchmark sets no affinity.
"""
from __future__ import annotations

import gc
import json
import math
import time

import numpy as np
import torch

from laimr_bench import replica
from laimr_bench.traffic import schedule


class Fleet:
    def __init__(self, run):
        from repro_torch.control.admission import DUPLICATE, OFFLOADED
        from repro_torch.core.router import RouterParams
        from repro_torch.serving.batch_router import (AdmissionConfig,
                                                      BatchRouter)
        self.run = run
        cell = run.cell
        self.dup, self.off = DUPLICATE, OFFLOADED
        self.pools = replica.pool_specs(run.conf, cell)
        self.cluster = replica.cluster(self.pools)
        self.models = sorted({p["model"] for p in self.pools})
        adm = cell["admission"]
        backend = "cuda" if run.device.type == "cuda" else "ref"

        def plane(policy):
            return BatchRouter(self.cluster, params=RouterParams(),
                               config=AdmissionConfig(
                                   window=adm["window_s"],
                                   max_batch=adm["max_batch"],
                                   backend=backend, device=str(run.device),
                                   policy=policy))
        self.period = float(cell["traffic"]["period_s"])
        self.trace = schedule.period(cell["traffic"])
        self.warm(plane)
        self.plane = plane(adm["policy"])
        self.index = self.plane.policy.table.index

    def warm(self, plane) -> None:
        """Both kernels the hybrid policy delegates to, at every row
        bucket of a window (8 to ``max_batch``): the routing library
        builds at its first launch."""
        from repro_torch.core.scheduler import QualityClass, Request
        cap = int(self.run.cell["admission"]["max_batch"])
        for policy in ("guarded_alg1", "safetail"):
            p = plane(policy)
            r = 8
            while r <= cap:
                for k in range(r):
                    p.submit(Request(model=self.models[k % len(self.models)],
                                     quality=QualityClass.BALANCED,
                                     arrival=0.0), 0.0)
                p.flush(0.0)
                r *= 2
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def record(self, decisions) -> None:
        idx, dup_code, off_code = self.index, self.dup, self.off
        for d in decisions:
            if d.outcome == dup_code:
                self.got_dup[-1] = idx[d.target_key]
                continue
            self.got_target.append(idx[d.target_key])
            self.got_off.append(d.outcome == off_code)
            self.got_dup.append(-1)
            self.got_g.append(d.predicted_latency)

    def window(self) -> None:
        from repro_torch.core.scheduler import QualityClass, Request
        run = self.run
        plane, win = self.plane, self.plane.cfg.window
        nm = len(self.models)
        models = self.models
        spans = run.spans
        self.got_target: list = []
        self.got_off: list = []
        self.got_dup: list = []
        self.got_g: list = []
        launches0 = _launches()
        trace = self.trace.tolist()
        quality = QualityClass.BALANCED
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        run.open_window(t0)
        trace_at = run.trace_at
        self.t0 = t0
        self.round_s: list = []
        deadline = t0 + run.seconds
        submitted = 0
        rounds = 0
        done = False
        while not done:
            self.round_s.append(time.perf_counter() - t0)
            off = rounds * self.period
            for a0 in trace:
                now = time.perf_counter()
                if now >= deadline:
                    done = True
                    break
                if now >= trace_at:
                    trace_at = math.inf
                    run.tick(now)
                a = a0 + off
                opened = plane.window_opened_at()
                if opened is not None and a >= opened + win:
                    s = time.perf_counter()
                    self.record(plane.flush(opened + win))
                    spans.add("admission", s, time.perf_counter())
                s = time.perf_counter()
                out = plane.submit(Request(model=models[submitted % nm],
                                           quality=quality, arrival=a), a)
                if out is not None:
                    self.record(out)
                    spans.add("admission", s, time.perf_counter())
                submitted += 1
            else:
                rounds += 1
        opened = plane.window_opened_at()
        if opened is not None:
            s = time.perf_counter()
            self.record(plane.flush(opened + win))
            spans.add("admission", s, time.perf_counter())
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        self.t_end = time.perf_counter()
        if run.trace_obj is not None:
            run.trace_obj.stop()
        self.submitted = submitted
        self.rounds = rounds
        self.launches = {k: v - launches0[k]
                         for k, v in _launches().items()}
        self.flushes = plane.flushes
        self.switches = getattr(plane.policy, "switches", 0)
        self.outcomes = dict(plane.outcomes)
        plane.check_conservation()
        gc.unfreeze()

    def arrivals(self) -> np.ndarray:
        """The timestamps of every request submitted, rounds shifted."""
        n = self.submitted
        m = len(self.trace)
        k = np.arange(n)
        return self.trace[k % m] + (k // m) * self.period

    def release(self) -> None:
        del self.plane


def _launches() -> dict:
    from repro_torch.kernels import routing_decide, routing_score
    return {"routing_score": routing_score.routing_score.launches,
            "routing_guard": routing_decide.routing_guard.launches,
            "routing_topk": routing_decide.routing_topk.launches,
            "routing_attain": routing_decide.routing_attain.launches}


def run_cell(run) -> None:
    fl = Fleet(run)
    run.state = fl
    fl.window()
    if run.device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    fl.release()
    decided = len(fl.got_target)
    run.attempted = fl.submitted
    run.failed = fl.submitted - decided
    run.e2e["decisions_per_s"] = decided / (fl.t_end - fl.t0)
    run.lines.append(json.dumps({
        "submitted": fl.submitted, "decided": decided,
        "rounds_completed": fl.rounds, "flushes": fl.flushes,
        "outcomes": fl.outcomes, "switches": fl.switches,
        "launches": fl.launches, "window_s": fl.t_end - fl.t0,
        "rounds_started_at_s": fl.round_s}))
    run.checks.update(check_routing(run, fl))


def check_routing(run, fl: Fleet) -> dict:
    from laimr_bench.reference import route_ref
    adm = run.cell["admission"]
    pools = route_ref.Pools(fl.pools)
    arr = fl.arrivals()
    models = [fl.models[k % len(fl.models)] for k in range(len(arr))]
    res = route_ref.replay(
        pools, adm["policy"], arr, models, adm["window_s"], adm["max_batch"],
        np.asarray(fl.got_target, np.int64), np.asarray(fl.got_off, bool),
        np.asarray(fl.got_dup, np.int64),
        got_g=np.asarray(fl.got_g, np.float64))
    run.lines.append(json.dumps({"route_ties": res["ties"],
                                 "route_differing": res["differing"],
                                 "widest_differing_margin":
                                 res["widest_differing_margin"],
                                 "widest_g_gap": res["widest_g_gap"],
                                 "reference_switches": res["switches"]}))
    return {"route_mismatched": {"value": res["mismatched"], "limit": 0},
            "switches_off_by": {"value": abs(res["switches"] - fl.switches),
                                "limit": 0}}
