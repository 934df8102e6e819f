"""Open-loop serving of one replica behind LA-IMR admission, wave by
wave.

Requests fall due on the cell's arrival schedule whatever the replica
is doing. Each is submitted to the port's admission plane
(``BatchRouter.submit`` / ``flush``, the cell's policy, routing on the
card) at its own due time in trace time, so every decision is a
function of the schedule and never of the replica's speed: a window is
flushed at ``opened + window`` before any later arrival, or when
``max_batch`` requests wait. The plane routes without slot binding; a
request admitted to the replica joins its queue, an offloaded one goes
to the upstream pool, which the benchmark does not run, and is counted.

Whenever the replica is idle and requests wait, the oldest ``slots`` of
them form a wave: ``ServingEngine.generate(prompts, 1)`` (prefill and
first token), then ``ServingEngine.step()`` for each further token,
admission going on between steps; after the wave the slots are
released. The engine takes one prompt length and one step count per
batch and cannot prefill into a free slot while others decode, so a
request that falls due during a wave waits for the next.

Times are taken from when a request was due: time to first token and
to its last token, for every request that the replica served.
"""
from __future__ import annotations

import collections
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from laimr_bench import replica
from laimr_bench.traffic import schedule

#: outcome codes of the per-request arrays
ADMITTED, OFFLOADED = 1, 2


class Wave(NamedTuple):
    """One wave: its rows, prefill seconds, decode steps and their
    seconds, and its start and end on the ``perf_counter`` clock."""

    b: int
    prefill_s: float
    steps: int
    decode_s: float
    start: float
    end: float


class Served:
    """State of one served cell, from set-up to the check."""

    def __init__(self, run):
        from repro_torch.control.admission import (ADMITTED as A,
                                                   DUPLICATE, OFFLOADED as O)
        from repro_torch.core.router import RouterParams
        from repro_torch.serving.batch_router import (AdmissionConfig,
                                                      BatchRouter)
        from repro_torch.serving.engine import ServingEngine
        self.run = run
        cell, conf = run.cell, run.conf
        self.codes = {A: ADMITTED, O: OFFLOADED}
        self.dup = DUPLICATE
        self.cfg = replica.arch_config(conf)
        eng = cell["engine"]
        self.slots, self.max_len = int(eng["slots"]), int(eng["max_len"])
        self.prompt_len = int(cell["lengths"]["prompt"])
        self.out_len = int(cell["lengths"]["output"])
        self.params = replica.make_params(conf["layer_kind"], self.cfg,
                                          run.seed, run.device)
        self.engine = ServingEngine(self.cfg, self.params, self.slots,
                                    self.max_len, device=run.device,
                                    kernels=run.kernels)
        self.pools = replica.pool_specs(conf, cell)
        self.cluster = replica.cluster(self.pools)
        adm = cell["admission"]
        backend = "cuda" if run.device.type == "cuda" else "ref"

        def plane():
            return BatchRouter(self.cluster, params=RouterParams(),
                               config=AdmissionConfig(
                                   window=adm["window_s"],
                                   max_batch=adm["max_batch"],
                                   backend=backend, device=str(run.device),
                                   policy=adm["policy"]))
        self.make_plane = plane
        self.waves: list = []          # Wave
        self.load(schedule.arrivals(cell["traffic"], run.seconds))
        self.warm()
        self.plane = plane()
        self.replica_col = 0

    def load(self, arrivals: np.ndarray, slo=None) -> None:
        """The requests of a window: one per arrival, its prompt drawn
        from the run's seed; ``slo`` overrides every request's budget."""
        from repro_torch.core.scheduler import QualityClass, Request
        run = self.run
        self.arrivals = arrivals
        n = len(arrivals)
        self.tokens_in = replica.prompts(run.seed, n, self.prompt_len,
                                         self.cfg.vocab_size, run.device)
        self.outcome = np.zeros(n, np.int8)
        self.target = np.full(n, -1, np.int16)
        self.pred = np.full(n, np.nan)
        self.first_t = np.full(n, np.nan)
        self.last_t = np.full(n, np.nan)
        self.served = np.full((n, self.out_len), -1, np.int64)
        model = self.pools[0]["model"]
        self.reqs = [Request(model=model, quality=QualityClass.BALANCED,
                             arrival=float(a), slo=slo) for a in arrivals]

    # ------------------------------------------------------------ set-up
    def warm(self) -> None:
        """Every shape the cell's traffic uses: waves of 1, 2, 4, ... and
        ``slots`` prompts (decode steps are always ``slots`` rows), and a
        throwaway plane's flushes (the routing library builds at its
        first launch)."""
        from repro_torch.core.scheduler import QualityClass, Request
        warm_plane = self.make_plane()
        model = self.pools[0]["model"]
        for k in range(3):
            warm_plane.submit(Request(model=model,
                                      quality=QualityClass.BALANCED,
                                      arrival=0.001 * k), 0.001 * k)
            warm_plane.flush(0.001 * k)
        sizes = sorted({min(self.slots, 1 << j)
                        for j in range(self.slots.bit_length() + 1)})
        tokens = replica.prompts(self.run.seed + 1, self.slots,
                                 self.prompt_len, self.cfg.vocab_size,
                                 self.run.device)
        for b in sizes:
            self.engine.generate(tokens[:b], 1)
            for _ in range(min(2, self.out_len - 1)):
                self.engine.step()
            for k in range(b):
                self.engine.release(k)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    # ------------------------------------------------------------ window
    def record(self, decisions) -> None:
        for d in decisions:
            if d.outcome == self.dup:
                continue
            idx = self.next_decided
            self.next_decided += 1
            if d.req is not self.reqs[idx]:
                raise RuntimeError("admission decided out of order")
            code = self.codes[d.outcome]
            col = self.plane.policy.table.index[d.target_key]
            self.outcome[idx] = code
            self.target[idx] = col
            self.pred[idx] = d.predicted_latency
            if code == ADMITTED and col == self.replica_col:
                self.waiting.append(idx)

    def admit_due(self, now: float) -> None:
        """Submit every request due by ``now`` (trace time), each
        preceded by the timer flush its window owes; then the timer
        flush of the open window if it is due."""
        plane, arr, win = self.plane, self.arrivals, self.plane.cfg.window
        spans = self.run.spans
        self.run.tick(self.t0 + now)
        while self.i < len(arr) and arr[self.i] <= now:
            opened = plane.window_opened_at()
            t = arr[self.i]
            self.late_max = max(self.late_max, now - t)
            if opened is not None and t >= opened + win:
                s = time.perf_counter()
                self.record(plane.flush(opened + win))
                spans.add("admission", s, time.perf_counter())
            s = time.perf_counter()
            out = plane.submit(self.reqs[self.i], float(t))
            if out is not None:
                self.record(out)
                spans.add("admission", s, time.perf_counter())
            self.i += 1
        opened = plane.window_opened_at()
        if opened is not None and now >= opened + win:
            s = time.perf_counter()
            self.record(plane.flush(opened + win))
            spans.add("admission", s, time.perf_counter())

    def wave(self) -> None:
        run, eng = self.run, self.engine
        b = min(len(self.waiting), self.slots)
        idx = [self.waiting.popleft() for _ in range(b)]
        rows = torch.as_tensor(idx, device=run.device)
        s_pre = time.perf_counter()
        res = eng.generate(self.tokens_in[rows], 1)
        t_first = time.perf_counter()
        run.spans.add("prefill", s_pre, t_first)
        self.first_t[idx] = t_first - self.t0
        self.served[idx, 0] = res.tokens[:, 0]
        decode_s = 0.0
        for k in range(1, self.out_len):
            self.admit_due(time.perf_counter() - self.t0)
            s = time.perf_counter()
            tok = eng.step()
            e = time.perf_counter()
            run.spans.add("decode_step", s, e)
            decode_s += e - s
            self.served[idx, k] = tok[:b]
        self.last_t[idx] = time.perf_counter() - self.t0
        for k in range(b):
            eng.release(k)
        self.waves.append(Wave(b, t_first - s_pre, self.out_len - 1,
                               decode_s, s_pre, time.perf_counter()))

    def window(self) -> None:
        """The timed window: every arrival of [0, seconds) served or
        offloaded, the queue drained."""
        run = self.run
        self.i = 0
        self.next_decided = 0
        self.waiting: collections.deque = collections.deque()
        self.late_max = 0.0
        launches0 = _launches()
        self.t0 = time.perf_counter()
        run.open_window(self.t0)
        arr = self.arrivals
        while True:
            now = time.perf_counter() - self.t0
            self.admit_due(now)
            if self.waiting:
                self.wave()
            elif self.i >= len(arr) and self.plane.pending() == 0:
                break
            else:
                opened = self.plane.window_opened_at()
                nxt = min(arr[self.i] if self.i < len(arr) else np.inf,
                          opened + self.plane.cfg.window
                          if opened is not None else np.inf)
                s = time.perf_counter()
                wait = nxt - (s - self.t0)
                if wait > 0:
                    time.sleep(min(wait, 0.002))
                run.spans.add("await_arrival", s, time.perf_counter())
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        self.t_end = time.perf_counter()
        if run.trace_obj is not None:
            run.trace_obj.stop()
        self.launches = {k: v - launches0[k]
                         for k, v in _launches().items()}
        self.flushes = self.plane.flushes
        self.plane.check_conservation()

    def release(self) -> None:
        """Free the program's state: the engine, its cache, the plane."""
        del self.engine, self.plane
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def _launches() -> dict:
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     routing_decide, routing_score, ssd_scan)
    return {"flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attention.decode_attention.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches,
            "routing_score": routing_score.routing_score.launches,
            "routing_guard": routing_decide.routing_guard.launches,
            "routing_topk": routing_decide.routing_topk.launches,
            "routing_attain": routing_decide.routing_attain.launches}


# ------------------------------------------------------------------ run
def run_cell(run) -> None:
    st = Served(run)
    run.state = st
    st.window()
    if run.device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    st.release()
    summarize(run, st)
    run.checks.update(check_routing(run, st))
    gaps, _ = logit_gaps(run, st)
    run.checks["logit_gap"] = {
        "value": float(gaps.max()),
        "limit": run.cell["check"]["logit_gap_limit"]}


def summarize(run, st: Served) -> None:
    """The end-to-end metrics, and the counts behind them as earlier
    lines of the output."""
    arr = st.arrivals
    served = np.flatnonzero(st.outcome == ADMITTED)
    done = served[~np.isnan(st.last_t[served])]
    ttft = (st.first_t[done] - arr[done]) * 1e3
    lat = (st.last_t[done] - arr[done]) * 1e3
    run.attempted = len(arr)
    run.failed = int(len(served) - len(done)
                     + np.count_nonzero(st.outcome == 0))
    if len(done):
        run.e2e["ttft_p95_ms"] = float(np.quantile(ttft, 0.95))
        run.e2e["latency_p95_ms"] = float(np.quantile(lat, 0.95))
    run.lines.append(json.dumps({
        "offered_rate_per_s": len(arr) / run.seconds,
        "generator_late_max_ms": st.late_max * 1e3,
        "admitted": int(len(served)),
        "offloaded": int(np.count_nonzero(st.outcome == OFFLOADED)),
        "completed": int(len(done)), "failed": run.failed,
        "tail_samples": int(len(done)),
        "ttft_p50_ms": float(np.median(ttft)) if len(done) else None,
        "latency_p50_ms": float(np.median(lat)) if len(done) else None,
        "waves": len(st.waves), "flushes": st.flushes,
        "launches": st.launches,
        "drain_s": st.t_end - st.t0 - run.seconds}))


def check_routing(run, st: Served) -> dict:
    from laimr_bench.reference import route_ref
    adm = run.cell["admission"]
    pools = route_ref.Pools(st.pools)
    n = len(st.arrivals)
    res = route_ref.replay(
        pools, adm["policy"], st.arrivals, [st.pools[0]["model"]] * n,
        adm["window_s"], adm["max_batch"], st.target.astype(np.int64),
        st.outcome == OFFLOADED, np.full(n, -1, np.int64), got_g=st.pred)
    run.lines.append(json.dumps({"route_ties": res["ties"],
                                 "route_differing": res["differing"],
                                 "widest_differing_margin":
                                 res["widest_differing_margin"],
                                 "widest_g_gap": res["widest_g_gap"]}))
    return {"route_mismatched": {"value": res["mismatched"], "limit": 0}}


def sample_requests(run, st: Served) -> np.ndarray:
    """The requests whose tokens are checked: a draw from the seed of
    the served ones, ``check.tokens`` served tokens in all."""
    served = np.flatnonzero((st.outcome == ADMITTED)
                            & ~np.isnan(st.last_t))
    k = min(len(served), -(-int(run.cell["check"]["tokens"]) // st.out_len))
    rng = np.random.default_rng([int(run.seed), 7])
    return np.sort(rng.choice(served, size=k, replace=False))


def logit_gaps(run, st: Served, control: bool = False):
    """Per served token of the sample, how far its logit lies below the
    float32 reference's best at its position (prompt and the tokens
    served before it as the input); with ``control``, also the same gap
    of the token that the fp8 control puts first."""
    from laimr_bench.reference import model_ref
    idx = sample_requests(run, st)
    block = int(run.cell["check"]["block_rows"])
    served = torch.as_tensor(st.served[idx], device=run.device)
    prompt = st.tokens_in[torch.as_tensor(idx, device=run.device)]
    inp = torch.cat([prompt, served[:, :-1]], dim=1)
    first = st.prompt_len - 1
    gaps, ctl = [], []
    for s in range(0, len(idx), block):
        ref = model_ref.logits(run.conf, st.params, inp[s:s + block], first)
        best = ref.max(dim=-1).values
        tok = served[s:s + block]
        gaps.append((best - ref.gather(-1, tok[..., None])[..., 0]).cpu())
        if control:
            low = model_ref.logits(run.conf, st.params, inp[s:s + block],
                                   first, control=True)
            pick = low.argmax(dim=-1)
            ctl.append((best - ref.gather(-1, pick[..., None])[..., 0]).cpu())
            del low
        del ref
    out = torch.cat(gaps).numpy()
    return out, (torch.cat(ctl).numpy() if control else None)
