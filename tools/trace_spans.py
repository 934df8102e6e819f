"""Readings of the port's spans in a traced window, on plain data.

A :class:`Window` holds the program's span records
(``repro_torch.core.telemetry.SpanRecords``), the device trace's start
and stop and the device's operations, all on the ``time.perf_counter``
clock. The functions here reduce it to the per-layer readings of
``READERS``, the clock check, the counters' summary and the span list
that names idle gaps. ``tools/trace_cell.py`` builds the window from a
benchmark cell's traced run; nothing here imports the benchmark.

Device operations are placed on the host clock two ways. *Device*
placement takes each operation's own stamps as the trace maps them.
*Launch* placement starts each operation at its launch call (the
runtime call of the same correlation id in the trace), or when the
operation launched before it on its stream ended, whichever is later,
and keeps its duration: the earliest the device could have run it.
Operations without a launch record keep their own stamps.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

COPY_STAGES = ("admission.upload", "admission.kernel", "admission.download")


@dataclasses.dataclass
class Window:
    """A traced window. ``ops`` are the device's operations as
    ``(name, start, end, launch, stream, correlation)``: ``launch`` is
    the host stamp of the operation's launch call, or None; the device
    trace ran from ``t_start`` to ``t_stop``. Host readings keep to
    spans that ended by ``t_start``."""

    name: str
    rec: object
    t_start: float
    t_stop: float
    ops: list

    def untraced(self, end: float) -> bool:
        return end <= self.t_start

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start


# ------------------------------------------------------------- placement
def device_placed(w: Window) -> list:
    """(name, start, end) of every operation at its own stamps, in order
    of start."""
    return sorted(((n, s, e) for n, s, e, *_ in w.ops), key=lambda k: k[1])


def launch_starts(w: Window) -> list:
    """Each operation's start at launch placement (module docstring), in
    the order of ``w.ops``; None for one without a launch record."""
    out: list = [None] * len(w.ops)
    last: dict = {}
    for k in sorted((k for k, o in enumerate(w.ops) if o[3] is not None),
                    key=lambda k: w.ops[k][5]):
        _, s, e, launch, stream, _ = w.ops[k]
        out[k] = max(launch, last.get(stream, -math.inf))
        last[stream] = out[k] + (e - s)
    return out


def launch_placed(w: Window) -> list:
    """(name, start, end) of every operation at launch placement, in
    order of start."""
    out = []
    for (n, s, e, *_), p in zip(w.ops, launch_starts(w)):
        out.append((n, s, e) if p is None else (n, p, p + (e - s)))
    out.sort(key=lambda k: k[1])
    return out


def busy_intervals(ops: list) -> list:
    """The union of ``(name, start, end)`` operations in order of start,
    as [start, end] pairs."""
    merged: list = []
    for _, s, e in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


# ------------------------------------------------------------- reductions
def ids_of(rec, name: str) -> list[int]:
    return [i for i, n in enumerate(rec.name) if n == name]


def child_ms(rec, parents: list[int], names) -> float:
    """Mean over ``parents`` of the ms their children named in ``names``
    took, or None without parents."""
    if not parents:
        return None
    keep = set(parents)
    total = sum(rec.end[i] - rec.start[i] for i in range(len(rec))
                if rec.parent[i] in keep and rec.name[i] in names)
    return 1e3 * total / len(parents)


def top_intervals(rec, lo: float, hi: float) -> list:
    """Top-level program spans clipped to [lo, hi], merged, in order."""
    out: list = []
    for i in sorted((i for i in range(len(rec)) if rec.parent[i] < 0),
                    key=lambda i: rec.start[i]):
        s, e = max(rec.start[i], lo), min(rec.end[i], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_s(a: list, b: list) -> float:
    """Total length of the intersection of two ordered lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_pct(w: Window, ops: list) -> float:
    """Device-idle time inside top-level program spans over the traced
    window, in %, with the device busy during ``ops``."""
    spans = top_intervals(w.rec, w.t_start, w.t_stop)
    inside = sum(e - s for s, e in spans)
    return 100.0 * (inside - overlap_s(spans, busy_intervals(ops))) \
        / w.window_s


# ---------------------------------------------------------------- readers
def flush_ids(w: Window, untraced: bool = True) -> list[int]:
    rec = w.rec
    return [i for i in ids_of(rec, "admission.flush")
            if not untraced or w.untraced(rec.end[i])]


def flush_rates_ms(w: Window):
    """Mean ``admission.rates`` ms per flush."""
    return child_ms(w.rec, flush_ids(w), ("admission.rates",))


def flush_copy_ms(w: Window):
    """Mean ``admission.upload`` + ``.kernel`` + ``.download`` ms per
    flush."""
    return child_ms(w.rec, flush_ids(w), COPY_STAGES)


def flush_settle_ms(w: Window):
    """Mean ``admission.settle`` ms per flush."""
    return child_ms(w.rec, flush_ids(w), ("admission.settle",))


def route_copies_per_flush(w: Window):
    """Host-device copies over flushes, the whole window."""
    rec, ids = w.rec, flush_ids(w, untraced=False)
    if not ids:
        return None
    return sum(rec.h2d_copies[i] + rec.d2h_copies[i] for i in ids) / len(ids)


def wave_ids(w: Window) -> list[int]:
    rec = w.rec
    return [i for i in ids_of(rec, "engine.generate")
            if w.untraced(rec.end[i])]


def prefill_launch_ms(w: Window):
    """Mean ``engine.prefill`` ms per wave."""
    return child_ms(w.rec, wave_ids(w), ("engine.prefill",))


def decode_launch_ms(w: Window):
    """Mean ``engine.step.launch`` ms per decode step."""
    rec = w.rec
    steps = [i for i in ids_of(rec, "engine.step")
             if w.untraced(rec.end[i])]
    return child_ms(rec, steps, ("engine.step.launch",))


def program_idle_share(w: Window):
    """Device-idle time inside top-level program spans over the traced
    window, in %, at launch placement."""
    if not w.ops:
        return None
    return idle_inside_pct(w, launch_placed(w))


#: metric -> (reader, the cells it reads)
READERS = {
    "flush_rates_ms": (flush_rates_ms, ("stablelm_3b.fleet_route",)),
    "flush_copy_ms": (flush_copy_ms, ("stablelm_3b.fleet_route",)),
    "flush_settle_ms": (flush_settle_ms, ("stablelm_3b.fleet_route",)),
    "route_copies_per_flush": (route_copies_per_flush,
                               ("stablelm_3b.fleet_route",)),
    "prefill_launch_ms": (prefill_launch_ms,
                          ("stablelm_3b.robot_burst",
                           "mamba2_370m.robot_chat",
                           "mamba2_370m.robot_history")),
    "decode_launch_ms": (decode_launch_ms,
                         ("mamba2_370m.robot_chat",
                          "mamba2_370m.robot_history")),
    "program_idle_share.forward": (program_idle_share,
                                   ("stablelm_3b.robot_burst",)),
    "program_idle_share.generate": (program_idle_share,
                                    ("mamba2_370m.robot_chat",
                                     "mamba2_370m.robot_history")),
}


def metrics(w: Window) -> dict:
    """The readings of ``w``'s cell that found something to read."""
    out = {}
    for name, (read, cells) in READERS.items():
        if w.name in cells:
            v = read(w)
            if v is not None:
                out[name] = v
    return out


# ------------------------------------------------------------- counters
def step_counters(rec):
    """Decode steps, those that replayed the engine's CUDA graph (the
    ``engine.step`` span's ``graph`` counter) and their share, and the
    steps that captured it (an ``engine.step.capture`` stage); None
    without steps."""
    steps = ids_of(rec, "engine.step")
    if not steps:
        return None
    replays = sum(rec.graph[i] for i in steps)
    return {"steps": len(steps), "replays": replays,
            "replay_share": replays / len(steps),
            "captures": len(ids_of(rec, "engine.step.capture"))}


#: the decode mixer's kernels, one launch each a Mamba-2 layer and step
MIXER_KERNELS = ("ssd_conv_step_kernel", "ssd_step_kernel",
                 "ssd_gated_norm_kernel")


def ssd_mixer_counter(w: Window, mamba_layers: int):
    """The Mamba-2 decode mixer's kernels in the device trace, per
    ``engine.step`` span that began inside it: each kernel's launches
    and launches per step, their share of ``mamba_layers`` (the least of
    the three per-step counts over the layers: 1.0 when every layer goes
    through all of them; None for a model without such layers), and the
    device kernels (copies and fills aside) that started inside those
    steps, per step; None without a traced step. Where the steps ran
    parallel layers (attention and a Mamba-2 mixer side by side: the
    spans' ``parallel_layers`` counter), also ``decode_attention``'s
    launches per parallel layer and step (1.0 when each such layer's
    attention is one launch)."""
    rec = w.rec
    ids = [i for i in ids_of(rec, "engine.step")
           if w.t_start <= rec.start[i] <= w.t_stop]
    steps = sorted((rec.start[i], rec.end[i]) for i in ids)
    if not steps:
        return None
    n = len(steps)
    launches = {k: sum(k in name for name, *_ in w.ops)
                for k in MIXER_KERNELS}
    per_step = {k: v / n for k, v in launches.items()}
    starts = [s for s, _ in steps]
    kernels = 0
    for name, s, *_ in w.ops:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and s <= steps[j][1] \
                and not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    out = {"steps": n, "launches": launches, "per_step": per_step,
           "share": (min(per_step.values()) / mamba_layers
                     if mamba_layers else None),
           "kernels_per_step": kernels / n}
    parallel = max(rec.parallel_layers[i] for i in ids)
    if parallel:
        attn = sum("decode_attention_kernel" in name for name, *_ in w.ops)
        out["parallel_layers"] = parallel
        out["decode_attention_per_parallel_layer"] = attn / n / parallel
    return out


def stream_counters(rec):
    """The host's counts from shapes on ``engine.generate`` (its prefill)
    and ``engine.step`` spans: per span kind, the parallel layers a call
    ran and the SSM-state and KV bytes it streamed, per call; None where
    no span counted any."""
    out = {}
    for key, name in (("prefill", "engine.generate"),
                      ("decode", "engine.step")):
        ids = ids_of(rec, name)
        if ids and any(rec.parallel_layers[i] or rec.ssm_state_bytes[i]
                       or rec.kv_bytes[i] for i in ids):
            n = len(ids)
            out[key] = {
                "calls": n,
                "parallel_layers": sum(rec.parallel_layers[i]
                                       for i in ids) / n,
                "ssm_state_bytes": sum(rec.ssm_state_bytes[i]
                                       for i in ids) / n,
                "kv_bytes": sum(rec.kv_bytes[i] for i in ids) / n}
    return out or None


def expert_counters(rec):
    """The expert layers' routing counters of ``engine.generate`` (its
    prefill) and ``engine.step`` spans: per span kind, the expert
    launches (one a layer), and per launch the rows routed, the experts
    touched and the most rows on one expert; None where no span ran an
    expert layer."""
    out = {}
    for key, name in (("prefill", "engine.generate"),
                      ("decode", "engine.step")):
        ids = ids_of(rec, name)
        n = sum(rec.expert_launches[i] for i in ids)
        if n:
            out[key] = {
                "launches": n,
                "rows": sum(rec.expert_rows[i] for i in ids) / n,
                "touched": sum(rec.expert_touched[i] for i in ids) / n,
                "max_rows": sum(rec.expert_max_rows[i] for i in ids) / n}
    return out or None


def counters(w: Window, mamba_layers: int | None = None) -> dict:
    """The span counters, summarised. Per flush (the whole window): rows
    decided and as padded for the routing kernel, and bytes copied each
    way. Per wave (untraced): rows, steps, and ``engine.prefill`` ms by
    rows. Decode steps (the whole window): ``step_counters``, and given
    the model's ``mamba_layers``, its ``ssd_mixer``
    (``ssd_mixer_counter``, the traced steps). Expert layers (the whole
    window): ``expert_counters``; parallel layers and the bytes streamed
    (the whole window): ``stream_counters``."""
    rec, out = w.rec, {}
    fl = sorted(flush_ids(w, untraced=False), key=lambda i: rec.start[i])
    if fl:
        n = len(fl)
        out["flush"] = {
            "rows": sum(rec.rows[i] for i in fl) / n,
            "padded_rows": sum(rec.padded_rows[i] for i in fl) / n,
            "h2d_bytes": sum(rec.h2d_bytes[i] for i in fl) / n,
            "d2h_bytes": sum(rec.d2h_bytes[i] for i in fl) / n}
    waves = wave_ids(w)
    if waves:
        by_rows: dict = {}
        for i in waves:
            by_rows.setdefault(rec.rows[i], []).append(i)
        out["wave"] = {
            "rows": sum(rec.rows[i] for i in waves) / len(waves),
            "steps": sum(rec.steps[i] for i in waves) / len(waves),
            "prefill_ms_by_rows": {
                r: child_ms(rec, ids, ("engine.prefill",))
                for r, ids in sorted(by_rows.items())}}
    steps = step_counters(rec)
    if steps:
        if mamba_layers is not None:
            mixer = ssd_mixer_counter(w, mamba_layers)
            if mixer:
                steps["ssd_mixer"] = mixer
        out["step"] = steps
    experts = expert_counters(rec)
    if experts:
        out["experts"] = experts
    streams = stream_counters(rec)
    if streams:
        out["streams"] = streams
    return out


def program_items(rec) -> list:
    """(name, start, end) of every closed span, parents before their
    children: the last span in this list that holds a gap's middle is
    the innermost one."""
    order = sorted((i for i in range(len(rec)) if rec.end[i] == rec.end[i]),
                   key=lambda i: rec.start[i])
    return [(rec.name[i], rec.start[i], rec.end[i]) for i in order]


# ---------------------------------------------------------- clock check
def quantiles_us(values: list) -> dict:
    """Quantiles of seconds, in us."""
    q = sorted(values)
    return {f"p{p}": 1e6 * q[min(int(p / 100 * len(q)), len(q) - 1)]
            for p in (0, 1, 50, 99, 100)}


def clock_check(w: Window) -> dict:
    """How well the two time bases agree, at both placements: the share
    of routing kernels that start inside an ``admission.flush`` span,
    and after that flush's ``admission.kernel`` stage began; the share
    of device busy time in operations that start inside a top-level
    program span; device idle inside those spans (as
    ``program_idle_share``). Besides: the share of routing launch calls
    inside their flush's kernel stage, and how far device stamps lie
    after the launch calls and after the launch placement."""
    rec = w.rec
    flushes = sorted(ids_of(rec, "admission.flush"),
                     key=lambda i: rec.start[i])
    starts = [rec.start[i] for i in flushes]
    kernel_at = {rec.parent[i]: rec.start[i]
                 for i in ids_of(rec, "admission.kernel")}

    def placed(t: float) -> tuple[bool, bool]:
        """(in a flush, in it after its kernel stage began)"""
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t > rec.end[flushes[k]]:
            return False, False
        return True, kernel_at.get(flushes[k], math.inf) <= t

    spans = top_intervals(rec, -math.inf, math.inf)
    lo = [s for s, _ in spans]
    out: dict = {}
    for how, ops in (("device", device_placed(w)),
                     ("launch", launch_placed(w))):
        routed = [s for n, s, _ in ops if "routing_" in n]
        where = [placed(s) for s in routed]
        busy = inside = 0.0
        for _, s, e in ops:
            busy += e - s
            k = bisect.bisect_right(lo, s) - 1
            if k >= 0 and s <= spans[k][1]:
                inside += e - s
        got = {"routing_kernels": len(routed), "busy_s": busy,
               "busy_in_program_spans": inside / busy if busy else None,
               "idle_inside_pct": idle_inside_pct(w, ops) if ops
               else None}
        if routed:
            got["routing_in_a_flush"] = sum(a for a, _ in where) \
                / len(routed)
            got["routing_in_their_flush"] = sum(b for _, b in where) \
                / len(routed)
        out[how] = got
    launched = [(s, launch) for n, s, _, launch, *_ in w.ops
                if "routing_" in n and launch is not None]
    if launched:
        out["routing_launches_in_their_stage"] = sum(
            placed(t)[1] for _, t in launched) / len(launched)
        out["routing_start_after_launch_us"] = quantiles_us(
            [s - t for s, t in launched])
    moved = [o[1] - p for o, p in zip(w.ops, launch_starts(w))
             if p is not None]
    out["ops_without_launch"] = len(w.ops) - len(moved)
    if moved:
        out["device_after_launch_placed_us"] = quantiles_us(moved)
    return out
