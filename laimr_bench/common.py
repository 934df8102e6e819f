"""Plumbing shared by the benchmark's loops: the card check, the
process's start, host spans, the device trace and its reduction.

Nothing here imports the program; ``run.py`` puts ``src`` on the path.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

#: published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

#: top-level module names that must never be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of ``FORBIDDEN_MODULES``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def process_start_wall() -> float:
    """Wall-clock time (``time.time()``) at which this process started,
    from ``/proc``; the interpreter's own start-up counts as set-up."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])                 # starttime, in clock ticks
    hz = os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / hz


@dataclasses.dataclass
class Spans:
    """Host spans of the benchmark's own calls into the program:
    (name, start, end) in ``time.perf_counter`` seconds."""

    items: list = dataclasses.field(default_factory=list)

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def total(self, name: str, keep=None) -> tuple[int, float]:
        """(count, seconds) of the spans ``name``; with ``keep``, of
        those whose end it accepts."""
        ts = [e - s for n, s, e in self.items
              if n == name and (keep is None or keep(e))]
        return len(ts), sum(ts)


class DeviceTrace:
    """``torch.profiler`` over the device alone (CUDA activity, no host
    ops) from ``start`` to ``stop``, set-up and the check left out. A
    first, empty session at construction brings the profiler up, so that
    ``start`` costs the window little. ``stop`` only ends the trace; its
    events are read afterwards from the profiler's raw results
    (``kineto_results``), since building the profiler's own event tree
    takes minutes for a decode-heavy window."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.device = device
        # the CPU's own ops stand in for a rehearsal without a card
        cuda = device.type == "cuda"
        activities = [ProfilerActivity.CUDA if cuda
                      else ProfilerActivity.CPU]
        with profile(activities=activities):
            self._sync()
        self.prof = profile(activities=activities)
        self.kind = torch.autograd.DeviceType.CUDA if cuda \
            else torch.autograd.DeviceType.CPU
        self.t_start = self.t_stop = None
        self._kernels = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.__enter__()
        self.wall_ns = time.time_ns()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.t_start is None:
            self.start()
        self._sync()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def kernels(self) -> list:
        """(name, start, end) of every device operation, on the host's
        ``perf_counter`` clock (the trace's wall-clock stamps shifted by
        the start's), in order of start."""
        if self._kernels is None:
            out = []
            for ev in self.prof.profiler.kineto_results.events():
                if ev.device_type() != self.kind or ev.duration_ns() <= 0:
                    continue
                s = self.t_start + (ev.start_ns() - self.wall_ns) * 1e-9
                out.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
            out.sort(key=lambda k: k[1])
            self._kernels = out
            self.prof = None
        return self._kernels

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_intervals(self) -> list:
        """The union of the device's activity, as (start, end) pairs."""
        merged: list = []
        for _, s, e in self.kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_of(self, needle: str) -> tuple[int, float]:
        """(launches, device seconds) of kernels whose name holds
        ``needle``."""
        hits = [e - s for n, s, e in self.kernels if needle in n]
        return len(hits), sum(hits)

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps
        named by the host span that held the gap's middle."""
        by_name: dict = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t_start] + [x for iv in busy for x in iv] \
            + [self.t_stop]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            label = "harness"
            for n, hs, he in spans.items:
                if hs <= mid <= he:
                    label = n
            named.append([label, e - s])
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": named}


def device_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``unknown``."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
