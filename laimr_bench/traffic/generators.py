"""Arrival processes of the benchmark's traffic: a frozen copy of the
port's generators (``repro_torch.core.workload``: the vectorised
homogeneous Poisson draw, Lewis-Shedler thinning, the bounded-Pareto
burst envelope, ``bounded_pareto_bursts``, ``flash_crowd_arrivals`` and
``poisson_arrivals``), kept here so that a change to the program cannot
move the yardstick. The bodies are the program's, draw for draw; each
returns the sorted arrival times as a float64 array instead of a list of
``Arrival`` objects (``tests/test_laimr_bench_traffic.py`` holds them to
the program's times for the same seeds).
"""
from __future__ import annotations

import heapq

import numpy as np


def _homogeneous_times(rng: np.random.Generator, lam: float,
                       horizon: float, t0: float = 0.0) -> np.ndarray:
    """Event times of a homogeneous Poisson(lam) process on
    [t0, t0 + horizon), in chunked draws."""
    if lam <= 0.0 or horizon <= 0.0:
        return np.empty(0)
    scale = 1.0 / lam
    end = t0 + horizon
    out = []
    t = t0
    chunk = max(256, int(lam * horizon * 1.1) + 16)
    while True:
        gaps = rng.exponential(scale, size=chunk)
        ts = np.cumsum(np.concatenate(([t], gaps)))[1:]
        if ts[-1] >= end:
            out.append(ts[ts < end])
            break
        out.append(ts)
        t = float(ts[-1])
        chunk = max(256, int((end - t) * lam * 1.2) + 16)
    return np.concatenate(out) if len(out) > 1 else out[0]


def _thin(rng: np.random.Generator, cands: np.ndarray, rate: np.ndarray,
          lam_max: float) -> np.ndarray:
    """Keep candidate i iff u_i <= rate(t_i) / lam_max."""
    if cands.size == 0:
        return cands
    u = rng.uniform(size=cands.size)
    return cands[u <= rate / lam_max]


def bounded_pareto(rng: np.random.Generator, alpha: float, lo: float,
                   hi: float, size: int = 1) -> np.ndarray:
    """Bounded-Pareto(alpha, lo, hi) via inverse-CDF sampling."""
    u = rng.uniform(size=size)
    la, ha = lo ** alpha, hi ** alpha
    return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)


def _burst_envelope(starts: np.ndarray, factors: np.ndarray,
                    duration: float) -> tuple[np.ndarray, np.ndarray]:
    """Piecewise-constant max-factor envelope of the burst intervals
    [s, s + duration): on [bounds[i], bounds[i+1]) the largest active
    factor is seg_max[i + 1]; seg_max[0] = 1.0 covers t < bounds[0]."""
    events = sorted(
        [(float(s), 0, float(f)) for s, f in zip(starts, factors)]
        + [(float(s) + duration, 1, float(f)) for s, f in zip(starts, factors)])
    bounds, seg_max = [], [1.0]
    heap: list[float] = []
    removed: dict[float, int] = {}
    i = 0
    while i < len(events):
        t = events[i][0]
        while i < len(events) and events[i][0] == t:
            _, kind, f = events[i]
            if kind == 0:
                heapq.heappush(heap, -f)
            else:
                removed[f] = removed.get(f, 0) + 1
            i += 1
        while heap and removed.get(-heap[0], 0) > 0:
            removed[-heap[0]] -= 1
            heapq.heappop(heap)
        bounds.append(t)
        seg_max.append(max(1.0, -heap[0]) if heap else 1.0)
    return np.asarray(bounds), np.asarray(seg_max)


def bounded_pareto_bursts(base_lam: float, horizon: float, seed: int = 0,
                          burst_rate: float = 0.05, pareto_alpha: float = 1.5,
                          burst_lo: float = 2.0, burst_hi: float = 8.0,
                          burst_duration: float = 5.0) -> np.ndarray:
    """Poisson baseline at ``base_lam`` with burst episodes: bursts
    arrive at ``burst_rate`` per second and multiply the rate by a
    bounded-Pareto(alpha) factor in [burst_lo, burst_hi] for
    ``burst_duration`` seconds."""
    rng = np.random.default_rng(seed)
    starts = _homogeneous_times(rng, burst_rate, horizon)
    factors = bounded_pareto(rng, pareto_alpha, burst_lo, burst_hi,
                             size=starts.size)
    lam_max = base_lam * burst_hi
    cands = _homogeneous_times(rng, lam_max, horizon)
    if starts.size == 0:
        rate = np.full(cands.shape, base_lam)
    else:
        bounds, seg_max = _burst_envelope(starts, factors, burst_duration)
        rate = base_lam * seg_max[np.searchsorted(bounds, cands,
                                                  side="right")]
    return _thin(rng, cands, rate, lam_max)


def flash_crowd_arrivals(base_lam: float, peak_lam: float, horizon: float,
                         seed: int = 0, t_start: float = 0.0,
                         duration: float = 30.0,
                         ramp: float = 0.0) -> np.ndarray:
    """Base load, then a (linearly ramped) surge to ``peak_lam`` on
    [t_start, t_start + ramp + duration), then back to base."""
    rng = np.random.default_rng(seed)
    lam_max = max(base_lam, peak_lam)
    cands = _homogeneous_times(rng, lam_max, horizon)
    rate = np.full(cands.shape, float(base_lam))
    if ramp > 0.0:
        in_ramp = (cands >= t_start) & (cands < t_start + ramp)
        rate = np.where(
            in_ramp,
            base_lam + (peak_lam - base_lam) * (cands - t_start) / ramp,
            rate)
    hold = (cands >= t_start + ramp) & (cands < t_start + ramp + duration)
    rate = np.where(hold, float(peak_lam), rate)
    return _thin(rng, cands, rate, lam_max)


def poisson_arrivals(lam: float, horizon: float, seed: int = 0
                     ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _homogeneous_times(rng, lam, horizon)
