"""Arrival-process generators (paper §V-B/§V-D) — the scenario matrix.

The paper evaluates under steadily increasing arrival rates lambda = 1..6
req/s and emulates load bursts 'with a bounded-Pareto process'. Related
tail-latency work stresses far more diverse regimes (SafeTail's
heterogeneous edge bursts, arXiv:2408.17171; the diurnal SLA traces of
arXiv:2512.14290), so the matrix here goes beyond the paper:

* :func:`poisson_arrivals` — homogeneous Poisson at rate lam.
* :func:`bounded_pareto_bursts` — a modulated Poisson process whose burst
  episode *intensities* are bounded-Pareto distributed (heavy-tailed
  burst sizes, bounded so the system stays within the simulated range).
* :func:`ramp_arrivals` — the paper's 'steadily increase lambda' sweep.
* :func:`robot_trace` — per-robot periodic capture (30 FPS cameras downsampled
  to a per-robot request period) with jitter: the CloudGripper-shaped trace.
* :func:`diurnal_arrivals` — sinusoidal day/night load (autoscaler traces).
* :func:`mmpp_arrivals` — Markov-modulated Poisson process: a CTMC picks
  the regime, each state carries its own rate (bursty + correlated).
* :func:`flash_crowd_arrivals` — step (optionally ramped) flash crowd.
* :func:`mixed_traffic` — superposition of per-model Poisson streams
  (multi-model clusters: every lane loaded at once).

All generators are seeded and deterministic, return time-sorted lists,
and are vectorised end-to-end: candidate event times come from chunked
``numpy`` draws (bit-identical to the naive one-draw-at-a-time loops the
seed implementation used — ``numpy.random.Generator`` fills batched draws
from the same stream, and ``cumsum`` accumulates in the same IEEE order),
and non-homogeneous processes use vectorised Lewis-Shedler thinning
instead of a per-sample Python ``rate_at`` loop. One exception to
bit-compatibility with the seed code: ``bounded_pareto_bursts`` now draws
all thinning uniforms in one batch after the candidate times rather than
interleaved, so its output for a given seed differs from (while being
statistically identical to) the pre-vectorisation version.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass(frozen=True, slots=True)
class Arrival:
    t: float
    model: str
    robot: int = 0


# ------------------------------------------------------------------ #
# vectorised primitives
# ------------------------------------------------------------------ #

def _homogeneous_times(rng: np.random.Generator, lam: float,
                       horizon: float, t0: float = 0.0) -> np.ndarray:
    """Event times of a homogeneous Poisson(lam) process on [t0, t0+horizon).

    Chunked vectorised draws; the produced times are bit-identical to the
    scalar loop ``while True: t += rng.exponential(1/lam)`` (the chunk
    boundary carry re-enters cumsum as its first element, preserving the
    sequential rounding), though more stream is consumed.
    """
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
    """Vectorised Lewis-Shedler thinning: keep candidate i iff
    u_i <= rate(t_i) / lam_max. ``rate`` is evaluated for all candidates
    up front (vectorised), not per sample."""
    if cands.size == 0:
        return cands
    u = rng.uniform(size=cands.size)
    return cands[u <= rate / lam_max]


def _arrivals(ts: np.ndarray, model: str, robot: int = 0) -> list[Arrival]:
    return [Arrival(t, model, robot) for t in ts.tolist()]


# ------------------------------------------------------------------ #
# the paper's generators
# ------------------------------------------------------------------ #

def poisson_arrivals(lam: float, horizon: float, model: str,
                     seed: int = 0) -> list[Arrival]:
    rng = np.random.default_rng(seed)
    return _arrivals(_homogeneous_times(rng, lam, horizon), model)


def bounded_pareto(rng: np.random.Generator, alpha: float, lo: float,
                   hi: float, size: int = 1) -> np.ndarray:
    """Bounded-Pareto(alpha, lo, hi) via inverse-CDF sampling."""
    u = rng.uniform(size=size)
    la, ha = lo ** alpha, hi ** alpha
    return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)


def _burst_envelope(starts: np.ndarray, factors: np.ndarray,
                    duration: float) -> tuple[np.ndarray, np.ndarray]:
    """Piecewise-constant max-factor envelope of the burst intervals
    [s, s+duration) — a sweep line with a lazy-deletion max-heap, so the
    whole thing is O(B log B) in the number of bursts.

    Returns (bounds, seg_max): on [bounds[i], bounds[i+1]) the largest
    active factor is seg_max[i + 1]; seg_max[0] = 1.0 covers t < bounds[0].
    """
    events = sorted(
        [(float(s), 0, float(f)) for s, f in zip(starts, factors)]
        + [(float(s) + duration, 1, float(f)) for s, f in zip(starts, factors)])
    bounds, seg_max = [], [1.0]
    heap: list[float] = []          # negated active factors
    removed: dict[float, int] = {}  # lazy deletions
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


def bounded_pareto_bursts(base_lam: float, horizon: float, model: str,
                          seed: int = 0, burst_rate: float = 0.05,
                          pareto_alpha: float = 1.5, burst_lo: float = 2.0,
                          burst_hi: float = 8.0,
                          burst_duration: float = 5.0) -> list[Arrival]:
    """Poisson baseline at ``base_lam`` with burst episodes.

    Bursts arrive as a Poisson process (rate ``burst_rate`` per second);
    each burst multiplies the arrival rate by a bounded-Pareto(alpha)
    factor in [burst_lo, burst_hi] for ``burst_duration`` seconds —
    heavy-tailed burst *intensity*, the regime that produces the paper's
    long-tail latency spikes. Fully vectorised: the burst envelope is a
    sweep-line max, candidates and thinning uniforms are batched draws.
    """
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
    return _arrivals(_thin(rng, cands, rate, lam_max), model)


def ramp_arrivals(lams: list[float], seg_duration: float, model: str,
                  seed: int = 0) -> list[Arrival]:
    """Piecewise-constant rate sweep: lam = lams[0], lams[1], ... (§V-B)."""
    out, t0 = [], 0.0
    for k, lam in enumerate(lams):
        seg = poisson_arrivals(lam, seg_duration, model, seed=seed + k)
        out.extend(Arrival(a.t + t0, a.model, a.robot) for a in seg)
        t0 += seg_duration
    return out


def robot_trace(n_robots: int, period: float, horizon: float, model: str,
                seed: int = 0, jitter: float = 0.05) -> list[Arrival]:
    """CloudGripper-style trace: n robots each sending one frame every
    ``period`` seconds with phase offsets and Gaussian jitter."""
    rng = np.random.default_rng(seed)
    ts_all, robots = [], []
    for r in range(n_robots):
        phase = rng.uniform(0.0, period)
        n_est = int((horizon - phase) / period) + 2
        ticks = np.cumsum(np.concatenate(([phase],
                                          np.full(n_est, period))))
        ticks = ticks[ticks < horizon]
        jit = rng.normal(0.0, jitter, size=ticks.size)
        ts_all.append(np.maximum(ticks + jit, 0.0))
        robots.append(np.full(ticks.size, r))
    if not ts_all:
        return []
    ts = np.concatenate(ts_all)
    rb = np.concatenate(robots)
    order = np.argsort(ts, kind="stable")
    return [Arrival(t, model, r) for t, r in
            zip(ts[order].tolist(), rb[order].tolist())]


# ------------------------------------------------------------------ #
# scenario-matrix generators (beyond the paper)
# ------------------------------------------------------------------ #

def diurnal_arrivals(base_lam: float, horizon: float, model: str,
                     seed: int = 0, amplitude: float = 0.8,
                     period: float = 600.0,
                     phase: float = 0.0) -> list[Arrival]:
    """Sinusoidal day/night load: rate(t) = base*(1 + A sin(2pi t/T + phi)),
    clipped at zero — the diurnal SLA-constrained regime hybrid
    reactive-proactive autoscalers are tuned on (arXiv:2512.14290).
    Vectorised thinning against lam_max = base*(1+A)."""
    rng = np.random.default_rng(seed)
    lam_max = base_lam * (1.0 + abs(amplitude))
    cands = _homogeneous_times(rng, lam_max, horizon)
    rate = np.maximum(
        base_lam * (1.0 + amplitude
                    * np.sin(2.0 * np.pi * cands / period + phase)), 0.0)
    return _arrivals(_thin(rng, cands, rate, lam_max), model)


def mmpp_arrivals(rates: list[float], mean_dwell: float, horizon: float,
                  model: str, seed: int = 0) -> list[Arrival]:
    """Markov-modulated Poisson process (MMPP): a continuous-time Markov
    chain dwells ~Exp(mean_dwell) in each state, jumping uniformly to a
    different state; state k emits Poisson(rates[k]) arrivals. Correlated
    burstiness — the edge regime SafeTail (arXiv:2408.17171) stresses.

    The state path is simulated episode-by-episode (a handful of
    transitions), arrivals inside each episode are batched draws.
    """
    if not rates:
        raise ValueError("mmpp_arrivals needs at least one state rate")
    rng = np.random.default_rng(seed)
    k = len(rates)
    state, t = 0, 0.0
    chunks = []
    while t < horizon:
        dwell = rng.exponential(mean_dwell)
        seg_end = min(t + dwell, horizon)
        lam = rates[state]
        if lam > 0.0:
            chunks.append(_homogeneous_times(rng, lam, seg_end - t, t0=t))
        t = seg_end
        if k > 1:
            jump = int(rng.integers(0, k - 1))
            state = jump if jump < state else jump + 1
    ts = np.concatenate(chunks) if chunks else np.empty(0)
    return _arrivals(ts, model)


def flash_crowd_arrivals(base_lam: float, peak_lam: float, horizon: float,
                         model: str, seed: int = 0, t_start: float = 0.0,
                         duration: float = 30.0,
                         ramp: float = 0.0) -> list[Arrival]:
    """Flash-crowd step: base load, then a (optionally linearly ramped)
    surge to ``peak_lam`` on [t_start, t_start + ramp + duration), then
    back to base — the scale-out stress test for PM-HPA's pod start-up
    race. Vectorised thinning against max(base, peak)."""
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
    return _arrivals(_thin(rng, cands, rate, lam_max), model)


def mixed_traffic(loads: dict[str, float], horizon: float,
                  seed: int = 0) -> list[Arrival]:
    """Multi-model mixed traffic: one homogeneous Poisson stream per model
    (``loads`` maps model name -> rate), superposed and time-sorted — every
    quality lane of a multi-model cluster loaded simultaneously."""
    rng = np.random.default_rng(seed)
    ts_all, names = [], []
    for name, lam in loads.items():
        ts = _homogeneous_times(rng, lam, horizon)
        ts_all.append(ts)
        names.extend([name] * ts.size)
    if not ts_all:
        return []
    ts = np.concatenate(ts_all)
    order = np.argsort(ts, kind="stable")
    ts_sorted = ts[order].tolist()
    return [Arrival(t, names[i]) for t, i in zip(ts_sorted, order.tolist())]
