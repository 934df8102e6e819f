"""Plain reference of LA-IMR admission, for the check that decides
``correct``: every request's outcome and target, every redundant copy,
and the burst detector's switches, replayed from the arrival schedule.

NumPy only, nothing imported from the program. It follows the port's
semantics as written down there (``control/plane.py`` with no engine
bound, ``control/policies/{guarded,safetail,hybrid}.py`` on a fused
backend, ``kernels/ref.py``'s float32 scoring with the Erlang-C wait
read from a 65-point table, ``core/telemetry.SlidingRate``):

* windows close at ``opened + window`` before any later arrival, or at
  an arrival when ``max_batch`` wait; a window's requests are scored at
  the flush time against each pool's sliding one-second arrival rate
  plus their own place in the window;
* ``guarded_alg1``: every request to its home (first edge) pool; offload
  one hop up when the home pool's predicted latency less its RTT
  exceeds tau = x * L_m (+ RTT), or the pool is unstable;
* ``safetail``: the feasible argmin with the cheapest near tie as the
  primary, the next feasible candidate as a redundant copy; with none
  feasible, the upstream of the cheapest candidate;
* ``hybrid``: a fast and a slow arrival-rate EWMA decide, per window,
  which of the two runs.

The program's kernels compute the power law and the table lookup in
another order (``exp(gamma log x)``, a hat-function sum): on the card
their g lies within 3e-7 of this reference's (relative, over millions of
decisions), so a row whose decision hangs on a comparison closer than
``TIE_REL`` is a tie: either answer is right there, and the replay
carries on with the program's. Every other row must agree exactly.
"""
from __future__ import annotations

import collections
import math

import numpy as np

UNSTABLE = 1e9
TIE_REL = 1e-5
TABLE_T = 65
NEAR = np.float32(1.0 + 1e-5)
NEAR_EPS = np.float32(1e-9)


# ---------------------------------------------------- Erlang-C, float64
def erlang_b(a: float, c: int) -> float:
    invb = 1.0
    for k in range(1, c + 1):
        invb = 1.0 + (k / a) * invb
        invb = min(invb, 1e280)
    return 1.0 / invb


def mmc_wait(lam: float, c: int, mu: float) -> float:
    """Expected M/M/c wait; inf when unstable."""
    if lam <= 0.0:
        return 0.0
    a = lam / mu
    rho = lam / (c * mu)
    b = erlang_b(a, c)
    cc = b / max(1.0 - rho * (1.0 - b), 1e-30)
    q = cc / max(c * mu - lam, 1e-30)
    return q if rho < 1.0 else math.inf


def erlang_table(mu: np.ndarray, n: np.ndarray, t: int = TABLE_T
                 ) -> np.ndarray:
    """(I, t) float32 waits over rho = linspace(0, 1, t), capped 1e6."""
    rho = np.linspace(0.0, 1.0, t)
    out = np.zeros((len(mu), t), np.float32)
    for i in range(len(mu)):
        lam = rho * int(n[i]) * float(mu[i])
        for j in range(t):
            w = mmc_wait(float(lam[j]), int(n[i]), float(mu[i]))
            out[i, j] = min(w, 1e6) if math.isfinite(w) else 1e6
    return out


# ------------------------------------------------------------ the pools
class Pools:
    """Columns of the candidate pools, as plain lists of numbers: dicts
    with ``l_ref``, ``speedup``, ``r_demand``, ``r_max``, ``background``,
    ``rtt``, ``cost``, ``n``, ``gamma``, ``tier``, ``model``."""

    def __init__(self, pools: list[dict], x: float = 2.25,
                 bf16: bool = False):
        self.pools = pools
        self.bf16 = bf16
        f32 = lambda v: np.array(v, np.float32)  # noqa: E731
        alpha, beta = [], []
        for p in pools:
            base = p["l_ref"] / p["speedup"]
            alpha.append(base * (1.0 + (p["background"] / p["r_max"])
                                 ** p["gamma"]))
            beta.append(base * (p["r_demand"] / p["r_max"]) ** p["gamma"])
        self.alpha, self.beta = f32(alpha), f32(beta)
        self.gamma = f32([p["gamma"] for p in pools])
        self.mu = f32([p["speedup"] / p["l_ref"] for p in pools])
        self.n = f32([p["n"] for p in pools])
        self.rtt = f32([p["rtt"] for p in pools])
        self.cost = f32([p["cost"] for p in pools])
        self.tau = f32([x * (p["l_ref"] / p["speedup"]) + p["rtt"]
                        for p in pools])
        self.table = erlang_table(self.mu.astype(np.float64),
                                  self.n.astype(np.int64))
        models = [p["model"] for p in pools]
        self.home = {}
        for m in models:
            same = [i for i, q in enumerate(pools) if q["model"] == m]
            edge = [i for i in same if pools[i]["tier"] == "edge"]
            self.home[m] = (edge or same)[0]
        self.upstream = np.full(len(pools), -1, np.int64)
        for i, p in enumerate(pools):
            if p["tier"] == "edge":
                cloud = [j for j, q in enumerate(pools)
                         if q["model"] == p["model"] and q["tier"] == "cloud"]
                if cloud:
                    self.upstream[i] = cloud[0]

    def scores(self, lam: np.ndarray):
        """(g, rho), float32, over the (R, I) rates; with ``bf16`` (the
        control) the rates and every score rounded to bfloat16."""
        if self.bf16:
            lam = round_bf16(lam)
        lam_t = lam / np.maximum(self.n, np.float32(1.0))
        proc = self.alpha + self.beta * np.power(
            np.maximum(lam_t, np.float32(0.0)), self.gamma)
        rho = lam / np.maximum(self.n * self.mu, np.float32(1e-12))
        t = self.table.shape[1]
        pos = np.clip(rho, np.float32(0.0), np.float32(1.0)) \
            * np.float32(t - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, t - 2)
        frac = pos - lo.astype(np.float32)
        cols = np.arange(len(self.pools))[None, :]
        q = self.table[cols, lo] * (np.float32(1.0) - frac) \
            + self.table[cols, lo + 1] * frac
        g = (proc + self.rtt) + q
        return (round_bf16(g), rho) if self.bf16 else (g, rho)


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _rel(a, b) -> np.ndarray:
    return np.abs(a - b) / np.maximum(np.abs(b), np.float32(1e-30))


# ------------------------------------------------------------- policies
def guard(pools: Pools, lam: np.ndarray, home: np.ndarray):
    """(target, offload, margin, g at the target or nan where the pool
    is unstable) per row: the margin is the relative distance of the
    comparison the decision hangs on."""
    g, rho = pools.scores(lam)
    rows = np.arange(len(home))
    g_eff = np.where(rho < 1.0, g, np.float32(UNSTABLE))
    g_home = g_eff[rows, home]
    rtt = pools.rtt[home]
    g_inst = np.where(g_home < UNSTABLE, g_home - rtt, g_home)
    tau = pools.tau[home]
    up = pools.upstream[home]
    off = (g_inst > tau) & (up >= 0)
    target = np.where(off, up, home)
    margin = np.where(g_home < UNSTABLE, _rel(g_inst, tau),
                      np.abs(rho[rows, home] - 1.0))
    g_t = g_eff[rows, target]
    return target, off, margin, np.where(g_t < UNSTABLE, g_t, np.nan)


def safetail(pools: Pools, lam: np.ndarray):
    """(primary, offload, dup (-1 for none), margin, g at the primary
    or nan where none is feasible) per row; redundancy 2, one lane."""
    g, rho = pools.scores(lam)
    slo = pools.tau[None, :]
    inf = np.float32(np.inf)
    feasible = (rho < 1.0) & (g <= slo)
    ok = feasible.any(axis=1)
    gm = np.where(feasible, g, inf)
    gmin = gm.min(axis=1, keepdims=True)
    thr = gmin * NEAR + NEAR_EPS
    near = feasible & (gm <= thr)
    primary = np.argmin(np.where(near, pools.cost[None, :], inf), axis=1)
    cols = np.arange(g.shape[1])[None, :]
    elig = feasible & (cols != primary[:, None])
    order = np.argsort(np.where(elig, g, inf), axis=1, kind="stable")
    has_dup = ok & elig.any(axis=1)
    dup = np.where(has_dup, order[:, 0], -1)
    # the closest of: a feasibility edge, the near band's edge, two
    # distinct scores that order the copy
    margin = np.minimum(_rel(g, slo), np.abs(rho - 1.0)).min(axis=1)
    with np.errstate(invalid="ignore"):
        band = np.where(feasible & (g != gmin), _rel(g, thr), inf)
        margin = np.minimum(margin, band.min(axis=1))
        ge = np.sort(np.where(elig, g, inf), axis=1)
        gaps = (ge[:, 1:] - ge[:, :-1]) / np.abs(ge[:, :-1])
        gaps = np.where((gaps > 0) & np.isfinite(gaps), gaps, inf)
    margin = np.minimum(margin, gaps.min(axis=1, initial=np.inf))
    ci = int(np.argmin(pools.cost))
    up = int(pools.upstream[ci])
    fallback, off_fb = (up, True) if up >= 0 else (ci, False)
    g_p = np.where(ok, g[np.arange(len(primary)), primary], np.nan)
    primary = np.where(ok, primary, fallback)
    offload = np.where(ok, False, off_fb)
    return primary, offload, dup, margin, g_p


class BurstDetector:
    """The hybrid policy's fast / slow arrival-rate EWMAs, per window."""

    def __init__(self, window: float, memory: float = 8.0,
                 enter: float = 2.0, exit_: float = 1.25,
                 min_rate: float = 2.0):
        self.window, self.memory = window, memory
        self.enter, self.exit, self.min_rate = enter, exit_, min_rate
        self.bursting = False
        self.switches = 0
        self.ewma = self.fast = 0.0
        self.last = None

    def observe(self, n: int, t: float) -> bool:
        if self.last is None:
            self.last = t
            dt = max(self.window, 1e-9)
            self.ewma = self.fast = float(n) / dt
            return self.bursting
        dt = max(t - self.last, self.window, 1e-9)
        self.last = t
        inst = float(n) / dt
        alpha_f = 1.0 - math.exp(-dt / max(self.memory / 8.0, 1e-9))
        self.fast += alpha_f * (inst - self.fast)
        rate, ewma = self.fast, self.ewma
        if self.bursting:
            if rate <= self.exit * ewma or rate < self.min_rate:
                self.bursting = False
                self.switches += 1
        elif rate >= self.enter * ewma and rate >= self.min_rate:
            self.bursting = True
            self.switches += 1
        alpha = 1.0 - math.exp(-dt / max(self.memory, 1e-9))
        self.ewma = ewma + alpha * (inst - ewma)
        return self.bursting


class Sliding:
    """Arrivals recorded per pool at flush times; the rate over the last
    ``width`` seconds, as ``SlidingRate`` keeps it."""

    def __init__(self, n_pools: int, width: float = 1.0):
        self.q = [collections.deque() for _ in range(n_pools)]
        self.count = np.zeros(n_pools, np.int64)
        self.width = width

    def rates(self, t: float) -> np.ndarray:
        for i, q in enumerate(self.q):
            while q and t - q[0][0] > self.width:
                self.count[i] -= q.popleft()[1]
        return (self.count / self.width).astype(np.float32)

    def add(self, counts: np.ndarray, t: float) -> None:
        for i in np.flatnonzero(counts):
            self.q[i].append((t, int(counts[i])))
            self.count[i] += int(counts[i])


def windows(arrivals: np.ndarray, window: float, max_batch: int):
    """(flush time, first, stop) of every window over ``arrivals``, as
    the benchmark's loops submit them: a timer flush at ``opened +
    window`` before any later arrival, the plane's own flush when a
    window fills (or its age is reached at an arrival), and the last
    window's timer flush."""
    out = []
    opened = None
    first = 0
    for i, a in enumerate(arrivals.tolist()):
        if opened is not None and a >= opened + window:
            out.append((opened + window, first, i))
            opened = None
        if opened is None:
            opened, first = a, i
        if i + 1 - first >= max_batch or a - opened >= window:
            out.append((a, first, i + 1))
            opened = None
    if opened is not None:
        out.append((opened + window, first, len(arrivals)))
    return out


def replay(pools: Pools, policy: str, arrivals: np.ndarray, models: list,
           window: float, max_batch: int, got_target: np.ndarray,
           got_offload: np.ndarray, got_dup: np.ndarray,
           rate_width: float = 1.0, got_g=None) -> dict:
    """Replay the plane over ``arrivals`` (request i of model
    ``models[i]``), comparing each window's decisions with the
    program's (target column, offloaded, copy column or -1). Returns the
    counts of mismatched and tied requests, of every request where the
    program's answer differs (ties included) with the widest margin
    among them, and the detector's switches. With ``got_target`` None the replay follows its own
    decisions and returns them too (the control's run)."""
    own = got_target is None
    if own:
        got_target = np.full(len(arrivals), -1, np.int64)
        got_offload = np.zeros(len(arrivals), bool)
        got_dup = np.full(len(arrivals), -1, np.int64)
    n_pools = len(pools.pools)
    tel = Sliding(n_pools, rate_width)
    det = BurstDetector(window) if policy == "hybrid" else None
    home_all = np.array([pools.home[m] for m in models], np.int64)
    mismatched = ties = flips = 0
    flip_margin = g_gap = 0.0
    for t, a, b in windows(arrivals, window, max_batch):
        r = b - a
        rates = tel.rates(t)
        lam = rates[None, :] + (np.arange(1, r + 1, dtype=np.float32)
                                / np.float32(rate_width))[:, None]
        home = home_all[a:b]
        bursting = det.observe(r, t) if det is not None else False
        if policy == "guarded_alg1" or (policy == "hybrid" and not bursting):
            target, off, margin, g_ref = guard(pools, lam, home)
            dup = np.full(r, -1)
        elif policy in ("safetail", "hybrid"):
            target, off, dup, margin, g_ref = safetail(pools, lam)
        else:
            raise ValueError(f"no reference for policy {policy!r}")
        if own:
            got_target[a:b], got_offload[a:b], got_dup[a:b] = target, off, dup
        gt, go, gd = got_target[a:b], got_offload[a:b], got_dup[a:b]
        wrong = (gt != target) | (go != off) | (gd != dup)
        tie = margin < TIE_REL
        mismatched += int((wrong & ~tie).sum())
        ties += int(tie.sum())
        if got_g is not None:
            both = ~wrong & np.isfinite(g_ref) & (got_g[a:b] < UNSTABLE)
            if both.any():
                g_gap = max(g_gap, float(_rel(got_g[a:b][both].astype(
                    np.float32), g_ref[both]).max()))
        if wrong.any():
            flips += int(wrong.sum())
            flip_margin = max(flip_margin, float(margin[wrong].max()))
        # the program's decisions are what the pools saw
        counts = np.bincount(gt, minlength=n_pools)
        counts += np.bincount(gd[gd >= 0], minlength=n_pools)
        if policy == "guarded_alg1" or (policy == "hybrid" and not bursting):
            counts += np.bincount(home[go & (gt != home)],
                                  minlength=n_pools)
        tel.add(counts, t)
    out = {"mismatched": mismatched, "ties": ties, "differing": flips,
           "widest_differing_margin": flip_margin,
           "widest_g_gap": g_gap,
           "switches": det.switches if det is not None else 0}
    if own:
        out["decisions"] = (got_target, got_offload, got_dup)
    return out
