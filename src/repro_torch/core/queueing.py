"""M/M/c queueing theory primitives (paper §III-D, Eqs. 11-12), torch.

Erlang-C on tensors for the batched routing path: every function here is
a plain function of torch tensors, broadcasts over instance tables, and
avoids factorials by running the inverse Erlang-B recurrence in linear
space. Results follow their inputs' device; a python-scalar input lands
on ``device`` (``"cuda"`` unless the caller asks for the CPU).

The numpy control-plane twins (``*_np``) and the scalar fast paths
(``*_scalar``, :class:`ErlangMemo`) are copied verbatim from the
reference package: the simulator's golden digests rely on their exact
float64 arithmetic (numpy-2 ``np.power``, same op order).

Conventions
-----------
``lam``   aggregate arrival rate for a model  [req/s]
``mu``    per-replica service rate            [req/s]
``c``     replica count (integer >= 1)
``rho``   traffic intensity lam / (c * mu); stability requires rho < 1.
"""
from __future__ import annotations

import numpy as np
import torch

# Maximum replica count the closed-form tables support. The recurrence
# runs to max(c) <= MAX_SERVERS steps.
MAX_SERVERS = 512


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: on ``device`` when given, else on the
    device it already lives on, else on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=device if device is not None else "cuda")


def common_device(*xs, device=None):
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def offered_load(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Offered load a = lam / mu (in Erlangs)."""
    return lam / mu


def traffic_intensity(lam: torch.Tensor, c: torch.Tensor,
                      mu: torch.Tensor) -> torch.Tensor:
    """rho = lam / (c mu). Stability requires rho < 1."""
    return lam / (c * mu)


def _log_erlang_b(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """log of the Erlang-B blocking probability B(a, c), float32.

    The classic recurrence run on inverse-B (>= 1, well conditioned):
        1/B(a,k) = 1 + (k / a) * (1 / B(a, k-1)),   1/B(a,0) = 1.
    One batched step per server count up to max(c) (at most
    MAX_SERVERS); each element keeps the value of its own step c
    (c < 1 reads step 1, as the reference's clipped gather does).
    """
    a, c = torch.broadcast_tensors(a, c)
    c = c.clamp(1, MAX_SERVERS)
    invb = torch.ones_like(a)
    out = torch.ones_like(a)
    kmax = int(c.max()) if c.numel() else 0
    # k as a tensor: ``float / Tensor`` would lower to k * (1 / a), two
    # roundings where the reference has one
    ks = torch.arange(1, kmax + 1, dtype=a.dtype, device=a.device)
    for k in range(1, kmax + 1):
        invb = 1.0 + (ks[k - 1] / a) * invb
        out = torch.where(c == k, invb, out)
    return -torch.log(out)


def erlang_c(lam, c, mu, *, device=None) -> torch.Tensor:
    """Erlang-C probability of queueing C(rho, c)  (paper Eq. 11).

    Computed from Erlang-B via  C = B / (1 - rho (1 - B)), stable for
    all rho < 1. Returns 1.0 when rho >= 1 (queue certain — callers
    enforce the stability constraint separately, Eq. 22).
    """
    dev = common_device(lam, c, mu, device=device)
    lam = as_f32(lam, dev)
    mu = as_f32(mu, dev)
    c_i = torch.as_tensor(c, device=dev).to(torch.int32) \
        if not isinstance(c, torch.Tensor) else c.to(dev, torch.int32)
    c_f = c_i.to(torch.float32)
    a = offered_load(lam, mu)
    rho = lam / (c_f * mu)
    b = torch.exp(_log_erlang_b(a, c_i))
    cc = b / torch.clamp_min(1.0 - rho * (1.0 - b), 1e-30)
    return torch.where(rho < 1.0, cc.clamp(0.0, 1.0),
                       torch.ones_like(cc))


def mmc_wait(lam, c, mu, *, unstable_value: float = float("inf"),
             device=None) -> torch.Tensor:
    """Expected M/M/c queueing delay  Q = C(rho,c) / (c mu - lam)   (Eq. 12).

    Returns ``unstable_value`` (default +inf) when rho >= 1, so routing
    feasibility masks fall out naturally.
    """
    dev = common_device(lam, c, mu, device=device)
    lam = as_f32(lam, dev)
    mu = as_f32(mu, dev)
    c_i = torch.as_tensor(c, device=dev).to(torch.int32) \
        if not isinstance(c, torch.Tensor) else c.to(dev, torch.int32)
    c_f = c_i.to(torch.float32)
    rho = lam / (c_f * mu)
    cc = erlang_c(lam, c_i, mu)
    q = cc / torch.clamp_min(c_f * mu - lam, 1e-30)
    return torch.where(rho < 1.0, q,
                       torch.full_like(q, float(unstable_value)))


def mm1_wait(lam, mu, *, device=None) -> torch.Tensor:
    """Closed-form M/M/1 wait  rho / (mu - lam); used as a test oracle."""
    dev = common_device(lam, mu, device=device)
    lam = as_f32(lam, dev)
    mu = as_f32(mu, dev)
    rho = lam / mu
    w = rho / torch.clamp_min(mu - lam, 1e-30)
    return torch.where(rho < 1.0, w, torch.full_like(w, float("inf")))


def min_stable_replicas(lam, mu, *, device=None) -> torch.Tensor:
    """Smallest integer c with lam < c mu (Eq. 25 stability floor)."""
    dev = common_device(lam, mu, device=device)
    return (torch.floor(as_f32(lam, dev) / as_f32(mu, dev)) + 1).to(
        torch.int32)


# --------------------------------------------------------------------- #
# numpy control-plane variants (verbatim twins of the reference): the
# autoscaler / capacity planner run per-event in Python where per-call
# tensor dispatch is far too slow. Same math, same tests cover both.
# --------------------------------------------------------------------- #

def erlang_b_np(a: float, c: np.ndarray) -> np.ndarray:
    """Erlang-B via the inverse recurrence, vectorised over server counts.

    ``c`` must be a 1-D int array; returns B(a, c) per entry.
    """
    c = np.atleast_1d(np.asarray(c, np.int64))
    cmax = int(c.max())
    invb = np.empty(cmax + 1)
    invb[0] = 1.0
    for k in range(1, cmax + 1):
        # cap to keep the recurrence finite once B is numerically zero
        invb[k] = min(1.0 + (k / a) * invb[k - 1], 1e280)
    return 1.0 / invb[c]


def mmc_wait_np(lam: float, c: np.ndarray, mu: float) -> np.ndarray:
    """Expected M/M/c wait (Eq. 12), numpy, vectorised over c; inf if unstable."""
    c = np.atleast_1d(np.asarray(c, np.int64))
    if lam <= 0.0:
        return np.zeros(c.shape)
    a = lam / mu
    rho = lam / (c * mu)
    b = erlang_b_np(a, c)
    with np.errstate(divide="ignore", invalid="ignore"):
        cc = b / np.maximum(1.0 - rho * (1.0 - b), 1e-30)
        q = cc / np.maximum(c * mu - lam, 1e-30)
    return np.where(rho < 1.0, q, np.inf)


# --------------------------------------------------------------------- #
# Scalar fast paths for the per-event simulator hot loop, BIT-IDENTICAL
# to the array versions: every arithmetic op is the same IEEE-754 double
# op in the same order (``np.power`` on float64 scalars, NOT Python
# ``**`` — numpy 2.x ships its own pow that differs from libm in the
# last ulp on ~5% of inputs).
# --------------------------------------------------------------------- #

def erlang_b_scalar(a: float, c: int) -> float:
    """B(a, c) for one server count — bit-identical to erlang_b_np."""
    invb = 1.0
    for k in range(1, c + 1):
        invb = 1.0 + (k / a) * invb
        if invb > 1e280:       # same cap as erlang_b_np's min(), inlined
            invb = 1e280
    return 1.0 / invb


def mmc_wait_scalar(lam: float, c: int, mu: float) -> float:
    """Expected M/M/c wait (Eq. 12) — bit-identical scalar twin of
    mmc_wait_np; returns inf when unstable."""
    if lam <= 0.0:
        return 0.0
    cmu = c * mu
    if cmu <= 0.0:             # dead deployment (c == 0): no servers, no
        return float("inf")    # stability — never a phantom replica
    rho = lam / cmu
    if rho >= 1.0:
        return float("inf")
    b = erlang_b_scalar(lam / mu, c)
    cc = b / max(1.0 - rho * (1.0 - b), 1e-30)
    return cc / max(cmu - lam, 1e-30)


class ErlangMemo:
    """Memoised Erlang-C expected-wait lookups for the per-event control
    plane.

    Exact keys ``(c, lam)`` return exactly :func:`mmc_wait_scalar`'s
    values, so control decisions stay bit-identical to the uncached
    path. ``rho_buckets=K`` switches to approximate keys
    ``(c, floor(rho*K))`` with the wait evaluated at the bucket's
    lower-edge rho (``SimConfig.control_rho_buckets``, OFF by default);
    rho >= 1 short-circuits to inf before bucketing. The cache is
    cleared wholesale at ``max_entries``.
    """

    __slots__ = ("mu", "rho_buckets", "max_entries", "hits", "misses",
                 "_cache")

    def __init__(self, mu: float, rho_buckets: "int | None" = None,
                 max_entries: int = 1 << 16):
        self.mu = float(mu)
        self.rho_buckets = rho_buckets
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        # exact keys are (c, lam); bucketed keys are (c, bucket index)
        self._cache: dict[tuple[int, float], float] = {}

    def wait(self, lam: float, c: int) -> float:
        """Expected M/M/c wait E[W_q](lam, c) at this memo's mu."""
        if lam <= 0.0:
            return 0.0
        cmu = c * self.mu
        if cmu <= 0.0:         # c == 0: all pods dead — infinite wait,
            return float("inf")  # same contract as mmc_wait_scalar
        if lam / cmu >= 1.0:
            return float("inf")
        if self.rho_buckets is None:
            key = (c, lam)
            lam_eval = lam
        else:
            b = int(lam / cmu * self.rho_buckets)
            key = (c, b)
            lam_eval = b / self.rho_buckets * cmu
        cache = self._cache
        q = cache.get(key)
        if q is None:
            self.misses += 1
            q = mmc_wait_scalar(lam_eval, c, self.mu)
            if len(cache) >= self.max_entries:
                cache.clear()
            cache[key] = q
        else:
            self.hits += 1
        return q


def replicas_for_wait(lam: float, mu: float, target_wait: float,
                      max_c: int = MAX_SERVERS) -> int:
    """Smallest c such that E[W_q] <= target_wait (PM-HPA's inverse,
    paper §IV-D). Python-loop version for the control plane."""
    c0 = max(int(np.floor(lam / mu)) + 1, 1)
    cs = np.arange(c0, max_c + 1)
    q = mmc_wait_np(lam, cs, mu)
    ok = q <= target_wait
    return int(cs[np.argmax(ok)]) if ok.any() else max_c


def replicas_for_wait_batch(lam, mu, target_wait, *,
                            device=None) -> torch.Tensor:
    """Vectorised smallest-c search: evaluates Q for c = 1..MAX_SERVERS//8
    (a leading batch dimension over c) and takes the first feasible one."""
    dev = common_device(lam, mu, target_wait, device=device)
    lam = as_f32(lam, dev)
    mu = as_f32(mu, dev)
    target = as_f32(target_wait, dev)
    cs = torch.arange(1, MAX_SERVERS // 8 + 1, dtype=torch.int32,
                      device=dev)
    shape = torch.broadcast_shapes(lam.shape, mu.shape)
    cs_b = cs.reshape((-1,) + (1,) * len(shape))
    q = mmc_wait(lam.expand(shape)[None], cs_b, mu.expand(shape)[None])
    ok = q <= target
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    return torch.where(ok.any(dim=0), cs[first], cs[-1])
