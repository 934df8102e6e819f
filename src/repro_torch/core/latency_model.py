"""Closed-form, dual-purpose latency model (paper §III).

End-to-end latency of a request served by model ``m`` on instance ``i``
(Eq. 1):

    L_t = L_infer(m,i) + D_net(t,i) + Q(m,i)

with

  * processing (Eq. 5):  L_infer = (L_m / S_mi) * (1 + U_i^gamma)
  * affine power law (Eq. 8):  L_infer = alpha_i + beta_mi * lam_tilde^gamma
  * queueing (Eq. 12):  Erlang-C M/M/c wait.

Both instantiations the paper derives are provided:

  * :func:`g_fixed_replicas`  — g_mi(lambda), Eq. (15): replica layout fixed,
    latency as a function of the arrival-rate vector. Drives millisecond-scale
    routing (Algorithm 1 line 9/16).
  * :func:`g_fixed_traffic`   — g_mi(N), Eq. (17): traffic fixed, latency as a
    function of replica count. Drives capacity planning (Eq. 23) and PM-HPA.

Calibration (:func:`calibrate`) fits (alpha, beta, gamma) to measured
(lam_per_replica, latency) pairs by log-space least squares + golden-section
search over gamma — the procedure the paper applies to Table IV to obtain
alpha=0.73, beta=1.29, gamma=1.49.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import queueing


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Catalogue entry for an inference model m (paper §III-B, Table II)."""

    name: str
    l_ref: float       # L_m: steady-state latency on the reference device [s]
    r_demand: float    # R_m: resource demand per inference [CPU-s]
    accuracy: float    # a_m in [0, 1]
    kv_growth: bool = True  # False for SSM/hybrid: O(1) decode state (DESIGN §4)


@dataclasses.dataclass(frozen=True)
class InstanceClass:
    """An edge/cloud instance class i (paper §III-B3, Table III)."""

    name: str
    speedup: float        # S_mi hardware speed-up vs reference
    r_max: float          # R_i^max: sustainable compute budget [CPU-s/s]
    background: float     # B_i: co-tenant load [CPU-s/s]
    net_rtt: float        # D_net: round-trip to this tier [s]
    cost: float           # c_mi: per-replica cost (Eq. 23)
    tier: str = "edge"    # "edge" | "cloud"


# --- Paper's own workload profiles (Table II, kept verbatim) ---------------
EFFICIENTDET = ModelProfile("efficientdet", l_ref=0.09, r_demand=0.10, accuracy=0.25)
YOLOV5M = ModelProfile("yolov5m", l_ref=0.73, r_demand=1.00, accuracy=0.641)
FASTER_RCNN = ModelProfile("faster_rcnn", l_ref=2.50, r_demand=3.00, accuracy=0.75)

# Reference edge instance: Raspberry Pi 4 VM, 3 CPU cores (§III-B, Table II).
PI4_EDGE = InstanceClass("pi4-edge", speedup=1.0, r_max=3.0, background=0.0,
                         net_rtt=0.0, cost=1.0, tier="edge")
# Cloud tier: Ericsson cluster, 36 ms RTT (§V-A2). Speed-up ~4x vs Pi.
CLOUD = InstanceClass("cloud", speedup=4.0, r_max=19.0, background=0.0,
                      net_rtt=0.036, cost=2.5, tier="cloud")


def utilisation(lam_r, r_demand, background, r_max):
    """Instantaneous utilisation U_i (Eq. 6), for one model's traffic on i."""
    return (lam_r * r_demand + background) / r_max


def processing_delay(l_ref, speedup, util: torch.Tensor,
                     gamma) -> torch.Tensor:
    """Inference processing delay (Eq. 5): (L_m/S_mi)(1 + U^gamma)."""
    u = torch.clamp_min(util, 0.0)
    return (l_ref / speedup) * (1.0 + torch.pow(u, gamma))


def affine_power_law(lam_tilde: torch.Tensor, alpha, beta,
                     gamma) -> torch.Tensor:
    """Affine power-law form (Eq. 8): alpha + beta * lam_tilde^gamma."""
    return alpha + beta * torch.pow(torch.clamp_min(lam_tilde, 0.0), gamma)


def affine_params(m: ModelProfile, i: InstanceClass, gamma: float) -> tuple[float, float]:
    """(alpha_i, beta_mi) from first principles (Eq. 9)."""
    base = m.l_ref / i.speedup
    alpha = base * (1.0 + (i.background / i.r_max) ** gamma)
    beta = base * (m.r_demand / i.r_max) ** gamma
    return alpha, beta


def service_rate(m: ModelProfile, i: InstanceClass) -> float:
    """mu_mi = S_mi / L_m (paper §III-D)."""
    return i.speedup / m.l_ref


def g_fixed_replicas(lam_m, n_replicas, m: ModelProfile, i: InstanceClass,
                     gamma: float, *, unstable_value: float = float("inf"),
                     device=None) -> torch.Tensor:
    """g_mi(lambda), Eq. (15): end-to-end latency with the replica layout fixed.

    processing + network + M/M/c queueing, vectorised over lam_m. The
    result lives on ``lam_m``'s device (or ``device``; the card unless
    the caller asks for the CPU).
    """
    dev = queueing.common_device(lam_m, n_replicas, device=device)
    lam_m = queueing.as_f32(lam_m, dev)
    n = queueing.as_f32(n_replicas, dev)
    lam_tilde = lam_m / n                                  # Eq. (10)
    util = utilisation(lam_tilde, m.r_demand, i.background, i.r_max)
    proc = processing_delay(m.l_ref, i.speedup, util, gamma)
    mu = service_rate(m, i)
    q = queueing.mmc_wait(lam_m, n.to(torch.int32), mu,
                          unstable_value=unstable_value)
    return proc + i.net_rtt + q


def g_fixed_replicas_np(lam_m: float, n_replicas: int | np.ndarray,
                        m: ModelProfile, i: InstanceClass,
                        gamma: float) -> np.ndarray:
    """numpy twin of :func:`g_fixed_replicas` for control-plane call sites
    (autoscaler, capacity planner) where per-call tensor dispatch is too slow.
    Vectorised over ``n_replicas`` (1-D int array) at scalar ``lam_m``."""
    n = np.atleast_1d(np.asarray(n_replicas, np.int64))
    lam = float(lam_m)
    lam_tilde = lam / np.maximum(n, 1)
    util = (lam_tilde * m.r_demand + i.background) / i.r_max
    proc = (m.l_ref / i.speedup) * (1.0 + np.power(np.maximum(util, 0.0), gamma))
    q = queueing.mmc_wait_np(lam, n, service_rate(m, i))
    return proc + i.net_rtt + q


def g_fixed_traffic(n_replicas, lam_m, m: ModelProfile, i: InstanceClass,
                    gamma: float, *, unstable_value: float = float("inf"),
                    device=None) -> torch.Tensor:
    """g_mi(N), Eq. (17): latency as a function of the replica count.

    Identical terms; the paper keeps processing/network "constant" in this
    view because lambda is fixed — we still let utilisation fall as replicas
    share the load (the per-replica arrival rate drops with N), which is the
    behaviour Table IV measures.
    """
    return g_fixed_replicas(lam_m, n_replicas, m, i, gamma,
                            unstable_value=unstable_value, device=device)


# --- Latency distributions & SLO-attainment ----------------------
#
# The point estimates above are medians of the realised latency: the
# simulator draws S = base * LogNormal(0, sigma), whose median is exactly
# the base. Treating g as the median of a lognormal with log-dispersion
# sigma gives the closed form
#
#     P(L <= slo) = Phi((ln slo - ln g) / sigma)
#
# which is what a reliability-aware policy (FogROS2-PLR style,
# arXiv:2410.05562) routes on instead of g itself. scipy is not a
# dependency, so the normal CDF goes through math.erf.

_SQRT2 = math.sqrt(2.0)
_erf = np.vectorize(math.erf, otypes=[np.float64])


def slo_attain_prob(g: float | np.ndarray, sigma: float | np.ndarray,
                    slo: float | np.ndarray) -> np.ndarray:
    """Closed-form P(latency <= slo) for a lognormal latency whose
    MEDIAN is the point estimate ``g`` and whose log-space dispersion is
    ``sigma`` (matching the simulator's multiplicative
    ``LogNormal(0, sigma)`` service jitter). Broadcasts over any mix of
    scalars and arrays; ``sigma <= 0`` degrades to the deterministic
    step ``g <= slo``; non-positive or non-finite ``g`` (e.g. the BIG
    infeasibility sentinel saturating to inf) attains with probability
    ~0 unless the SLO is infinite."""
    g = np.asarray(g, np.float64)
    s = np.asarray(sigma, np.float64)
    tau = np.asarray(slo, np.float64)
    g, s, tau = np.broadcast_arrays(g, s, tau)
    ok = (g > 0.0) & np.isfinite(g) & (tau > 0.0) & np.isfinite(tau)
    safe_g = np.where(ok, g, 1.0)
    safe_tau = np.where(ok, tau, 1.0)
    with np.errstate(divide="ignore"):
        z = (np.log(safe_tau) - np.log(safe_g)) \
            / (np.maximum(s, 1e-300) * _SQRT2)
    p = 0.5 * (1.0 + _erf(np.clip(z, -40.0, 40.0)))
    p = np.where(s <= 0.0, (safe_g <= safe_tau).astype(np.float64), p)
    # outside the sane domain: an infinite SLO is always met, anything
    # else against a degenerate point estimate is never met
    p = np.where(ok, p, np.where(tau > 0.0, (g <= tau).astype(np.float64),
                                 0.0))
    return p


@dataclasses.dataclass(frozen=True)
class LatencyDistribution:
    """Per-link / per-pod latency model: point estimate (median),
    log-space dispersion, and delivery availability. ``attain`` is the
    reliability score the ``reliable`` routing policy maximises:
    P(delivered) * P(latency <= slo | delivered)."""

    point: float               # median end-to-end latency [s]
    sigma: float = 0.0         # lognormal log-dispersion
    availability: float = 1.0  # P(the link delivers at all)

    def attain(self, slo: float) -> float:
        return float(self.availability
                     * slo_attain_prob(self.point, self.sigma, slo))


@dataclasses.dataclass(frozen=True)
class CalibratedModel:
    """Fit result of Eq. (8) for one (m, i) pair."""

    alpha: float
    beta: float
    gamma: float
    mape: float  # mean absolute percentage error on the calibration set

    def predict(self, lam_tilde, device=None) -> torch.Tensor:
        return affine_power_law(queueing.as_f32(lam_tilde, device),
                                self.alpha, self.beta, self.gamma)


def _fit_alpha_beta(lam_tilde: np.ndarray, lat: np.ndarray, gamma: float,
                    fixed_alpha: float | None = None) -> tuple[float, float, float]:
    """For fixed gamma, (alpha, beta) is a linear least-squares problem.

    ``fixed_alpha`` pins the intercept (the paper pins alpha = L_m, the idle
    latency, and fits only the slope/exponent — see Fig. 2 where alpha = 0.73
    exactly equals Table II's L_m for YOLOv5m).
    """
    x = np.power(np.maximum(lam_tilde, 0.0), gamma)
    if fixed_alpha is None:
        a = np.stack([np.ones_like(x), x], axis=1)
        coef, *_ = np.linalg.lstsq(a, lat, rcond=None)
        alpha, beta = float(coef[0]), float(coef[1])
    else:
        alpha = fixed_alpha
        beta = float(np.dot(x, lat - alpha) / np.dot(x, x))
    pred = alpha + beta * x
    resid = float(np.mean((pred - lat) ** 2))
    return alpha, beta, resid


def calibrate(lam_tilde: Sequence[float], latency: Sequence[float],
              gamma_bounds: tuple[float, float] = (0.1, 4.0),
              iters: int = 60, fixed_alpha: float | None = None) -> CalibratedModel:
    """Fit (alpha, beta, gamma) of Eq. (8) to measurements.

    Golden-section search over gamma (the objective is unimodal in practice),
    linear least squares for (alpha, beta) at each gamma. Only three
    parameters per hardware tier — the paper's headline calibration cost.
    ``fixed_alpha`` pins the intercept to the idle latency L_m as the paper does.
    """
    lam_arr = np.asarray(lam_tilde, np.float64)
    lat_arr = np.asarray(latency, np.float64)
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo, hi = gamma_bounds
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc = _fit_alpha_beta(lam_arr, lat_arr, c, fixed_alpha)[2]
    fd = _fit_alpha_beta(lam_arr, lat_arr, d, fixed_alpha)[2]
    for _ in range(iters):
        if fc < fd:
            hi, d, fd = d, c, fc
            c = hi - gr * (hi - lo)
            fc = _fit_alpha_beta(lam_arr, lat_arr, c, fixed_alpha)[2]
        else:
            lo, c, fc = c, d, fd
            d = lo + gr * (hi - lo)
            fd = _fit_alpha_beta(lam_arr, lat_arr, d, fixed_alpha)[2]
    gamma = 0.5 * (lo + hi)
    alpha, beta, _ = _fit_alpha_beta(lam_arr, lat_arr, gamma, fixed_alpha)
    pred = alpha + beta * np.power(np.maximum(lam_arr, 0.0), gamma)
    nz = lat_arr > 1e-9
    mape = float(np.mean(np.abs(pred[nz] - lat_arr[nz]) / lat_arr[nz]))
    return CalibratedModel(alpha=alpha, beta=beta, gamma=gamma, mape=mape)


# Paper Table IV: measured mean per-inference latency of YOLOv5m [s]
# rows: N in {1, 2, 4}; cols: lambda in {1, 2, 3, 4} req/s, 3 CPUs/replica.
TABLE_IV_N = np.array([1, 2, 4])
TABLE_IV_LAMBDA = np.array([1.0, 2.0, 3.0, 4.0])
TABLE_IV_LATENCY = np.array([
    [0.73, 4.97, 7.71, 10.46],
    [0.73, 1.26, 3.76, 5.12],
    [0.73, 0.90, 1.12, 1.77],
])


def calibrate_from_table_iv(saturated_only: bool = True) -> CalibratedModel:
    """Reproduce the paper's Fig. 2 fit on its own Table IV data.

    The paper fits the per-replica law on the loaded region (the idle point
    lam_tilde <= 1 pins alpha ~= L_m = 0.73 which the fit recovers anyway).
    """
    lam_tilde: list[float] = []
    lat: list[float] = []
    for ri, n in enumerate(TABLE_IV_N):
        for ci, lam in enumerate(TABLE_IV_LAMBDA):
            lt = lam / n
            if saturated_only and lt <= 1.0:
                continue  # idle region: latency pinned at L_m, outside the power law
            lam_tilde.append(lt)
            lat.append(TABLE_IV_LATENCY[ri, ci])
    # Pin alpha to the idle latency L_m = 0.73 s exactly as the paper's
    # Fig. 2 fit does (its alpha equals Table II's L_m to the digit).
    return calibrate(lam_tilde, lat, fixed_alpha=YOLOV5M.l_ref)
