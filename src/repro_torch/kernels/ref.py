"""Plain PyTorch versions of the routing decision kernels.

These are the semantics contract for the hand-written CUDA kernels in
this package: each kernel's check on the card holds it against the
function here on the same inputs. They are torch twins of the
reference package's routing oracles (``repro.kernels.ref``): the
power law through ``torch.pow`` and the Erlang-C wait through a
``lo/frac`` gather-lerp on the rho grid. The CUDA kernels instead follow
the TPU kernels' arithmetic (``exp(gamma*log(x))`` and a hat-function
sum), so kernel and plain version agree on ``ok``/``offloaded`` exactly,
on the chosen index wherever a row is feasible, and on g within
``rtol=1e-4``.

They run on any device; ``AdmissionConfig(backend="ref")`` uses them,
and the kernel wrappers use them for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.routing_decide import UNSTABLE_G, apply_guard


def _table_scores(lam: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                  n: torch.Tensor, rtt: torch.Tensor,
                  erlang_c_table: torch.Tensor):
    """(g, rho) over the (R, I) decision matrix with the Erlang-C wait
    read from the precomputed table (gather + linear interpolation on
    the rho grid). Shared by both routing functions below."""
    t = erlang_c_table.shape[1]
    lam_ = lam.to(torch.float32)              # (R,) or per-candidate (R, I)
    if lam_.ndim == 1:
        lam_ = lam_[:, None]                                   # (R, 1)
    lam_tilde = lam_ / torch.clamp_min(n[None, :], 1.0)
    proc = alpha[None, :] + beta[None, :] * torch.pow(
        torch.clamp_min(lam_tilde, 0.0), gamma[None, :])
    rho = lam_ / torch.clamp_min(n[None, :] * mu[None, :], 1e-12)  # (R, I)
    pos = torch.clamp(rho, 0.0, 1.0) * (t - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, t - 2)
    frac = pos - lo.to(torch.float32)
    tbl = erlang_c_table.to(torch.float32).reshape(-1)
    base = torch.arange(erlang_c_table.shape[0], device=lo.device)[None, :] * t
    q_lo = tbl[base + lo]
    q_hi = tbl[base + lo + 1]
    q = q_lo * (1 - frac) + q_hi * frac
    return proc + rtt[None, :] + q, rho


def routing_score_ref(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                      erlang_c_table):
    """Batched LA-IMR routing decision (plain version of
    ``routing_score.routing_score``).

    For each request r (rate ``lam[r]``, (R,), or per-candidate rates
    (R, I)) against I candidate deployments: g = affine power law + RTT
    + Erlang-C wait read from the (I, T) table; infeasible where
    ``g > slo`` or ``rho >= 1``; argmin g with the 1e-5 relative near
    band, then the cheapest among the near ties. ``slo`` is (I,) or
    (R, I) with -1 as a lane exclusion. Returns (idx (R,) int32, g at
    idx (R,) float32, feasible (R,) bool).
    """
    slo_ = slo.to(torch.float32)
    if slo_.ndim == 1:
        slo_ = slo_[None, :]
    g, rho = _table_scores(lam, alpha, beta, gamma, mu, n, rtt,
                           erlang_c_table)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=g.device)
    feasible = (rho < 1.0) & (g <= slo_)
    g_masked = torch.where(feasible, g, inf)
    gmin = g_masked.amin(dim=1, keepdim=True)
    near = feasible & (g_masked <= gmin * (1.0 + 1e-5) + 1e-9)
    idx = torch.argmin(torch.where(near, cost[None, :].expand(g.shape), inf),
                       dim=1)
    best_g = torch.gather(g, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best_g, feasible.any(dim=1)


def routing_guard_ref(lam, alpha, beta, gamma, mu, n, rtt, tau, home, up,
                      erlang_c_table):
    """Fused Algorithm-1 guarded routing (plain version of
    ``routing_decide.routing_guard``).

    Scores every candidate, reads the per-request home column with the
    1e9 sentinel where the pool is unstable, and applies the shared
    :func:`~repro_torch.kernels.routing_decide.apply_guard`. tau: (R,)
    guard budgets; home/up: (R,) int columns (up = -1 at the top tier).
    Returns (chosen (R,) int32, g at chosen (R,), offloaded (R,) bool).
    """
    g, rho = _table_scores(lam, alpha, beta, gamma, mu, n, rtt,
                           erlang_c_table)
    g_eff = torch.where(rho < 1.0, g, torch.full_like(g, UNSTABLE_G))
    home_ = home.to(torch.int64)
    up_ = up.to(torch.int64)
    g_home = torch.gather(g_eff, 1, home_[:, None])[:, 0]
    chosen, off = apply_guard(g_home, rtt[home_], tau.to(torch.float32),
                              up_, up_ >= 0, home_)
    g_sel = torch.gather(g_eff, 1, chosen[:, None])[:, 0]
    return chosen.to(torch.int32), g_sel, off
