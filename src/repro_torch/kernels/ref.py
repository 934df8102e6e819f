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
``rtol=1e-4``. ``routing_attain_ref`` takes Phi through ``torch.erf``,
the kernel through ``erff``, a few ulp apart; with the g difference
this moves an attainment probability by up to ~1e-6 at small sigma, so
a primary can differ only on a row with a candidate that close to the
band edge ``pmax - 1e-6``.

They run on any device; ``AdmissionConfig(backend="ref")`` uses them,
and the kernel wrappers use them for tensors that lie on the CPU.

The attention functions at the end are the plain versions of the two
attention kernels (``flash_attention_kernel``, ``decode_attention_kernel``
in ``csrc/attention.cu``): torch twins of ``repro.kernels.ref.attention``
and ``decode_attention`` with the same conventions, masked logits set to
``NEG_INF = -1e30`` (not ``-inf``, so a row with no valid key averages
V uniformly instead of giving NaN), float32 logits, probabilities and
P @ V, and the output cast to ``q``'s dtype.

``ssd_scan_ref`` is the plain version of the Mamba-2 SSD kernel
(``ssd_scan_kernel`` in ``csrc/ssd.cu``): the torch twin of the
reference's sequential oracle ``repro.kernels.ref.ssd_scan``, a float32
recurrence over the sequence, one step at a time. ``ssd_step_ref`` is
one decode token of that recurrence with the state updated in place,
the plain version of ``ssd_step_kernel``: the eager passes of the
reference's decode step. ``ssd_conv_step_ref``, ``ssd_state_step_ref``
and ``ssd_gated_norm_ref`` are the plain versions of the decode mixer's
three launches (``ssd_conv_step_kernel``, ``ssd_step_kernel`` with B and
C by group, ``ssd_gated_norm_kernel``): the conv step in tap order and
the gated norm in ``models/ssm.py: _gate_out``'s dtype steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.routing_decide import UNSTABLE_G, apply_guard

ATTAIN_BAND = 1e-6  # absolute attainment tie band of routing_attain
_SQRT2 = 1.4142135623730951


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


def _slo_rows(slo: torch.Tensor) -> torch.Tensor:
    slo_ = slo.to(torch.float32)
    return slo_[None, :] if slo_.ndim == 1 else slo_


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float32 as a 0-d tensor, so that ``slo - margin``
    subtracts the float32 margin as the kernels do. A fill, not a copy
    from the host: a copy from pageable memory would block the host
    until the stream drains."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=like.device)


def _dup_order(g: torch.Tensor, elig: torch.Tensor, ok: torch.Tensor,
               k: int):
    """k - 1 duplicate columns from a stable ascending-g argsort over
    the eligible set (ties to the lowest index) — the argsort twin of
    the kernels' one-pass-per-column argmin."""
    inf = torch.full((), float("inf"), dtype=torch.float32, device=g.device)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    order = torch.argsort(torch.where(elig, g, inf), dim=1, stable=True)
    cnt = elig.sum(dim=1)
    last = g.shape[1] - 1
    cols, gcols = [], []
    for j in range(1, k):
        # k may exceed I: such columns are never valid (cnt <= I - 1)
        cj = order[:, min(j - 1, last)]
        valid = ok & (cnt > j - 1)
        cols.append(torch.where(valid, cj, -1).to(torch.int32))
        gcols.append(torch.where(
            valid, torch.gather(g, 1, cj[:, None])[:, 0], zero))
    return cols, gcols


def _topk_outputs(g: torch.Tensor, rho: torch.Tensor,
                  feasible: torch.Tensor, primary: torch.Tensor,
                  gate: torch.Tensor, k: int):
    """(idx (R, k) int32, g (R, k), ok (R,)) shared by the top-k and
    attainment selects: column 0 the primary (-1 and the row minimum of
    the sentinel-masked scores on infeasible rows), then the duplicates."""
    ok = feasible.any(dim=1)
    g_eff = torch.where(rho < 1.0, g, torch.full_like(g, UNSTABLE_G))
    g_p = torch.gather(g, 1, primary[:, None])[:, 0]
    idx0 = torch.where(ok, primary, -1).to(torch.int32)
    g0 = torch.where(ok, g_p, g_eff.amin(dim=1))
    cols_i = torch.arange(g.shape[1], device=g.device)[None, :]
    elig = feasible & gate & (cols_i != primary[:, None])
    cols, gcols = _dup_order(g, elig, ok, k)
    return (torch.stack([idx0] + cols, dim=1),
            torch.stack([g0] + gcols, dim=1), ok)


def routing_topk_ref(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                     erlang_c_table, k: int = 2, margin: float = 0.0):
    """Fused top-k select (plain version of
    ``routing_decide.routing_topk``).

    Column 0 is the route_best primary (SLO filter + latency argmin +
    two-stage cost tie-break); columns 1..k-1 are the next feasible
    candidates in ascending-g order, primary excluded and headroom-gated
    by ``g <= slo - margin``, with -1 (and g 0) where fewer exist.
    Infeasible rows report idx -1 and the row-min score in g column 0
    (the predicted fallback). Returns (idx (R, k) int32, g (R, k)
    float32, ok (R,) bool).
    """
    slo_ = _slo_rows(slo)
    g, rho = _table_scores(lam, alpha, beta, gamma, mu, n, rtt,
                           erlang_c_table)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=g.device)
    feasible = (rho < 1.0) & (g <= slo_)
    g_masked = torch.where(feasible, g, inf)
    gmin = g_masked.amin(dim=1, keepdim=True)
    near = feasible & (g_masked <= gmin * (1.0 + 1e-5) + 1e-9)
    primary = torch.argmin(
        torch.where(near, cost[None, :].expand(g.shape), inf), dim=1)
    gate = g <= slo_ - _f32(margin, g)
    return _topk_outputs(g, rho, feasible, primary, gate, k)


def _attain_p(g: torch.Tensor, slo_: torch.Tensor, sigma: torch.Tensor,
              avail: torch.Tensor) -> torch.Tensor:
    """The delivery-weighted attainment probability of every (row,
    column): ``avail * Phi((ln slo - ln g) / (sigma * sqrt2))``, the step
    ``avail * (g <= slo)`` where ``sigma <= 0``; float32 throughout."""
    sig = sigma.to(torch.float32)[None, :]
    z = (torch.log(torch.clamp_min(slo_, 1e-20))
         - torch.log(torch.clamp_min(g, 1e-20))) \
        / (torch.clamp_min(sig, 1e-20) * _f32(_SQRT2, g))
    phi = 0.5 * (1.0 + torch.erf(torch.clamp(z, -10.0, 10.0)))
    return avail.to(torch.float32)[None, :] * torch.where(
        sig > 0.0, phi, (g <= slo_).to(torch.float32))


def routing_attain_ref(lam, alpha, beta, gamma, mu, n, rtt, slo, sigma,
                       avail, erlang_c_table, k: int = 2,
                       margin: float = 0.0):
    """Fused attainment-argmax select (plain version of
    ``routing_decide.routing_attain``).

    The primary maximises the delivery-weighted SLO-attainment
    probability ``avail * Phi((ln slo - ln g) / (sigma * sqrt2))`` over
    feasible candidates, in float32 (``sigma <= 0`` is the step
    ``g <= slo``); ties within an absolute 1e-6 band break toward lower
    g, then lower index, so uniform distributions degrade to argmin g.
    Duplicate columns and outputs as in :func:`routing_topk_ref`.
    """
    slo_ = _slo_rows(slo)
    g, rho = _table_scores(lam, alpha, beta, gamma, mu, n, rtt,
                           erlang_c_table)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=g.device)
    feasible = (rho < 1.0) & (g <= slo_)
    p = _attain_p(g, slo_, sigma, avail)
    p_masked = torch.where(feasible, p, torch.full_like(p, -1.0))
    pmax = p_masked.amax(dim=1, keepdim=True)
    nearp = feasible & (p_masked >= pmax - _f32(ATTAIN_BAND, g))
    primary = torch.argmin(torch.where(nearp, g, inf), dim=1)
    gate = g <= slo_ - _f32(margin, g)
    return _topk_outputs(g, rho, feasible, primary, gate, k)


# ---------------------------------------------------------------- attention
NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D): query head h reads kv
    head h // n_rep (GQA)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        segment_pos: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Full (quadratic) multi-head attention with GQA, sliding window
    and logit soft-capping; the plain version of ``flash_attention``.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D). ``causal`` masks key j
    above the query's position, ``window`` > 0 also masks j <= pos -
    window, ``softcap`` caps the logits with tanh. ``segment_pos``: (B,
    Sq) absolute query positions, by default suffix-aligned to the keys
    (``arange(Sq) + Skv - Sq``). Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv {hkv}")
    kf = _repeat_kv(k, h // hkv).to(torch.float32).transpose(1, 2)
    vf = _repeat_kv(v, h // hkv).to(torch.float32).transpose(1, 2)
    qf = q.to(torch.float32).transpose(1, 2)                # (B, H, Sq, D)
    scale = d ** -0.5 if scale is None else scale
    logits = _softcap(torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                      softcap)                              # (B, H, Sq, Skv)
    if segment_pos is None:
        qpos = (torch.arange(sq, device=q.device) + (skv - sq))[None, :] \
            .expand(b, sq)
    else:
        qpos = segment_pos
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vf).transpose(1, 2).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_pos: torch.Tensor,
                         q_pos: torch.Tensor, *, window: int = 0,
                         softcap: float = 0.0, scale: float | None = None
                         ) -> torch.Tensor:
    """One query per sequence against a (ring-buffered) KV cache; the
    plain version of ``decode_attention``.

    q: (B, H, D); k_cache, v_cache: (B, C, Hkv, D); kv_pos: (B, C) int32
    absolute position held in each slot, negative for a slot never
    written; q_pos: (B,) int32. A slot is valid when kv_pos >= 0 and
    kv_pos <= q_pos, and kv_pos > q_pos - window if ``window`` > 0. A
    row with no valid slot averages V over all C slots. Returns (B, H,
    D) in q's dtype.
    """
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    kf = _repeat_kv(k_cache, h // hkv).to(torch.float32)    # (B, C, H, D)
    vf = _repeat_kv(v_cache, h // hkv).to(torch.float32)
    scale = d ** -0.5 if scale is None else scale
    logits = _softcap(torch.einsum("bhd,bchd->bhc", q.to(torch.float32), kf)
                      * scale, softcap)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window > 0:
        valid &= kv_pos > (q_pos[:, None] - window)
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhc,bchd->bhd", probs, vf).to(q.dtype)


# ------------------------------------------------------------------- SSD
def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                 initial_state: torch.Tensor | None = None,
                 return_final_state: bool = False):
    """Mamba-2 SSD (state-space dual) as a sequential scan; the plain
    version of ``ssd_scan``.

    x: (B, L, H, P); dt: (B, L, H) positive step sizes; a: (H,) negative
    decay rates; b, c: (B, L, G, N), head h reading group h // (H / G);
    d_skip: (H,); initial_state: (B, H, P, N) or None (zeros). In
    float32, for t = 0 .. L-1::

        h = exp(dt_t * a) * h + (dt_t * x_t) b_t^T ;  y_t = h c_t

    then ``y += d_skip * x``. Returns y (B, L, H, P) in x's dtype, and
    with ``return_final_state`` also the last h (B, H, P, N) in float32.
    The state contraction is a product and a sum, not a matmul, so no
    TF32 setting reaches it.
    """
    bsz, length, heads, hp = x.shape
    groups, n = b.shape[2], b.shape[3]
    if length < 1 or groups < 1 or heads % groups:
        raise ValueError(f"ssd_scan: L {length}, H {heads}, G {groups}")
    rep = heads // groups
    b_h = b.to(torch.float32).repeat_interleave(rep, dim=2)   # (B, L, H, N)
    c_h = c.to(torch.float32).repeat_interleave(rep, dim=2)
    dtf = dt.to(torch.float32)
    decay = torch.exp(dtf * a.to(torch.float32))             # (B, L, H)
    xf = x.to(torch.float32)
    xin = xf * dtf[..., None]                                # dt * x
    if initial_state is None:
        h = torch.zeros((bsz, heads, hp, n), dtype=torch.float32,
                        device=x.device)
    else:
        h = initial_state.to(torch.float32)
    ys = []
    for t in range(length):
        h = h * decay[:, t, :, None, None] \
            + xin[:, t, :, :, None] * b_h[:, t, :, None, :]
        ys.append((h * c_h[:, t, :, None, :]).sum(-1))       # (B, H, P)
    y = torch.stack(ys, dim=1) \
        + xf * d_skip.to(torch.float32)[None, None, :, None]
    y = y.to(x.dtype)
    return (y, h) if return_final_state else y


def ssd_step_ref(h: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 d_skip: torch.Tensor) -> torch.Tensor:
    """One decode token's SSM recurrence; the plain version of
    ``ssd_step``. h: (B, H, P, N) float32, updated in place; dt: (B, H);
    a, d_skip: (H,); x: (B, H, P); b, c: (B, H, N), all float32::

        h = h * exp(dt * a) + (dt * x) b^T ;  y = h c + d_skip * x

    the update's products and its sum each rounded on its own (no fused
    multiply-add), y's sum over N in the einsum's order. Returns y (B, H,
    P) float32."""
    decay = torch.exp(dt * a)                             # (B, H)
    h.mul_(decay[..., None, None]).add_(
        (dt[..., None] * x)[..., None] * b[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, c)               # (B, H, P)
    return y + x * d_skip[None, :, None]


def ssd_conv_step_ref(u: torch.Tensor, dt_raw: torch.Tensor,
                      buf: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      dt_bias: torch.Tensor):
    """One decode token of the depthwise causal conv, and dt; the plain
    version of ``ssd_conv_step``. u: (B, C) new inputs; dt_raw: (B, H);
    buf: (B, W-1, C) the W-1 inputs before u, shifted in place; w: (W, C)
    taps; bias: (C,), all in the model dtype; dt_bias: (H,) float32::

        out = silu(e_0 w_0 + ... + e_{W-1} w_{W-1} + bias)   (float32)
        dt  = softplus(dt_raw + dt_bias)                       (float32)

    over the window e = [buf, u], the sum in tap order with each product
    and sum rounded on its own. Returns (out (B, C), dt (B, H))."""
    ext = torch.cat([buf, u[:, None]], dim=1)            # (B, W, C)
    acc = ext[:, 0].to(torch.float32) * w[0].to(torch.float32)
    for k in range(1, w.shape[0]):
        acc = acc + ext[:, k].to(torch.float32) * w[k].to(torch.float32)
    out = torch.nn.functional.silu(acc + bias.to(torch.float32))
    buf.copy_(ext[:, 1:])
    dt = torch.nn.functional.softplus(dt_raw.to(torch.float32) + dt_bias)
    return out, dt


def ssd_state_step_ref(h: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d_skip: torch.Tensor) -> torch.Tensor:
    """``ssd_step_ref`` with a = -exp(a_log) and B and C given by group:
    b, c (B, G, N), head h reading group h / (H / G); the plain version
    of ``ssd_state_step``. Returns y (B, H, P) float32, h updated in
    place."""
    rep = h.shape[1] // b.shape[1]
    return ssd_step_ref(h, dt, -torch.exp(a_log), x,
                        b.repeat_interleave(rep, dim=1),
                        c.repeat_interleave(rep, dim=1), d_skip)


def ssd_gated_norm_ref(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                       groups: int, gate_first: bool,
                       eps: float) -> torch.Tensor:
    """The Mamba-2 gated RMSNorm of one decode token; the plain version of
    ``ssd_gated_norm``. y: (B, D) float32, cast first to z's dtype (the
    model dtype) as the decode step casts it; z: (B, D); scale: (D,)
    float32. ``gate_first`` False: rmsnorm(y) * silu(z), the norm over
    the whole width, the SiLU in float32 cast to the model dtype;
    ``gate_first``: rmsnorm(y * silu(z)) over each of ``groups`` groups
    of the width, in float32 and cast once. Returns (B, D) in z's
    dtype."""
    dtype = z.dtype
    yf = y.to(dtype).to(torch.float32)
    zs = torch.nn.functional.silu(z.to(torch.float32))
    if not gate_first:
        var = yf.square().mean(dim=-1, keepdim=True)
        n = (yf * torch.rsqrt(var + eps) * (1.0 + scale)).to(dtype)
        return n * zs.to(dtype)
    g = (yf * zs).unflatten(-1, (groups, -1))
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    return (g.flatten(-2) * (1.0 + scale)).to(dtype)


# ------------------------------------------------------------ experts
def moe_gemm_ref(a: torch.Tensor, rows: torch.Tensor | None,
                 w: torch.Tensor, counts: torch.Tensor, act: str = "none",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The grouped expert GEMM; the plain version of ``moe_gemm``.

    a: (T, K); rows: (P,) the row of ``a`` each sorted row reads, or
    None (row r is ``a[r]``); w: (E, K, N); counts: (E,) rows per expert,
    the rows sorted by expert. Row r of the (P, N) result is
    act(a[rows[r]] @ w[e]) for the expert e whose block of rows holds r,
    the product of the float32 operands (exact for bf16 inputs) with
    ``act`` ("relu2": the ReLU squared) applied before the cast to
    ``out_dtype`` (default a's). A loop over the experts that have rows,
    their counts read on the host."""
    x = a if rows is None else a[rows]
    out = torch.empty((x.shape[0], w.shape[2]), dtype=out_dtype or a.dtype,
                      device=a.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            h = x[start:start + n].to(torch.float32) @ w[e].to(torch.float32)
            if act == "relu2":
                h = torch.relu(h).square()
            out[start:start + n] = h.to(out.dtype)
        start += n
    return out
