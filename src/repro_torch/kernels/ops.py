"""Dispatch facade for the port's kernels (routing, attention, SSD scan,
state step and decode mixer, experts).

Each op has three execution paths, chosen per call with ``impl=``:

* ``"ref"``   — the plain PyTorch version (``repro_torch.kernels.ref``),
  on whatever device the inputs live on;
* ``"cuda"``  — the hand-written CUDA kernel. Its inputs must lie on a
  CUDA device: a CPU tensor raises here instead of silently running the
  plain version. The kernels have no backward: their wrappers refuse
  inputs that need a gradient;
* ``"fused"`` — the attention and SSD scan ops through
  ``repro_torch.kernels.fused`` (plain torch on any device, blocked
  attention with a hand-written backward: the path training takes); the
  routing ops, the SSD state step and decode mixer and the expert GEMM,
  which have no fused form, run their plain versions, as the reference's
  facade does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused
from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "cuda", "fused")


def _require_cuda(op: str, x: torch.Tensor, impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"{op}(impl='cuda') got tensors on {x.device}: "
                         "the CUDA kernel needs CUDA tensors (use "
                         "impl='ref' for the plain version)")


def routing_score(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                  erlang_c_table, impl: str = "ref"):
    """Batched LA-IMR routing decisions. See ``ref.routing_score_ref``."""
    _require_cuda("routing_score", lam, impl)
    if impl in ("ref", "fused"):
        return _ref.routing_score_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                      slo, cost, erlang_c_table)
    from repro_torch.kernels import routing_score as rs
    return rs.routing_score(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                            erlang_c_table)


def routing_guard(lam, alpha, beta, gamma, mu, n, rtt, tau, home, up,
                  erlang_c_table, impl: str = "ref"):
    """Fused Algorithm-1 guarded routing. See ``ref.routing_guard_ref``."""
    _require_cuda("routing_guard", lam, impl)
    if impl in ("ref", "fused"):
        return _ref.routing_guard_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                      tau, home, up, erlang_c_table)
    from repro_torch.kernels import routing_decide as rd
    return rd.routing_guard(lam, alpha, beta, gamma, mu, n, rtt, tau, home,
                            up, erlang_c_table)


def routing_topk(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                 erlang_c_table, k: int = 2, margin: float = 0.0,
                 impl: str = "ref"):
    """Fused top-k feasible select. See ``ref.routing_topk_ref``."""
    _require_cuda("routing_topk", lam, impl)
    if impl in ("ref", "fused"):
        return _ref.routing_topk_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                     slo, cost, erlang_c_table, k=k,
                                     margin=margin)
    from repro_torch.kernels import routing_decide as rd
    return rd.routing_topk(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                           erlang_c_table, k=k, margin=margin)


def routing_attain(lam, alpha, beta, gamma, mu, n, rtt, slo, sigma, avail,
                   erlang_c_table, k: int = 2, margin: float = 0.0,
                   impl: str = "ref"):
    """Fused attainment-argmax select. See ``ref.routing_attain_ref``."""
    _require_cuda("routing_attain", lam, impl)
    if impl in ("ref", "fused"):
        return _ref.routing_attain_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                       slo, sigma, avail, erlang_c_table,
                                       k=k, margin=margin)
    from repro_torch.kernels import routing_decide as rd
    return rd.routing_attain(lam, alpha, beta, gamma, mu, n, rtt, slo,
                             sigma, avail, erlang_c_table, k=k,
                             margin=margin)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
              segment_pos=None, impl: str = "ref"):
    """Multi-head attention (GQA / window / softcap). See
    ``ref.flash_attention_ref``."""
    _require_cuda("attention", q, impl)
    if impl == "fused":
        return fused.fused_attention(q, k, v, causal, window, softcap, scale,
                                     segment_pos)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale, segment_pos=segment_pos)
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              segment_pos=segment_pos)


def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, *, window=0,
                     softcap=0.0, scale=None, impl: str = "ref"):
    """Single-token attention against a KV cache. See
    ``ref.decode_attention_ref``."""
    _require_cuda("decode_attention", q, impl)
    if impl == "fused":
        return fused.fused_decode_attention(q, k_cache, v_cache, kv_pos,
                                            q_pos, window=window,
                                            softcap=softcap, scale=scale)
    if impl == "ref":
        return _ref.decode_attention_ref(q, k_cache, v_cache, kv_pos, q_pos,
                                         window=window, softcap=softcap,
                                         scale=scale)
    from repro_torch.kernels import decode_attention as da
    return da.decode_attention(q, k_cache, v_cache, kv_pos, q_pos,
                               window=window, softcap=softcap, scale=scale)


def ssd_scan(x, dt, a, b, c, d_skip, initial_state=None,
             return_final_state=False, impl: str = "ref", chunk: int = 64):
    """Mamba-2 SSD scan. See ``ref.ssd_scan_ref``. ``chunk`` is the
    fused path's chunk length (the kernel's is fixed at 64)."""
    _require_cuda("ssd_scan", x, impl)
    if impl == "fused":
        return fused.fused_ssd_scan(x, dt, a, b, c, d_skip,
                                    initial_state=initial_state,
                                    return_final_state=return_final_state,
                                    chunk=chunk)
    if impl == "ref":
        return _ref.ssd_scan_ref(x, dt, a, b, c, d_skip,
                                 initial_state=initial_state,
                                 return_final_state=return_final_state)
    from repro_torch.kernels import ssd_scan as ssd
    return ssd.ssd_scan(x, dt, a, b, c, d_skip, initial_state=initial_state,
                        return_final_state=return_final_state)


def ssd_step(h, dt, a, x, b, c, d_skip, impl: str = "ref"):
    """One decode token's Mamba-2 state update, h in place. See
    ``ref.ssd_step_ref``; ``"fused"`` runs the plain version."""
    _require_cuda("ssd_step", h, impl)
    if impl in ("ref", "fused"):
        return _ref.ssd_step_ref(h, dt, a, x, b, c, d_skip)
    from repro_torch.kernels import ssd_step as step
    return step.ssd_step(h, dt, a, x, b, c, d_skip)


def ssd_conv_step(u, dt_raw, buf, w, bias, dt_bias, impl: str = "ref"):
    """One decode token of the Mamba-2 conv with SiLU, its buffer shifted
    in place, and dt. See ``ref.ssd_conv_step_ref``; ``"fused"`` runs
    the plain version."""
    _require_cuda("ssd_conv_step", buf, impl)
    if impl in ("ref", "fused"):
        return _ref.ssd_conv_step_ref(u, dt_raw, buf, w, bias, dt_bias)
    from repro_torch.kernels import ssd_step as step
    return step.ssd_conv_step(u, dt_raw, buf, w, bias, dt_bias)


def ssd_state_step(h, dt, a_log, x, b, c, d_skip, impl: str = "ref"):
    """``ssd_step`` with a from a_log and B, C by group. See
    ``ref.ssd_state_step_ref``; ``"fused"`` runs the plain version."""
    _require_cuda("ssd_state_step", h, impl)
    if impl in ("ref", "fused"):
        return _ref.ssd_state_step_ref(h, dt, a_log, x, b, c, d_skip)
    from repro_torch.kernels import ssd_step as step
    return step.ssd_state_step(h, dt, a_log, x, b, c, d_skip)


def ssd_gated_norm(y, z, scale, groups, gate_first, eps, impl: str = "ref"):
    """The Mamba-2 gated RMSNorm of one decode token. See
    ``ref.ssd_gated_norm_ref``; ``"fused"`` runs the plain version."""
    _require_cuda("ssd_gated_norm", y, impl)
    if impl in ("ref", "fused"):
        return _ref.ssd_gated_norm_ref(y, z, scale, groups, gate_first, eps)
    from repro_torch.kernels import ssd_step as step
    return step.ssd_gated_norm(y, z, scale, groups, gate_first, eps)


def moe_gemm(a, rows, w, plan, act: str = "none", out_dtype=None,
             impl: str = "ref"):
    """The grouped expert GEMM of a dropless MoE layer. See
    ``ref.moe_gemm_ref``; ``"fused"`` runs the plain version."""
    _require_cuda("moe_gemm", a, impl)
    if impl in ("ref", "fused"):
        return _ref.moe_gemm_ref(a, rows, w, plan.counts, act, out_dtype)
    from repro_torch.kernels import moe_gemm as mg
    return mg.moe_gemm(a, rows, w, plan, act=act, out_dtype=out_dtype)
