"""Dispatch facade for the port's routing kernels.

Each op has two execution paths, chosen per call with ``impl=``:

* ``"ref"``  — the plain PyTorch version (``repro_torch.kernels.ref``),
  on whatever device the inputs live on;
* ``"cuda"`` — the hand-written CUDA kernel. Its inputs must lie on a
  CUDA device: a CPU tensor raises here instead of silently running the
  plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

IMPLS = ("ref", "cuda")


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
    if impl == "ref":
        return _ref.routing_score_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                      slo, cost, erlang_c_table)
    from repro_torch.kernels import routing_score as rs
    return rs.routing_score(lam, alpha, beta, gamma, mu, n, rtt, slo, cost,
                            erlang_c_table)


def routing_guard(lam, alpha, beta, gamma, mu, n, rtt, tau, home, up,
                  erlang_c_table, impl: str = "ref"):
    """Fused Algorithm-1 guarded routing. See ``ref.routing_guard_ref``."""
    _require_cuda("routing_guard", lam, impl)
    if impl == "ref":
        return _ref.routing_guard_ref(lam, alpha, beta, gamma, mu, n, rtt,
                                      tau, home, up, erlang_c_table)
    from repro_torch.kernels import routing_decide as rd
    return rd.routing_guard(lam, alpha, beta, gamma, mu, n, rtt, tau, home,
                            up, erlang_c_table)
