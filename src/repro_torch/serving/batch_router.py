"""Serving adapter over the unified control plane.

The batched admission-window loop's decision core lives in
:mod:`repro_torch.control`, so the live serving engine and the
discrete-event simulator route through literally the same policy
object. :class:`BatchRouter` is now a thin back-compat adapter:
it *is* a :class:`~repro_torch.control.plane.ControlPlane` (same constructor,
same ``submit``/``flush``/conservation contract, same engine-slot
binding), plus the older private surface (``_deps``,
``_lam_matrix``, ``_score_select``, ...) that tests and benchmarks
pinned, delegating to the shared routing policy.

Semantics (admission windows, the f32-pinned decision boundary, the
conservation contract) are documented where they live:
``repro_torch/control/policies/base.py`` and
``repro_torch/control/admission.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.admission import (ADMITTED, DUPLICATE, OFFLOADED,
                                     REJECTED, AdmissionConfig,
                                     AdmissionDecision, SlotBank)
from repro_torch.control.fleet import FleetPlane, PodGroup
from repro_torch.control.plane import ControlPlane
from repro_torch.core.scheduler import Request

__all__ = [
    "ADMITTED", "DUPLICATE", "OFFLOADED", "REJECTED", "AdmissionConfig",
    "AdmissionDecision", "BatchRouter", "FleetPlane", "PodGroup",
    "SlotBank", "route_window_scalar",
]


class BatchRouter(ControlPlane):
    """The live serving engine's admission loop — a named adapter over
    :class:`ControlPlane` keeping the older private attribute surface for
    tests/benchmarks. All behaviour lives in the shared plane."""

    @property
    def _deps(self):
        return self.policy.deps

    def _n(self) -> np.ndarray:
        return self.policy.table.n()

    def _lam_matrix(self, reqs: list[Request], t_now: float) -> np.ndarray:
        return self.policy.lam_matrix(reqs, t_now)

    def _slo_rows(self, reqs: list[Request]) -> np.ndarray:
        return self.policy.slo_rows(reqs)

    def _mask_rows(self, reqs: list[Request]) -> np.ndarray:
        return self.policy.mask_rows(reqs)

    def _score_select(self, lam: np.ndarray, slo: np.ndarray,
                      mask: np.ndarray):
        return self.policy.score_select(lam, slo, mask)


def route_window_scalar(batch_router: ControlPlane, reqs: list[Request],
                        t_now: float) -> tuple[np.ndarray, np.ndarray]:
    """Scalar per-request reference for one admission window (see
    :meth:`repro_torch.control.policies.base.RoutingPolicyBase.route_window_scalar`);
    used by the parity tests and as the scalar baseline in
    ``bench_batch_router``."""
    return batch_router.policy.route_window_scalar(reqs, t_now)
