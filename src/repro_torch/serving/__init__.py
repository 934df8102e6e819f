"""Serving layer of the port: ``BatchRouter``, the admission loop that
answers routing requests through the unified control plane, and
``FleetPlane`` fronting several pods per deployment behind the same
policy object. (The reference's slot-batched generation engine belongs
to the model stack and is not ported yet.)"""
from repro_torch.serving.batch_router import (ADMITTED, DUPLICATE, OFFLOADED,
                                              REJECTED, AdmissionConfig,
                                              AdmissionDecision, BatchRouter,
                                              FleetPlane, PodGroup, SlotBank,
                                              route_window_scalar)

__all__ = [
    "ADMITTED", "DUPLICATE", "OFFLOADED", "REJECTED", "AdmissionConfig",
    "AdmissionDecision", "BatchRouter", "FleetPlane", "PodGroup",
    "SlotBank", "route_window_scalar",
]
