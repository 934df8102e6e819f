"""Serving layer of the port: the slot-batched generation engine
(``ServingEngine``, the data plane, on the card with the hand-written
attention kernels), ``BatchRouter``, the admission loop that answers
routing requests through the unified control plane, and ``FleetPlane``
fronting several pods per deployment behind the same policy object."""
from repro_torch.serving.batch_router import (ADMITTED, DUPLICATE, OFFLOADED,
                                              REJECTED, AdmissionConfig,
                                              AdmissionDecision, BatchRouter,
                                              FleetPlane, PodGroup, SlotBank,
                                              route_window_scalar)
from repro_torch.serving.engine import GenerationResult, ServingEngine

__all__ = [
    "ADMITTED", "DUPLICATE", "OFFLOADED", "REJECTED", "AdmissionConfig",
    "AdmissionDecision", "BatchRouter", "FleetPlane", "PodGroup",
    "SlotBank", "route_window_scalar", "GenerationResult", "ServingEngine",
]
