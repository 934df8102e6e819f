"""Quality-differentiated multi-queue scheduler (paper §IV-A, Fig. 1).

Traffic is partitioned into quality classes Q = {LOW_LATENCY, BALANCED,
PRECISE}, each backed by a run-time queue. Dispatch is strict-priority
(LOW_LATENCY first) with per-lane FIFO, which is what "inherits the
highest dispatch priority" means operationally in the paper.

Each lane is bound to a *service tier* — a set of model variants
(EfficientDet-class / YOLOv5m-class / R-CNN-class in the paper; small /
medium / large architecture configs in the generalised catalogue).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Iterable, Optional


class QualityClass(enum.IntEnum):
    """Lanes in dispatch-priority order (lower value = higher priority)."""

    LOW_LATENCY = 0   # edge-optimised, latency-critical (EfficientDet-Lite0)
    BALANCED = 1      # latency/accuracy trade-off (YOLOv5m)
    PRECISE = 2       # accuracy-prioritised, cloud (Faster R-CNN)


_req_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """An inference request r = (m, i, t) plus bookkeeping (paper §IV-B)."""

    model: str                     # requested model m (catalogue key)
    quality: QualityClass
    arrival: float                 # t: arrival timestamp [s]
    slo: Optional[float] = None    # tau_t; None -> derived as x * L_m
    accuracy_req: float = 0.0      # alpha_t^req
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    # Filled in by the router / simulator:
    assigned_instance: Optional[str] = None
    offloaded: bool = False
    start_service: Optional[float] = None
    completion: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.arrival


class MultiQueueScheduler:
    """Strict-priority multi-queue with per-lane FIFO.

    The scheduler is intentionally simple: the intelligence lives in the
    router (which lane/tier a request lands in) and the autoscaler (how
    much capacity backs each lane). This mirrors the paper's architecture
    where the queues are 'at the code level' for real-time monitoring and
    early latency-spike detection.
    """

    def __init__(self):
        self._lanes: dict[QualityClass, deque[Request]] = {
            q: deque() for q in QualityClass
        }

    def enqueue(self, req: Request) -> None:
        self._lanes[req.quality].append(req)

    def dequeue(self) -> Optional[Request]:
        """Pop the next request: highest-priority non-empty lane, FIFO within."""
        for q in QualityClass:
            lane = self._lanes[q]
            if lane:
                return lane.popleft()
        return None

    def depth(self, quality: Optional[QualityClass] = None) -> int:
        if quality is None:
            return sum(len(v) for v in self._lanes.values())
        return len(self._lanes[quality])

    def depths(self) -> dict[QualityClass, int]:
        return {q: len(v) for q, v in self._lanes.items()}

    def drain(self) -> Iterable[Request]:
        """Remove and yield everything (graceful-termination path)."""
        while (r := self.dequeue()) is not None:
            yield r
