"""Model/instance catalogue and cluster state shared by router, autoscaler,
capacity planner and simulator.

A *deployment* is the paper's (m, i) pair: model m served on instance
class i with a replica pool N_mi (k8s Deployment). The catalogue binds
each deployment to a quality lane (§IV-A) and carries the calibrated
latency-law parameters used on the routing hot path.

Two catalogues: :func:`paper_cluster`, the paper's three-tier edge/cloud
deployment, and :func:`h100_catalogue`, the served architectures as
256-GPU H100 replica groups, built from the port's dry-run records
(``repro_torch.launch.dryrun``): of each ``*__decode_32k__single.json``
with ``status`` ok it reads ``arch``, ``flops``, ``hlo_bytes`` and
``collective_bytes_total`` (per device) and takes the step's roofline
bound against ``repro_torch.launch.mesh``'s H100 figures as the model's
L_m.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.latency_model import (CLOUD, EFFICIENTDET, FASTER_RCNN,
                                      PI4_EDGE, YOLOV5M, InstanceClass,
                                      ModelProfile, affine_params,
                                      service_rate)
from repro_torch.core.scheduler import QualityClass


@dataclasses.dataclass
class Deployment:
    """One (model m, instance-class i) replica pool."""

    model: ModelProfile
    instance: InstanceClass
    quality: QualityClass
    n_replicas: int = 1
    n_max: int = 16
    gamma: float = 1.18          # calibrated exponent for this (m, i)
    startup_delay: float = 1.8   # pod start-up time [s] (paper §V-A2)

    # Derived, cached at construction:
    alpha: float = dataclasses.field(init=False)
    beta: float = dataclasses.field(init=False)
    mu: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.alpha, self.beta = affine_params(self.model, self.instance, self.gamma)
        self.mu = service_rate(self.model, self.instance)
        # The key is read on every routed request; model/instance are
        # frozen dataclasses, so cache the join once.
        self._key = f"{self.model.name}@{self.instance.name}"

    @property
    def key(self) -> str:
        return self._key

    def rho(self, lam_m: float) -> float:
        """Traffic intensity of the pool at aggregate arrival rate lam_m."""
        return lam_m / max(self.n_replicas * self.mu, 1e-12)


class Cluster:
    """The set of deployments plus tier topology (edge -> cloud upstream)."""

    def __init__(self, deployments: Iterable[Deployment]):
        self.deployments: dict[str, Deployment] = {}
        for d in deployments:
            if d.key in self.deployments:
                raise ValueError(f"duplicate deployment {d.key}")
            self.deployments[d.key] = d
        # topology is static: memoise the per-request upstream lookup
        self._upstream: dict[str, Optional[Deployment]] = {}

    def __getitem__(self, key: str) -> Deployment:
        return self.deployments[key]

    def __iter__(self):
        return iter(self.deployments.values())

    def __len__(self) -> int:
        return len(self.deployments)

    def for_model(self, model_name: str) -> list[Deployment]:
        return [d for d in self.deployments.values() if d.model.name == model_name]

    def for_quality(self, q: QualityClass) -> list[Deployment]:
        return [d for d in self.deployments.values() if d.quality == q]

    def upstream_of(self, dep: Deployment) -> Optional[Deployment]:
        """The 'nearest fast/cloud tier' for offloading (Alg. 1 line 11).

        Edge deployments offload to the cloud deployment of the same model
        if it exists, else to the cloud deployment of the next-faster model
        (balanced -> low-latency direction per Alg. 1 line 22). Evaluated
        on every request, so the (static) answer is memoised per key.
        """
        try:
            return self._upstream[dep.key]
        except KeyError:
            up = self._upstream_of_uncached(dep)
            self._upstream[dep.key] = up
            return up

    def _upstream_of_uncached(self, dep: Deployment) -> Optional[Deployment]:
        if dep.instance.tier == "edge":
            cloud_same = [d for d in self.for_model(dep.model.name)
                          if d.instance.tier == "cloud"]
            if cloud_same:
                return cloud_same[0]
        # fall back: any faster-quality deployment on a different pool
        faster = [d for d in self.deployments.values()
                  if d.quality < dep.quality and d.key != dep.key]
        if faster:
            return min(faster, key=lambda d: d.model.l_ref / d.instance.speedup)
        return None

    # ---- dense arrays for the vectorised / Pallas scoring hot path ----
    def score_arrays(self) -> dict[str, np.ndarray]:
        deps = list(self.deployments.values())
        return {
            "alpha": np.array([d.alpha for d in deps], np.float32),
            "beta": np.array([d.beta for d in deps], np.float32),
            "gamma": np.array([d.gamma for d in deps], np.float32),
            "mu": np.array([d.mu for d in deps], np.float32),
            "n": np.array([d.n_replicas for d in deps], np.float32),
            "rtt": np.array([d.instance.net_rtt for d in deps], np.float32),
            "cost": np.array([d.instance.cost for d in deps], np.float32),
        }

    def keys(self) -> list[str]:
        return list(self.deployments.keys())


def paper_cluster(n_edge_max: int = 8, n_cloud_max: int = 16,
                  gamma: float = 1.18) -> Cluster:
    """The paper's three-tier deployment (§IV-A): EfficientDet on edge,
    YOLOv5m on edge (+cloud upstream), Faster R-CNN in the cloud."""
    return Cluster([
        Deployment(EFFICIENTDET, PI4_EDGE, QualityClass.LOW_LATENCY,
                   n_replicas=1, n_max=n_edge_max, gamma=gamma),
        Deployment(YOLOV5M, PI4_EDGE, QualityClass.BALANCED,
                   n_replicas=1, n_max=n_edge_max, gamma=gamma),
        Deployment(YOLOV5M, CLOUD, QualityClass.BALANCED,
                   n_replicas=2, n_max=n_cloud_max, gamma=gamma),
        Deployment(FASTER_RCNN, CLOUD, QualityClass.PRECISE,
                   n_replicas=1, n_max=n_cloud_max, gamma=gamma),
    ])



def h100_catalogue(dryrun_dir: str = "results/dryrun_torch",
                   gamma: float = 1.18) -> Cluster:
    """An LA-IMR deployment catalogue of the port's architectures served
    on H100 replica groups, from the dry-run records: where the control
    plane meets the data plane. The twin of the reference's
    ``tpu_catalogue``.

    Each architecture whose decode_32k step ran on the single-pod mesh
    becomes an entry: L_m = its roofline step bound, max(flops /
    PEAK_FLOPS_BF16, hlo_bytes / HBM_BW, collective_bytes_total /
    NET_BW) per device (``repro_torch.launch.mesh``: the per-token
    latency floor of one 256-GPU replica group), and R_m proportional to
    active params. Quality lanes by active params in thirds: small ->
    LOW_LATENCY, mid -> BALANCED, large -> PRECISE. Raises
    ``FileNotFoundError`` when ``dryrun_dir`` holds no such record.
    """
    import glob
    import json
    import os

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16
    from repro_torch.models.model import active_param_count

    entries = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir,
                                              "*__decode_32k__single.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        bound = max(rec["flops"] / PEAK_FLOPS_BF16,
                    rec["hlo_bytes"] / HBM_BW,
                    rec["collective_bytes_total"] / NET_BW)
        n_active = active_param_count(get_config(rec["arch"]))
        entries.append((rec["arch"], bound, n_active))
    if not entries:
        raise FileNotFoundError(f"no decode dry-run artifacts in {dryrun_dir}")

    entries.sort(key=lambda e: e[2])
    n = len(entries)
    deps = []
    for i, (arch, bound, n_active) in enumerate(entries):
        if i < n // 3:
            q = QualityClass.LOW_LATENCY
        elif i < 2 * n // 3:
            q = QualityClass.BALANCED
        else:
            q = QualityClass.PRECISE
        profile = ModelProfile(name=arch, l_ref=max(bound, 1e-4),
                               r_demand=max(n_active / 1e9, 0.1),
                               accuracy=min(0.3 + 0.1 * np.log10(
                                   max(n_active / 1e8, 1.0)), 0.95),
                               kv_growth=arch not in ("mamba2_370m",
                                                      "recurrentgemma_2b"))
        # one 'instance class' = a 256-GPU H100 replica group
        inst = InstanceClass(name="h100-pod-slice", speedup=1.0,
                             r_max=max(n_active / 1e9, 0.1) / max(bound, 1e-4),
                             background=0.0, net_rtt=0.004, cost=256.0)
        deps.append(Deployment(profile, inst, q, n_replicas=1, n_max=8,
                               gamma=gamma, startup_delay=30.0))
    return Cluster(deps)
