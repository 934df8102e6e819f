"""LA-IMR core on PyTorch: the paper's contribution as a composable
library.

Public surface:

* latency model   — ``ModelProfile``, ``InstanceClass``, ``g_fixed_replicas``,
                    ``g_fixed_traffic``, ``calibrate``
* queueing        — ``erlang_c``, ``mmc_wait`` (torch) and numpy twins
* routing         — ``Router``, ``RouterParams``, ``score_instances``
* scheduling      — ``MultiQueueScheduler``, ``QualityClass``, ``Request``
* autoscaling     — ``PMHPA``, ``ReactiveAutoscaler``, ``desired_replicas``
* simulation      — ``ClusterSimulator``, ``SimConfig``
* workload        — ``poisson_arrivals``, ``bounded_pareto_bursts``, ...
"""
from repro_torch.core.autoscaler import (PMHPA, ReactiveAutoscaler,
                                         desired_replicas)
from repro_torch.core.catalogue import Cluster, Deployment, paper_cluster
from repro_torch.core.latency_model import (CLOUD, EFFICIENTDET, FASTER_RCNN,
                                            PI4_EDGE, YOLOV5M,
                                            CalibratedModel, InstanceClass,
                                            ModelProfile, affine_power_law,
                                            calibrate,
                                            calibrate_from_table_iv,
                                            g_fixed_replicas,
                                            g_fixed_traffic)
from repro_torch.core.queueing import (ErlangMemo, erlang_c, mmc_wait,
                                       mmc_wait_np, mmc_wait_scalar)
from repro_torch.core.router import (Action, Decision, Router, RouterParams,
                                     score_instance_scalar, score_instances,
                                     score_instances_batch, select_instance,
                                     select_instance_batch,
                                     select_instance_scalar)
from repro_torch.core.scheduler import (MultiQueueScheduler, QualityClass,
                                        Request)
from repro_torch.core.simulator import ClusterSimulator, SimConfig, SimResult
from repro_torch.core.telemetry import Ewma, MetricsRegistry, SlidingRate
from repro_torch.core.workload import (Arrival, bounded_pareto_bursts,
                                       diurnal_arrivals, flash_crowd_arrivals,
                                       mixed_traffic, mmpp_arrivals,
                                       poisson_arrivals, ramp_arrivals,
                                       robot_trace)

__all__ = [
    "PMHPA", "ReactiveAutoscaler", "desired_replicas", "Cluster",
    "Deployment", "paper_cluster", "CLOUD", "EFFICIENTDET", "FASTER_RCNN",
    "PI4_EDGE", "YOLOV5M", "CalibratedModel", "InstanceClass",
    "ModelProfile", "affine_power_law", "calibrate",
    "calibrate_from_table_iv", "g_fixed_replicas", "g_fixed_traffic",
    "ErlangMemo", "erlang_c", "mmc_wait", "mmc_wait_np", "mmc_wait_scalar",
    "Action", "Decision", "Router", "RouterParams", "score_instance_scalar",
    "score_instances", "score_instances_batch", "select_instance",
    "select_instance_batch", "select_instance_scalar",
    "MultiQueueScheduler", "QualityClass", "Request", "ClusterSimulator",
    "SimConfig", "SimResult", "Ewma", "MetricsRegistry", "SlidingRate",
    "Arrival", "bounded_pareto_bursts", "diurnal_arrivals",
    "flash_crowd_arrivals", "mixed_traffic", "mmpp_arrivals",
    "poisson_arrivals", "ramp_arrivals", "robot_trace",
]
