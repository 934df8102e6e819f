"""LA-IMR routing over the H100 model fleet, on the PyTorch port: the
control plane meets the data plane. The catalogue is built from the
port's dry-run records (the per-token roofline bound of each
architecture's decode step on a 256-GPU H100 replica group), and
Algorithm 1 + PM-HPA manage replica groups of those models. The twin of
``examples/route_tpu_fleet.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch all --shape decode_32k --mesh single
  PYTHONPATH=src python examples/route_h100_fleet.py [--device cpu]

Routing decisions run on the card (``backend="cuda"``, the hand-written
decision kernels) unless ``--device cpu`` is given (their plain
versions).
"""
import argparse

import numpy as np

from repro_torch.core import (ClusterSimulator, Request, RouterParams,
                              SimConfig, bounded_pareto_bursts)
from repro_torch.core.catalogue import h100_catalogue
from repro_torch.core.scheduler import QualityClass
from repro_torch.serving import AdmissionConfig, BatchRouter

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--dryrun-dir", default="results/dryrun_torch")
args = ap.parse_args()
backend = "cuda" if args.device.startswith("cuda") else "ref"

cluster = h100_catalogue(args.dryrun_dir)
print(f"fleet: {len(cluster)} architecture tiers from dry-run artifacts")
for d in cluster:
    print(f"  {d.key:42s} lane={d.quality.name:11s} "
          f"L_m={d.model.l_ref*1e3:8.1f} ms  mu={d.mu:9.2f} req/s")

# §IV-B full selection, batched: all 12 requests accumulate into one
# admission window and are scored against the whole fleet table in one
# decision launch.
brouter = BatchRouter(cluster, params=RouterParams(x=3.0),
                      config=AdmissionConfig(max_batch=12, backend=backend,
                                             device=args.device))
rng = np.random.default_rng(0)
reqs = []
t = 0.0
for q in QualityClass:
    for k in range(4):
        t += float(rng.exponential(0.05))
        reqs.append(Request(model="any", quality=q, arrival=t, slo=2.0))
decisions = []
for req in reqs:
    decisions.extend(brouter.submit(req, req.arrival) or [])
decisions.extend(brouter.flush(t))
print(f"\nrouting {len(reqs)} requests (4 per lane), batched windows:")
for d in decisions:
    print(f"  {d.req.quality.name:11s} -> {str(d.target_key):42s} "
          f"[{d.outcome}] (predicted {d.predicted_latency*1e3:6.1f} ms)")

# end-to-end: bursty traffic against the BALANCED lane with PM-HPA
# scaling replica groups (startup 30 s), decided in 0.1 s windows
arr = bounded_pareto_bursts(8.0, 180.0, "stablelm_3b", seed=1)
sim = ClusterSimulator(cluster, SimConfig(
    mode="laimr", seed=1, slo=2.0, admission_window=0.1,
    admission_backend=backend, admission_device=args.device))
res = sim.run(arr)
s = res.summary()
print(f"\nburst sim on {len(arr)} requests: p50={s['p50']*1e3:.0f} ms "
      f"p99={s['p99']*1e3:.0f} ms offloaded={res.offload_fast} "
      f"scale_events={len(res.scale_events)}")
