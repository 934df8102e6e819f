"""The grouped expert GEMM (``kernels/moe_gemm.py``, CUDA kernel
``moe_gemm_kernel`` of ``csrc/moe.cu``) against its roofline, in %: the
least time of every traced launch over the kernel's device time in the
trace.

An expert layer launches the kernel twice (up (T k, d) x (d, f), down
(T k, f) x (f, d)), once each a prefill and a decode step. The least
time of one layer's pair is the larger of its bytes over 3.35 TB/s, the
touched experts' two weight matrices read once and the rows in and out
(the tokens' activations, the up product written and read in the model
dtype, the down product written in float32), and its FLOPs, 4 rows d f,
over 989 TFLOP/s.

Each launch's rows and experts touched come from the program's
per-launch log (``repro_torch.models.layers.EXPERT_COUNTERS``, kept on
the device and read here after the window). The trace runs from the
middle of the window to its end, and the program launches no expert
layer after the window, so the traced launches are the log's newest:
half the kernel's traced launches, rounded down. Counted launch by
launch, no average. An odd count (a pair the trace's start cuts, or a
record the profiler drops) adds that kernel's time without its bound,
so the share reads low, never high. Nothing without the log (a program
that has none), without a pair of such launches in the trace, or with
more traced pairs than the log holds.
"""
import sys

from laimr_bench import replica
from laimr_bench.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from laimr_bench.metrics import counts


def pair_bound_s(rows: int, touched: int, d: int, f: int, elem: int
                 ) -> float:
    """The least time of one layer's up and down launches."""
    nbytes = touched * 2 * d * f * elem + rows * (d * elem + 2 * f * elem
                                                  + 4 * d)
    return counts.bound_s(nbytes, 4 * rows * d * f, PEAK_BF16_FLOPS,
                          PEAK_HBM_BYTES_PER_S)


def newest_launches(run, n: int):
    """(rows, touched) of the program's ``n`` newest expert launches on
    the run's device, or None."""
    layers = sys.modules.get("repro_torch.models.layers")
    table = getattr(layers, "EXPERT_COUNTERS", None) or {}
    c = table.get(str(run.device))
    if c is None:
        return None
    at, log = int(c.at), c.log.cpu().tolist()
    if n > min(at, len(log)):
        return None
    return [log[i % len(log)] for i in range(at - n, at)]


def read(run):
    tr = run.trace_obj
    if tr is None:
        return None
    n, dev_s = tr.time_of("moe_gemm_kernel")
    if n < 2:
        return None
    launches = newest_launches(run, n // 2)
    if launches is None:
        return None
    k = replica.dims(run.conf)
    elem = 2 if run.conf["dtype"] == "bfloat16" else 4
    bound = sum(pair_bound_s(rows, touched, k["d_model"], k["d_ff"], elem)
                for rows, touched in launches)
    return 100.0 * bound / dev_s
