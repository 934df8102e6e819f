"""The Mamba-2 decode state step (``ssd_step_kernel`` of ``csrc/ssd.cu``,
launched by ``kernels/ssd_step.py``'s ``ssd_state_step`` once per Mamba-2
layer and decode step, inside the replayed graph) against its roofline:
the least time of every traced launch over the kernel's device time in
the trace, in %.

A decode step runs all of the engine's ``slots`` rows, so each launch's
least time is its bytes over 3.35 TB/s: the float32 state (rows x heads x
P x N) read once and written once, x read and y written (float32, rows x
heads x P), B and C by group (float32, rows x G x N) and dt (rows x
heads) read once; its 5 FLOPs a state element are far below the bytes.
The widths are the layer kind's own (``families/<kind>.widths`` where the
kind has it: heads x head_dim, not expand x d_model). Nothing when the
trace holds no such launch, or not one per Mamba-2 layer
(``families.launches`` of ``ssd_scan``) and traced decode step (the
harness's ``decode_step`` spans that began inside the trace)."""
from laimr_bench import families, replica
from laimr_bench.common import PEAK_HBM_BYTES_PER_S
from laimr_bench.metrics import counts


def launch_bytes(rows: int, heads: int, p: int, n: int, g: int) -> int:
    """One launch's bytes, each read or written once."""
    return 8 * rows * heads * p * n + 8 * rows * heads * p \
        + 8 * rows * g * n + 4 * rows * heads


def read(run):
    tr = run.trace_obj
    if tr is None or tr.t_start is None:
        return None
    n, dev_s = tr.time_of("ssd_step_kernel")
    k = replica.dims(run.conf)
    family = run.conf["layer_kind"]
    layers = families.launches(family, k, "ssd_scan")
    steps = sum(1 for name, s, _ in run.spans.items
                if name == "decode_step" and run.traced(s))
    if not n or not layers or not steps or n != layers * steps:
        return None
    kind = families.get(families.kinds(family, k)[0])
    heads = kind.widths(k)["heads"] if hasattr(kind, "widths") \
        else counts.ssm_dims(k)["heads"]
    rows = int(run.cell["engine"]["slots"])
    nbytes = launch_bytes(rows, heads, k["ssm_head_dim"], k["ssm_state"],
                          k["ssm_groups"])
    return 100.0 * n * nbytes / PEAK_HBM_BYTES_PER_S / dev_s
