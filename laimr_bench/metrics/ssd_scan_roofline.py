"""``ssd_scan`` (``kernels/ssd_scan.py`` -> ``csrc/ssd.cu``) against its
roofline: the least time of every launch of the traced waves
(``counts.ssd_bytes_ops`` at the wave's batch and prompt, one launch
per Mamba-2 layer and prefill: ``families.launches``) over the
kernel's device time in the trace, in %. Nothing when the trace holds
no such launch or not one per Mamba-2 layer and traced wave."""
from laimr_bench import families, replica
from laimr_bench.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from laimr_bench.metrics import counts


def read(run):
    st, tr = run.state, run.trace_obj
    if tr is None:
        return None
    waves = [w for w in getattr(st, "waves", None) or ()
             if run.traced(w.start)]
    n, dev_s = tr.time_of("ssd_scan_kernel")
    k = replica.dims(run.conf)
    layers = families.launches(run.conf["layer_kind"], k, "ssd_scan")
    if not waves or not n or not layers or n != layers * len(waves):
        return None
    s = counts.ssm_dims(k)
    bound = 0.0
    for w in waves:
        nbytes, ops = counts.ssd_bytes_ops(w.b, st.prompt_len, s["heads"],
                                           k["ssm_head_dim"],
                                           k["ssm_groups"], k["ssm_state"])
        bound += layers * counts.bound_s(
            nbytes, ops, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / dev_s
