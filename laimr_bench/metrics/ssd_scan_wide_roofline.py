"""``ssd_scan`` (``kernels/ssd_scan.py`` -> ``csrc/ssd.cu``) at a head
wider than the kernel's tiles (Falcon-H1's P 128, N 256, which the
wrapper runs in whole tiles, a launch per slice of N) against its
roofline: the least time of every traced wave's scans over the kernel's
device time in the trace, in %.

A wave's least time is, per Mamba-2 layer, ``counts.ssd_bytes_ops`` at
the wave's batch and prompt with the layer kind's own widths
(``families/<kind>.widths``: its heads, heads x head_dim wide), the
larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s: the whole
call's, whatever its slices re-read. Nothing when the trace holds no
such launch, the kind gives no widths, or the launches are not a whole
number a Mamba-2 layer and traced wave."""
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
    family = run.conf["layer_kind"]
    layers = families.launches(family, k, "ssd_scan")
    kind = families.get(families.kinds(family, k)[0])
    if not waves or not n or not layers or not hasattr(kind, "widths") \
            or n % (layers * len(waves)):
        return None
    heads = kind.widths(k)["heads"]
    bound = 0.0
    for w in waves:
        nbytes, ops = counts.ssd_bytes_ops(w.b, st.prompt_len, heads,
                                           k["ssm_head_dim"],
                                           k["ssm_groups"], k["ssm_state"])
        bound += layers * counts.bound_s(
            nbytes, ops, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / dev_s
