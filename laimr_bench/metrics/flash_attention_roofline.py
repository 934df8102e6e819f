"""``flash_attention`` (``kernels/flash_attention.py`` ->
``csrc/attention.cu``) against its roofline: the least time of every
launch of the traced waves (``counts.flash_bytes_ops`` at the wave's
batch and prompt, one launch per attention layer:
``families.launches``) over the kernel's device time in the trace, in
%. Nothing when the trace holds no such launch or not one per attention
layer and traced wave."""
from laimr_bench import families, replica
from laimr_bench.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from laimr_bench.metrics import counts


def read(run):
    st, tr = run.state, run.trace_obj
    if tr is None:
        return None
    waves = [w for w in getattr(st, "waves", None) or ()
             if run.traced(w.start)]
    n, dev_s = tr.time_of("flash_attention_kernel")
    k = replica.dims(run.conf)
    layers = families.launches(run.conf["layer_kind"], k,
                               "flash_attention")
    if not waves or not n or not layers or n != layers * len(waves):
        return None
    bound = 0.0
    for w in waves:
        nbytes, ops = counts.flash_bytes_ops(w.b, st.prompt_len,
                                             k["n_heads"], k["head_dim"],
                                             hkv=k["n_kv_heads"])
        bound += layers * counts.bound_s(
            nbytes, ops, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / dev_s
