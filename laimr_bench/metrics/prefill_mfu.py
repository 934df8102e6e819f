"""The prefills' share of the chip's bf16 peak: model FLOPs of every
wave's prefill (``counts.prefill_flops`` by the configuration's layer
kind) over all their prefill wall time times 989 TFLOP/s, in %. Waves
that ended before the device trace began."""
from laimr_bench import replica
from laimr_bench.common import PEAK_BF16_FLOPS
from laimr_bench.metrics import counts


def read(run):
    st = run.state
    waves = [w for w in getattr(st, "waves", None) or ()
             if run.untraced(w.end)]
    if not waves:
        return None
    kind, dims = run.conf["layer_kind"], replica.dims(run.conf)
    flops = sum(counts.prefill_flops(kind, dims, w.b, st.prompt_len)
                for w in waves)
    return 100.0 * flops / (sum(w.prefill_s for w in waves)
                            * PEAK_BF16_FLOPS)
