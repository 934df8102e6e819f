"""The decode steps' share of the chip's bf16 peak: model FLOPs of the
live rows of every step (``counts.decode_flops`` by the configuration's
layer kind; the engine steps all its slots, the idle ones count for
nothing) over all step wall time times 989 TFLOP/s, in %. Waves that
ended before the device trace began."""
from laimr_bench import replica
from laimr_bench.common import PEAK_BF16_FLOPS
from laimr_bench.metrics import counts


def read(run):
    st = run.state
    waves = [w for w in getattr(st, "waves", None) or ()
             if run.untraced(w.end)]
    if not sum(w.steps for w in waves):
        return None
    kind, dims = run.conf["layer_kind"], replica.dims(run.conf)
    flops = sum(counts.decode_flops(kind, dims, w.b, st.prompt_len + k)
                for w in waves for k in range(w.steps))
    return 100.0 * flops / (sum(w.decode_s for w in waves)
                            * PEAK_BF16_FLOPS)
