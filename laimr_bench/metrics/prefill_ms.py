"""Engine prefill (``ServingEngine.generate(prompts, 1)``): wall ms per
wave, all prefill time over the waves, each closed by the first token's
copy to the host. Waves that ended before the device trace began: the
profiler's cost per launch is not in it."""


def read(run):
    waves = [w for w in getattr(run.state, "waves", None) or ()
             if run.untraced(w.end)]
    if not waves:
        return None
    return 1e3 * sum(w.prefill_s for w in waves) / len(waves)
