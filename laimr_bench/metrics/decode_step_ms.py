"""Engine decode (``ServingEngine.step``): wall ms per step, all step
time over the steps, each closed by its tokens' copy to the host. Waves
that ended before the device trace began: the profiler's cost per
launch is not in it."""


def read(run):
    waves = [w for w in getattr(run.state, "waves", None) or ()
             if run.untraced(w.end)]
    steps = sum(w.steps for w in waves)
    if not steps:
        return None
    return 1e3 * sum(w.decode_s for w in waves) / steps
