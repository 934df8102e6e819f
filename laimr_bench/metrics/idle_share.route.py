"""The device's idle share of the traced window: the time in which no
operation ran on the card (the union of the trace's device activity
taken out) over the window's length, in %."""


def read(run):
    tr = run.trace_obj
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
