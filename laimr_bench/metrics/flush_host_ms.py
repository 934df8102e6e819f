"""Admission (``ControlPlane.flush`` under the cell's policy): host ms
per flushed window, the benchmark's clock around every call that
flushed, each closed by the decision's copy to the host. Calls that
ended before the device trace began."""


def read(run):
    n, total = run.spans.total("admission", run.untraced)
    if not n:
        return None
    return 1e3 * total / n
