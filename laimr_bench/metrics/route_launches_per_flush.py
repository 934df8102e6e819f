"""Routing kernels (``kernels/routing_*``): launches of the four
routing kernels' wrappers in the window over the plane's flushes."""


def read(run):
    st = run.state
    flushes = getattr(st, "flushes", 0)
    launches = getattr(st, "launches", None)
    if not flushes or launches is None:
        return None
    return sum(v for k, v in launches.items()
               if k.startswith("routing_")) / flushes
