"""The device's idle share of the traced units, in %: 1 - (the union of
every kernel, copy and memset interval over all streams) / the traced
window. The profiler slows the host's issue of each operation, so
where the host paces the card this reads above the untraced window's
idle share."""
from portbench import trace


def read(run):
    if run.trace is None:
        return None
    busy = trace.length(trace.busy(run.trace)) / 1e6
    return 100.0 * (1.0 - busy / run.trace.window_s)
