"""The share of the device's busy time in the traced prefill window spent
under the program's ``moe.dispatch`` and ``moe.combine`` ranges (their
device-side spans, intersected with the busy union), in %."""
from portbench import trace

RANGES = ("moe.dispatch", "moe.combine")


def read(run):
    if run.trace is None:
        return None
    spans = [s for r in RANGES for s in run.trace.ranges.get(r, [])]
    if not spans:
        return None
    busy = trace.busy(run.trace)
    return 100.0 * trace.within(busy, spans) / trace.length(busy)
