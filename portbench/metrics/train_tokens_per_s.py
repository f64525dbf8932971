"""Training tokens completed in the window over the window's time (host
clock; every step ends in a device synchronisation)."""


def read(run):
    if run.traffic["kind"] != "train" or not run.units:
        return None
    return run.tokens / run.window_s
