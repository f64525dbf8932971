"""Prompt tokens of the requests completed in the window over the
window's time (host clock)."""


def read(run):
    if run.traffic["kind"] != "prefill" or not run.units:
        return None
    return run.tokens / run.window_s
