"""The attention kernel's share of its roofline, in %: the summed bound
(``work.flash_call`` and ``work.bound_s``: the larger of its causal FLOPs
over the bfloat16 peak and its bytes over the memory bandwidth) of the
calls of the tensor-core kernel ``flash_tc_kernel`` in the traced window,
over their summed device time. Every call of a cell has the same shape:
[rows, heads, S, head_dim], rows the microbatch's (training) or the
request's (prefill)."""
from portbench import trace, work

KERNEL = "flash_tc_kernel"


def read(run):
    if run.trace is None or run.peak is None:
        return None
    calls = [(a, b) for name, a, b in run.trace.ops if KERNEL in name]
    if not calls:
        return None
    t = run.traffic
    if t["kind"] == "train":
        rows, seq = t["batch"] // t["microbatches"], t["seq_len"]
    else:
        rows, seq = t["batch"], t["prompt_len"]
    bound = work.bound_s(*work.flash_call(run.conf, rows, seq), run.peak)
    spent = sum(b - a for a, b in calls) / 1e6
    return 100.0 * bound * len(calls) / spent
