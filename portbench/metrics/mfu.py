"""The whole step's share of the card's bfloat16 dense peak, in %: the
model FLOPs (``portbench/work.py``, from the published sizes) of the
units completed in the run's measured window, over that window's time
on the host clock. In a traced run this is the untraced window that
runs before the traced units, so profiling does not slow what it
reads."""
from portbench import work


def read(run):
    if run.peak is None or not run.units:
        return None
    t = run.traffic
    if t["kind"] == "train":
        flops = work.train_flops(run.conf, t["batch"], t["seq_len"])
    else:
        flops = work.forward_flops(run.conf, t["batch"], t["prompt_len"])
    return 100.0 * flops * run.units / run.window_s / run.peak["bf16_flops"]
