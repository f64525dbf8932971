"""The readings of a cell's control and planted faults, at the cell's own
size, on the card: what each limit under ``limits/`` was set above.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

For each seed it prints one JSON line: the cell, the seed, and per
reading (``control_fp8``: the reference computed in float8 in the
program's place; for training also ``fault_half_batch``) each compared
number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import bench, port
    from portbench.spec import Spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    ref = spec.reference(conf)
    model = port.model(conf, traffic)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = bench.Context(conf, traffic, seed, dev, model,
                            port.layout(model), None, ref, ref.Dims.of(conf))
        readings = spec.loop(traffic["kind"]).control(ctx)
        torch.cuda.empty_cache()
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
