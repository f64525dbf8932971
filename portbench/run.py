"""Run one cell of the benchmark of the PyTorch port once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the check's numbers and limits as
the last lines of standard error and one JSON object as the last line
of standard output. Exits non-zero, printing no result, without a CUDA
card or with fewer than the cell asks for, when a forbidden module (JAX
or the JAX package) was loaded, or when anything fails.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import bench
    from portbench.spec import Spec

    spec = Spec(ROOT)
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"no result: loaded {bad}", file=sys.stderr)
        return 3
    for line in bench.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
