#!/usr/bin/env python3
"""Host synchronisations and times of one LM's serve run on one NVIDIA
card (qwen2-moe-a2.7b unless ``--arch`` names another), for one or more
checkouts of the repository (say, a change and its parent), each in a
fresh process of its own, in the order given (a tree may be named
again, to run the two in turns).

    python3 tools/serve_syncs.py [--arch A] --tree parent=DIR \
        --tree change=DIR [--tree change=DIR --tree parent=DIR]

Each tree's ``src/repro_torch`` serves the model at ``chip_smoke.py``
phase 9's shape (seeded bf16 weights on the card, batch 4 x 2048 prompt
tokens, 32 greedy decode steps through ``examples.serve_lm.serve``; not
whisper, whose frames this script does not draw),
once to warm up, once timed (prefill and decode milliseconds, host
clock around work that ends in a synchronise), then once under
``torch.profiler``: the CUDA runtime's stream, event and device
synchronisations and async copies in that run, and the
``aten::bincount`` and ``aten::_local_scalar_dense`` ops (a host read of
a device value). Printed per tree, with the card's name and power limit.
Exits non-zero without CUDA.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

BATCH, PROMPT, DECODE = 4, 2048, 32
KINDS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize", "cudaMemcpyAsync", "aten::bincount",
         "aten::_local_scalar_dense")


def run(tree: Path, arch: str) -> dict:
    """One tree's profiled serve run (in this process)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.examples.serve_lm import serve
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        raise SystemExit("serve_syncs: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    model = build_model(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, model.cfg.vocab, (BATCH, PROMPT),
                            generator=gen, device=dev)
    serve(model, params, prompts[:, :64], gen_len=4, max_len=128)
    torch.cuda.synchronize()
    out = serve(model, params, prompts, gen_len=DECODE + 1,
                max_len=PROMPT + DECODE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(model, params, prompts, gen_len=DECODE + 1,
              max_len=PROMPT + DECODE)
    counts = {k: 0 for k in KINDS}
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    return {"tree": str(tree), "arch": arch, "counts": counts,
            "prefill_ms": out["prefill_s"] * 1e3,
            "decode_ms": out["decode_s"] * 1e3,
            "card": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--tree", action="append", default=[],
                    help="name=DIR, a checkout of the repository")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run(Path(args.run).resolve(), args.arch)))
        return
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(limit)
    for spec in args.tree:
        name, path = spec.split("=", 1)
        proc = subprocess.run([sys.executable, __file__, "--run", path,
                               "--arch", args.arch],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: {json.dumps(res)}")


if __name__ == "__main__":
    main()
