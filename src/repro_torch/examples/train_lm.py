"""Near-real-time training: a ~30M-parameter LM trained on token batches
produced BY the DOD-ETL pipeline — the JAX package's
``examples/train_lm.py`` on the port. On the card (the default) the
pipeline's transforms run the ``transform_kpi`` kernel and the model's
forward the ``flash_attention`` kernel; ``--device cpu`` runs every
kernel's plain version.

Checkpoints (``CheckpointManager.save_async``) carry the data plane with
the model: the listener offsets (in ``extra``) and the fact corpus drawn
so far. ``--resume`` restores the model, the optimizer and the corpus
from the newest valid step and puts the change tracker back at the saved
offsets, so the restarted stream extracts no record twice.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dod_etl import steelworks_config
from repro_torch.core import DODETLPipeline, SourceDatabase
from repro_torch.core.backend import resolve_device
from repro_torch.data.sampler import SamplerConfig, SteelworksSampler
from repro_torch.models.model import Model
from repro_torch.models.param import count_params
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step

BATCH, SEQ = 4, 128
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "etl_lm_ckpt"


def lm_small() -> ModelConfig:
    return ModelConfig(
        arch="etl-lm-small", family="dense", n_layers=6, d_model=384,
        n_heads=6, n_kv_heads=2, d_ff=1536, vocab=4096, microbatches=1,
        remat=False)


def fact_tokenizer(facts: np.ndarray, vocab: int, seq: int, batch: int):
    """Quantize star-schema fact grains into token sequences: each fact
    contributes (equipment, bucketized KPIs) tokens — the stream IS the
    corpus."""
    if len(facts) == 0:
        return None
    cols = facts[:, [0, 3, 4, 5, 6]]
    toks = (np.clip(cols, 0, 1) * 62).astype(np.int64) + \
        np.array([0, 64, 128, 192, 256]) + 1
    flat = toks.reshape(-1) % (vocab - 1) + 1
    need = batch * seq
    reps = int(np.ceil(need / len(flat)))
    flat = np.tile(flat, reps)[:need]
    return flat.reshape(batch, seq)


def listener_offsets(pipe: DODETLPipeline) -> Dict[str, int]:
    return {l.table.name: int(l.offset) for l in pipe.tracker.listeners}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Returns the losses, the step range, the final parameters and
    optimizer state, the listener offsets, the records extracted and the
    step resumed from."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- the model plane
    mcfg = lm_small()
    model = Model(mcfg)
    print(f"model: {count_params(model.defs) / 1e6:.1f}M params on "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'CPU'}")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt = init_state(params)
    step_fn = make_train_step(model, AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    mgr = CheckpointManager(args.ckpt, keep_last=2)
    start, stream = 0, None
    fact_backlog = np.zeros((0, 10), np.float32)
    if args.resume:
        got = mgr.restore_latest({"params": params, "opt": opt,
                                  "corpus": None})
        if got is None:
            raise FileNotFoundError(f"no valid checkpoint in {args.ckpt}")
        start, tree, extra = got
        params, opt, stream = tree["params"], tree["opt"], extra["stream"]
        fact_backlog = tree["corpus"].numpy()
        print(f"resumed from step {start}: {len(fact_backlog)} facts, "
              f"listeners at {stream}")

    # ---- the data plane: DOD-ETL over the plant stream
    cfg = steelworks_config(n_partitions=8)
    src = SourceDatabase()
    SteelworksSampler(cfg, SamplerConfig(records_per_table=20_000,
                                         n_equipment=8)).generate(src)
    pipe = DODETLPipeline(cfg, src, n_workers=2, device=device)
    if stream is not None:
        for l in pipe.tracker.listeners:
            l.offset = stream[l.table.name]
    extracted = pipe.extract()
    pipe.bootstrap_caches()
    print(f"extracted {extracted} change records")

    t0 = time.time()
    losses = []
    for step in range(start + 1, start + args.steps + 1):
        # pull freshly transformed facts; the warehouse is the corpus
        if len(fact_backlog) < BATCH * SEQ // 4:
            pipe.step(max_records_per_partition=512)
            fact_backlog = pipe.warehouse.fact_table()
        tokens = fact_tokenizer(fact_backlog, mcfg.vocab, SEQ, BATCH)
        if tokens is None:
            raise RuntimeError("the stream produced no facts")
        tokens = torch.from_numpy(tokens).to(device)
        batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if step % 25 == 0 or step == start + 1:
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (step - start):.2f}s/step)")
        if step % args.ckpt_every == 0:
            mgr.save_async(step, {"params": params, "opt": opt,
                                  "corpus": torch.from_numpy(fact_backlog)},
                           extra={"stream": listener_offsets(pipe)})
    mgr.wait()
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"checkpoints (with stream offsets) in {args.ckpt}")
    return {"losses": losses, "first_step": start + 1,
            "last_step": start + args.steps, "params": params, "opt": opt,
            "stream": listener_offsets(pipe), "extracted": extracted,
            "resumed_from": start if args.resume else None}


if __name__ == "__main__":
    main()
