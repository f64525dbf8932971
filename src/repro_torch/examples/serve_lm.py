"""Batched LM serving: prefill a request batch, then greedy decode against
a cache preallocated to ``max_len`` — the counterpart of the JAX
package's ``examples/serve_lm.py``, for every registered arch, on the
card by default (the prefill runs the flash_attention and gla_chunk
kernels, whisper's decode its cross-attention's flash_attention; the first
launch builds them with nvcc). ``--device cpu`` runs every kernel's plain
version:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch whisper-small --smoke --device cpu

whisper-small (encdec) prefills its encoder from ``frames``: the conv
front end is a stub in the reference too, so they are seeded normal
[B, enc_seq, d_model] in the weights' dtype.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import list_archs
from repro_torch.core.backend import resolve_device
from repro_torch.models import Model, build_model
from repro_torch.models.param import tree_map
from repro_torch.train.serve_step import make_decode_step, make_prefill_step


def fill_cache(cache, prefill_cache) -> Any:
    """Copy a prefill cache into the leading corner of each leaf of a
    preallocated cache (the K/V of the prompt's positions; the recurrent,
    conv and token-shift states and whisper's encoder K/V whole). A leaf
    whose dtype differs from the prefill's is made anew, zeroed, in the
    prefill's dtype — as the reference's
    example keeps the prefill's leaves and only pads K/V — so an f32
    model's states are not rounded to the cache's bf16. Returns the
    filled cache."""
    def put(dst, src):
        if dst.dtype != src.dtype:
            dst = torch.zeros(dst.shape, dtype=src.dtype, device=dst.device)
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        return dst
    return tree_map(put, cache, prefill_cache)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve(model: Model, params, prompts: torch.Tensor, *, gen_len: int,
          max_len: int, frames: Optional[torch.Tensor] = None
          ) -> Dict[str, Any]:
    """Prefill ``prompts`` [B, P] (an encdec model: with ``frames`` [B,
    enc_seq, d_model], its encoder's input), then decode greedily to
    ``gen_len`` new tokens per sequence against a cache of ``max_len``
    positions. Returns the tokens [B, gen_len], the decode steps' logits
    [B, gen_len - 1, V] and the prefill and decode wall seconds. Records
    no autograd graph."""
    b, p = prompts.shape
    if p + gen_len - 1 > max_len:
        raise ValueError(f"prompt {p} + {gen_len - 1} decode steps exceed "
                         f"max_len {max_len}")
    batch = {"tokens": prompts}
    if model.cfg.family == "encdec":
        if frames is None:
            raise ValueError("an encdec model needs frames")
        batch["frames"] = frames
    device = prompts.device
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    cache = model.init_cache(b, max_len, device)
    _sync(device)
    t0 = time.perf_counter()
    tok, pre_cache = prefill(params, batch)
    cache = fill_cache(cache, pre_cache)
    del pre_cache
    _sync(device)
    prefill_s = time.perf_counter() - t0

    toks, logits = [tok], []
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        tok, lg, cache = decode(params, cache, toks[-1][:, None], p + i)
        toks.append(tok)
        logits.append(lg)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(toks, dim=1),
            "logits": (torch.stack(logits, dim=1) if logits else
                       torch.empty((b, 0, model.cfg.vocab), device=device)),
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.arch, smoke=args.smoke)
    cfg = model.cfg
    gen = torch.Generator(device=device)
    params = model.init(gen.manual_seed(0))

    batch, prompt_len, gen_len, max_len = 4, 48, 16, 64
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen.manual_seed(1), device=device)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                             generator=gen.manual_seed(2), device=device
                             ).to(params["embed"].dtype)
    out = serve(model, params, prompts, gen_len=gen_len, max_len=max_len,
                frames=frames)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"{cfg.arch} on {where}: prefill {batch} x {prompt_len} tokens in "
          f"{out['prefill_s'] * 1e3:.0f} ms")
    print(f"decode: {gen_len - 1} steps x {batch} seqs in "
          f"{out['decode_s'] * 1e3:.0f} ms "
          f"({batch * (gen_len - 1) / out['decode_s']:.0f} tok/s)")
    print("generated token ids (seq 0):", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main()
