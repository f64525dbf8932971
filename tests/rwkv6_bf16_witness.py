"""Prefill/decode consistency of rwkv6-7b in bf16 and f32: the JAX package
and the port, side by side on the CPU, from the same weights.

The model is rwkv6-7b at its full width (d_model 4096, 64 heads of 64,
d_ff 14336, vocab 65536) with its depth cut to ``--layers``. The weights
are the reference's ``Model.init`` (bf16, as the config gives them),
carried across to the port by ``from_reference``; the tokens are drawn
with numpy from ``--seed``. For each package and each dtype it runs one
full forward of ``--seq`` tokens, a prefill of ``seq - tail`` and ``tail``
decode steps, and prints the consistency ratio

    max |decode logits - full-forward logits| / (0.02 x max(|logits|, 1))

(the bound of tests/test_models_smoke.py:54; below 1 passes), and the
distance between the two packages' full-forward logits in the same units.

It is not a test (pytest does not collect it): it takes a few GiB and a
few minutes per depth. Run it from the repo root:

    PYTHONPATH=src python tests/rwkv6_bf16_witness.py --layers 2 4 8
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.examples.serve_lm import fill_cache
from repro_torch.models import Model
from repro_torch.models.convert import from_reference
from repro_torch.models.param import tree_map

ARCH = "rwkv6-7b"


def ref_ratio(jm, params, tokens, tail):
    """(full-forward logits as f32 numpy, consistency ratio) of the JAX
    package."""
    fwd = jax.jit(jm.forward, static_argnames=("mode",))
    full, _, _ = fwd(params, {"tokens": tokens}, mode="train")
    full = np.asarray(full.astype(jnp.float32))
    p = tokens.shape[1] - tail
    _, cache, _ = fwd(params, {"tokens": tokens[:, :p]}, mode="prefill")
    err = 0.0
    for t in range(p, tokens.shape[1]):
        dl, cache, _ = fwd(params, {"tokens": tokens[:, t:t + 1]},
                           mode="decode", cache=cache,
                           cache_index=jnp.int32(t))
        err = max(err, float(np.abs(np.asarray(dl[:, 0].astype(jnp.float32))
                                    - full[:, t]).max()))
    return full, err / (0.02 * max(float(np.abs(full).max()), 1.0))


@torch.no_grad()
def port_ratio(pm, params, tokens, tail):
    """The same for the port, on the CPU."""
    tokens = torch.from_numpy(tokens)
    full, _, _ = pm.forward(params, {"tokens": tokens}, mode="train")
    full = full.float()
    p = tokens.shape[1] - tail
    _, pre, _ = pm.forward(params, {"tokens": tokens[:, :p]}, mode="prefill")
    cache = fill_cache(pm.init_cache(tokens.shape[0], tokens.shape[1],
                                     torch.device("cpu")), pre)
    err = 0.0
    for t in range(p, tokens.shape[1]):
        dl, cache, _ = pm.forward(params, {"tokens": tokens[:, t:t + 1]},
                                  mode="decode", cache=cache, cache_index=t)
        err = max(err, float((dl[:, 0].float() - full[:, t]).abs().max()))
    full = full.numpy()
    return full, err / (0.02 * max(float(np.abs(full).max()), 1.0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tail", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtypes", nargs="+", default=["bf16", "f32"],
                    choices=["bf16", "f32"])
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    rows = []
    for n in args.layers:
        jcfg = dataclasses.replace(jax_get_config(ARCH), n_layers=n)
        pcfg = dataclasses.replace(get_config(ARCH), n_layers=n)
        jm, pm = JaxModel(jcfg), Model(pcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(args.seed))
        tokens = rng.integers(0, jcfg.vocab, (args.batch, args.seq),
                              dtype=np.int32)
        for dtype in args.dtypes:
            if dtype == "f32":
                jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
            pp = from_reference(pm.defs, jax.tree.map(np.asarray, jp))
            if dtype == "f32":
                pp = tree_map(lambda t: t.float(), pp)
            j_full, j_ratio = ref_ratio(jm, jp, tokens, args.tail)
            p_full, p_ratio = port_ratio(pm, pp, tokens, args.tail)
            scale = max(float(np.abs(j_full).max()), 1.0)
            row = {"layers": n, "dtype": dtype, "batch": args.batch,
                   "seq": args.seq, "tail": args.tail,
                   "reference_ratio": j_ratio, "port_ratio": p_ratio,
                   "port_vs_reference": float(np.abs(p_full - j_full).max())
                   / (0.02 * scale)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del pp, j_full, p_full
        del jp
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
