"""Gradient compression: int8 error-feedback quantization, the JAX
package's ``train/compression.py`` in torch.

Per-tensor scale = max|g| / 127; the residual (g - dequant(quant(g))) is
carried to the next step, so the compression is unbiased over time (the
EF-SGD scheme). ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 values and the residual are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map, tree_unflatten


def compress_int8(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (quantized int8, scale, new_residual)."""
    gf = g.to(torch.float32) + residual
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_ef_compressor(init_params) -> Tuple[Callable, Callable, Callable]:
    """Error-feedback compressor over a gradient tree, its residual held by
    closure. Returns (compress_fn, get_residual, set_residual);
    compress_fn quantizes and dequantizes each leaf (what an int8
    collective would carry between them)."""
    state = {"residual": tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), init_params)}

    def compress(grads):
        outs, res = [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(state["residual"])):
            q, s, nr = compress_int8(g, r)
            outs.append(decompress_int8(q, s))
            res.append(nr)
        state["residual"] = tree_unflatten(grads, res)
        return tree_unflatten(grads, outs)

    return compress, lambda: state["residual"], \
        lambda r: state.update(residual=r)
