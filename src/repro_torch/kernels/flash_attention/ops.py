"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``): GQA attention with a streaming softmax.

For CPU tensors ``mha`` runs the plain version (``ref.attention_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
``launches["flash_attention"]`` counts kernel launches."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._build import count_launch, on_cuda, raise_on
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fn():
    from repro_torch.kernels._build import library
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I] + [_L] * 12 + [_P]
    fn.restype = _I
    return fn


def _bhs(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    dtype. Any Sq, Skv >= 1 (no tile padding); the B, H and S axes may
    have any strides, so the model passes transposed views of its
    [B, S, H, D] activations and gets the output in that layout back
    (``torch.empty_like(q)`` keeps q's strides). On the card: f32 or bf16,
    D in {16, 32, 64, 128}, D contiguous, Hq a multiple of Hkv."""
    if not on_cuda(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, scale=scale)
    dev = q.device
    for t, name in ((k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes f32 or bf16, not {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B, Hq, Sq, D], k = v [B, Hkv, Skv, "
                         f"D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (Hq must be a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if sq < 1 or skv < 1:
        raise ValueError("empty sequence")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("head_dim must be the contiguous axis")
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, hq, hkv, sq, skv, d, scale, int(causal),
                *_bhs(q), *_bhs(k), *_bhs(v), *_bhs(out),
                torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "flash_attention")
    count_launch(launches, "flash_attention")
    return out


__all__ = ["attention_ref", "launches", "mha"]
