"""Wrapper of the ``gla_chunk`` CUDA kernel (``csrc/gla_chunk.cu``): the
chunked gated linear recurrence of RWKV6 (lag-1 read + bonus ``u``) and
Mamba2/SSD (inclusive read), with an initial state in and the final state
out.

For CPU tensors ``gla`` runs the plain version (``ref.gla_chunk_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
``launches["gla_chunk"]`` counts kernel launches."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import check, count_launch, on_cuda, raise_on
from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref

CHUNK = 64            # the kernel's chunk length (the model's)
MAX_DK = 64
MAX_DV = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"gla_chunk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fn():
    from repro_torch.kernels._build import library
    fn = library("gla_chunk").gla_chunk_launch
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 16 + [_P]
    fn.restype = _I
    return fn


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
        inclusive: bool = False, chunk: int = CHUNK,
        initial_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk] or None;
    initial_state: [B, H, dk, dv] f32 or None (zeros). Returns (out [B, S,
    H, dv] in v's dtype, final_state [B, H, dk, dv] f32). Any S. On the
    card: q, k, v f32 or bf16 (one dtype), log_w, u and the state f32,
    dk <= 64, dv <= 128, chunk 64; q, k, v and log_w may have any strides
    (Mamba2's broadcast views are read with zero strides)."""
    if not on_cuda(q, "gla_chunk"):
        return gla_chunk_ref(q, k, v, log_w, u, inclusive=inclusive,
                             chunk=chunk, initial_state=initial_state)
    dev = q.device
    if chunk != CHUNK:
        raise ValueError(f"the gla_chunk kernel runs chunk={CHUNK}, "
                         f"not {chunk}")
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected [B, S, H, d] inputs, got q "
                         f"{tuple(q.shape)}, v {tuple(v.shape)}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if not (1 <= dk <= MAX_DK and 1 <= dv <= MAX_DV):
        raise ValueError(f"dk {dk} / dv {dv} outside the kernel's "
                         f"[1, {MAX_DK}] / [1, {MAX_DV}]")
    if q.dtype not in _DTYPES:
        raise TypeError(f"gla_chunk takes f32 or bf16, not {q.dtype}")
    for t, name, want, shape in ((k, "k", q.dtype, (b, s, h, dk)),
                                 (v, "v", q.dtype, (b, s, h, dv)),
                                 (log_w, "log_w", torch.float32,
                                  (b, s, h, dk))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if u is not None:
        check(u, "u", torch.float32, (h, dk), dev)
    if initial_state is not None:
        check(initial_state, "initial_state", torch.float32, (b, h, dk, dv),
              dev)
    out = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    final = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                None if u is None else u.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                out.data_ptr(), final.data_ptr(), _DTYPES[q.dtype], b, s, h,
                dk, dv, int(inclusive), *q.stride(), *k.stride(),
                *v.stride(), *log_w.stride(),
                torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "gla_chunk")
    count_launch(launches, "gla_chunk")
    return out, final


__all__ = ["gla", "gla_chunk_ref", "launches"]
