"""Wrapper of the ``flash_attention`` CUDA kernels: GQA attention with a
streaming softmax, in two hand-written designs.

* ``csrc/flash_attention_tc.cu`` — bf16 on the tensor cores (``wgmma``
  fed by TMA), for bf16 inputs at head_dim 64 or 128 whose pointers and
  strides TMA can address (16-byte aligned, strides multiples of 8
  elements): the models' prefill;
* ``csrc/flash_attention.cu`` — f32 math on the CUDA cores, for f32
  inputs and for every bf16 call the first one does not take (head_dim 16
  or 32, unaligned views).

For CPU tensors ``mha`` runs the plain version (``ref.attention_ref``,
its output laid out as the kernel's); for CUDA tensors it launches one of
the kernels on the current stream or raises; for ``meta`` tensors (the
dry run, ``launch/dryrun.py``) it makes the kernel's checks, allocates
its output and launches nothing. ``launches["flash_attention"]`` counts
every kernel launch, ``launches["flash_attention_tc"]`` those of the
tensor-core design. ``work`` is a call's operations and bytes from its
shapes (``PERF.md``'s bound column and the dry run's count of a call);
under a step's work counter (``_build.COUNTER``) every call records it.

Gradients: ``attention`` (``FlashAttentionFn``) runs ``mha`` forward and,
backward, recomputes the plain version under autograd and returns its
input gradients — the JAX package has no backward kernel and trains
through its plain jnp attention, so the gradient is the plain
formulation's at the same point. ``mha`` itself writes through raw
pointers and has no graph: it raises when grad mode is on and an input
requires grad, so no caller can drop a gradient silently."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (count_launch, like, no_graph_inputs,
                                       on_cuda, raise_on, recompute_grads)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)
DESIGNS = ("auto", "tc", "simt")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attention": 0, "flash_attention_tc": 0}

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


@functools.lru_cache(maxsize=None)
def _tc_fn():
    from repro_torch.kernels._build import library
    fn = library("flash_attention").flash_attention_tc_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I] + [_L] * 12 + [_P]
    fn.restype = _I
    return fn


def _bhs(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _tma_bhs(t: torch.Tensor):
    """The (b, h, s) strides a tensor map is built from: an axis of length
    one is never stepped along, so it gets a stride TMA accepts."""
    return tuple(st if n > 1 else t.shape[3]
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def takes_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the tensor-core design takes these (already checked)
    inputs: bf16, head_dim 64 or 128, each tensor 16-byte aligned with
    strides TMA can step (multiples of 8 elements)."""
    return (q.dtype == torch.bfloat16 and q.shape[3] in TC_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0
                    and all(st % 8 == 0 for st in _tma_bhs(t))
                    for t in (q, k, v)))


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool = True) -> Tuple[int, int]:
    """(operations, bytes) of one call, from its shapes: 4·B·Hq·Sq·Skv·D
    (the QKᵀ and PV products), half of that causal at Sq = Skv (the
    kernel skips the masked tiles); q, k and v read once and the output
    written once."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    flops = (2 if causal and sq == skv else 4) * b * hq * sq * skv * d
    return flops, q.element_size() * (2 * q.numel() + k.numel() + v.numel())


def backward_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[int, int]:
    """(operations, bytes) of ``FlashAttentionFn``'s backward, which
    recomputes the plain version and its gradient: the full (unmasked)
    products once forward (4·B·Hq·Sq·Skv·D) and twice that backward;
    q, k, v and the output's gradient read once, the three input
    gradients written once."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    return (12 * b * hq * sq * skv * d,
            q.element_size() * (3 * q.numel() + 2 * k.numel()
                                + 2 * v.numel()))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        design: str = "auto") -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    dtype. Any Sq, Skv >= 1 (no tile padding); the B, H and S axes may
    have any strides, so the model passes transposed views of its
    [B, S, H, D] activations and gets the output in that layout back
    (``torch.empty_like(q)`` keeps q's strides). On the card: f32 or bf16,
    D in {16, 32, 64, 128}, D contiguous, Hq a multiple of Hkv; bf16 goes
    to the tensor-core design where ``takes_tc``, else to the f32 one.
    ``design`` ("auto", "tc" or "simt") pins one design on the card, to
    time the two side by side; "tc" raises where ``takes_tc`` is false."""
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} not in {DESIGNS}")
    no_graph_inputs("flash_attention", "attention", q, k, v)
    if _build.COUNTER is not None:
        return _build.counted_call(
            "flash_attention", lambda: _mha(q, k, v, causal, scale, design),
            lambda out: work(q, k, v, causal))
    return _mha(q, k, v, causal, scale, design)


def _mha(q, k, v, causal, scale, design) -> torch.Tensor:
    if q.device.type != "meta" and not on_cuda(q, "flash_attention"):
        return like(q, attention_ref(q, k, v, causal=causal, scale=scale))
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
    if dev.type == "meta":
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = takes_tc(q, k, v)
    if design == "tc" and not tc:
        raise ValueError("the tensor-core design takes bf16 at head_dim 64 "
                         "or 128 with TMA-aligned pointers and strides")
    if tc and design != "simt":
        err = _tc_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, hq, hkv, sq, skv, d, scale,
                       int(causal), *_tma_bhs(q), *_tma_bhs(k), *_tma_bhs(v),
                       *_bhs(out), stream)
        raise_on(err, "flash_attention_tc")
        count_launch(launches, "flash_attention", "flash_attention_tc")
    else:
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _DTYPES[q.dtype], b, hq, hkv, sq, skv, d, scale,
                    int(causal), *_bhs(q), *_bhs(k), *_bhs(v), *_bhs(out),
                    stream)
        raise_on(err, "flash_attention")
        count_launch(launches, "flash_attention")
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``mha`` with a gradient: the kernel forward (the plain version for
    CPU tensors), the plain version's gradient backward (recomputed from
    the saved inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return mha(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors

        def plain(q, k, v):
            return attention_ref(q, k, v, causal=ctx.causal,
                                 scale=ctx.scale)

        def run():
            if grad_out.device.type == "meta":
                grads = [torch.empty_like(t) if n else None
                         for t, n in zip(saved, ctx.needs_input_grad)]
            else:
                grads = recompute_grads(plain, saved, ctx.needs_input_grad,
                                        (grad_out,))
            return [like(t, g) for t, g in zip(saved, grads)]

        if _build.COUNTER is not None:
            # the recompute's activations and temporaries, live during the
            # call on every device (on meta nothing runs)
            key = ("flash", ctx.causal, ctx.scale, ctx.needs_input_grad,
                   *((t.shape, t.dtype) for t in saved))
            grads = _build.counted_call(
                "flash_attention_backward", run,
                lambda grads: backward_work(*saved),
                _build.recompute_scratch(key, plain, saved,
                                         ctx.needs_input_grad, (grad_out,)))
        else:
            grads = run()
        return (*grads, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None
              ) -> torch.Tensor:
    """``mha`` (the default design) through ``FlashAttentionFn``: what the
    model calls in every mode."""
    return FlashAttentionFn.apply(q, k, v, causal, scale)


__all__ = ["FlashAttentionFn", "attention", "attention_ref",
           "backward_work", "launches", "mha", "takes_tc", "work"]
