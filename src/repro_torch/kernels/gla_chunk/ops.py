"""Wrapper of the ``gla_chunk`` CUDA kernels: the chunked gated linear
recurrence of RWKV6 (lag-1 read + bonus ``u``) and Mamba2/SSD (inclusive
read), with an initial state in and the final state out, in three
hand-written designs.

* ``csrc/gla_ssd.cu`` — the chunk-parallel SSD form on the tensor cores
  (chunk states, state passing, chunk scan: three launches) for the
  regime zamba2 runs: bf16 q, k, v, inclusive, no bonus, q and k shared
  by every head and one decay per (token, head) (``takes_ssd``);
* ``csrc/gla_rwkv6.cu`` — the same three-launch skeleton for the regime
  rwkv6 runs: bf16 q, k, v, the lag-1 read, a bonus or none, per-head q
  and k, one decay per (token, head, channel), the intra-chunk scores on
  the tensor cores through per-sub-chunk anchors (``takes_rwkv6``);
* ``csrc/gla_chunk.cu`` — one CTA per (batch, head) walking the chunks,
  f32 on the CUDA cores, for every other call (f32 inputs, the inclusive
  read with per-head q and k).

For CPU tensors ``gla`` runs the plain version (``ref.gla_chunk_ref``,
its outputs laid out as the kernels'); for CUDA tensors it launches one
of the designs on the current stream or raises; for ``meta`` tensors (the
dry run, ``launch/dryrun.py``) it makes the kernels' checks, allocates
their outputs and the chunk-parallel designs' scratch and launches
nothing. ``work`` is a call's operations and bytes from its shapes
(``PERF.md``'s bound column and the dry run's count of a call); under a
step's work counter (``_build.COUNTER``) every call records it, with the
scratch its design allocates. ``launches["gla_chunk"]`` counts calls
that launched a kernel (one per call, whatever the design's number of
kernels);
``launches["gla_chunk_ssd"]`` and ``launches["gla_chunk_rwkv6"]`` those
that took the SSD and the RWKV6 design.

Gradients: ``gla_fn`` (``GlaChunkFn``) runs ``gla`` forward and, backward,
recomputes a plain version under autograd and returns its input gradients
— ``ref.gla_ssd_ref`` for the inputs the SSD design takes (its
vectorized chunk-parallel form), ``ref.gla_chunk_ref`` for the rest. The
JAX package has no backward kernel and trains through its plain jnp
recurrence, so the gradient is the plain formulation's at the same point.
``gla`` itself writes through raw pointers and has no graph: it raises
when grad mode is on and an input requires grad."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (check, count_launch, like,
                                       no_graph_inputs, on_cuda, raise_on,
                                       recompute_grads, stored_bytes)
from repro_torch.kernels.gla_chunk.ref import gla_chunk_ref, gla_ssd_ref

CHUNK = 64            # the kernel's chunk length (the model's)
MAX_DK = 64
MAX_DV = 128
SSD_DK = (16, 32, 64)
SSD_DV = (16, 32, 64, 128)
DESIGNS = ("auto", "ssd", "rwkv6", "serial")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"gla_chunk": 0, "gla_chunk_ssd": 0, "gla_chunk_rwkv6": 0}

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


@functools.lru_cache(maxsize=None)
def _ssd_fn():
    from repro_torch.kernels._build import library
    fn = library("gla_chunk").gla_ssd_launch
    fn.argtypes = [_P] * 9 + [_I] * 5 + [_L] * 16 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _rwkv6_fn():
    from repro_torch.kernels._build import library
    fn = library("gla_chunk").gla_rwkv6_launch
    fn.argtypes = [_P] * 10 + [_I] * 5 + [_L] * 16 + [_P]
    fn.restype = _I
    return fn


def _shared(t: torch.Tensor, axis: int) -> bool:
    """Whether ``t`` holds one value along ``axis`` (a zero-stride
    broadcast view, or a single entry)."""
    return t.shape[axis] == 1 or t.stride(axis) == 0


def takes_ssd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: Optional[torch.Tensor],
              inclusive: bool) -> bool:
    """Whether the SSD design takes these (already checked) inputs: the
    Mamba2 regime — bf16, inclusive, no bonus, q and k shared by every
    head, log_w one value per (token, head) — at dk in ``SSD_DK`` and dv
    in ``SSD_DV``."""
    return (q.dtype == torch.bfloat16 and inclusive and u is None
            and q.shape[3] in SSD_DK and v.shape[3] in SSD_DV
            and _shared(q, 2) and _shared(k, 2) and _shared(log_w, 3))


def takes_rwkv6(q: torch.Tensor, v: torch.Tensor, inclusive: bool) -> bool:
    """Whether the RWKV6 design takes these (already checked) inputs: the
    RWKV6 regime — bf16, the lag-1 read, a bonus ``u`` or none, q, k and
    log_w per head and channel (read through their strides, so a shared
    view is read as well) — at dk in ``SSD_DK`` and dv in ``SSD_DV``."""
    return (q.dtype == torch.bfloat16 and not inclusive
            and q.shape[3] in SSD_DK and v.shape[3] in SSD_DV)


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
         inclusive: bool = False, chunk: int = CHUNK,
         initial_state: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(operations, bytes) of one call, from its shapes. Operations per
    chunk and head: the intra scores (5 per unmasked (t, i, d) triple:
    sub, exp, 2 mul, add), the intra, inter and state products (2 per
    multiply-add each), the decays (6 per (t, d)) and the state's decay
    (3 per element). Bytes: the inputs as stored (broadcast axes once)
    read once, the output and the f32 final state written once."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    n = -(-s // chunk)
    pairs = chunk * (chunk + 1) // 2 if inclusive else chunk * (chunk - 1) // 2
    per_chunk = (5 * pairs * dk + 2 * pairs * dv + 4 * chunk * dk * dv
                 + 6 * chunk * dk + 3 * dk * dv)
    n_bytes = (sum(stored_bytes(t) for t in (q, k, v, log_w, u,
                                             initial_state))
               + v.element_size() * b * s * h * dv + 4 * b * h * dk * dv)
    return b * h * n * per_chunk, n_bytes


def backward_work(q, k, v, log_w, u, initial_state, *, inclusive: bool,
                  chunk: int = CHUNK) -> Tuple[int, int]:
    """(operations, bytes) of ``GlaChunkFn``'s backward, which recomputes
    a plain version and its gradient: three times the forward's
    operations (the forward once more, its gradient twice); the saved
    inputs and the two output gradients read once, every input gradient
    written once (dense)."""
    flops, fwd_bytes = work(q, k, v, log_w, u, inclusive=inclusive,
                            chunk=chunk, initial_state=initial_state)
    inputs = [t for t in (q, k, v, log_w, u, initial_state) if t is not None]
    return 3 * flops, fwd_bytes + sum(t.numel() * t.element_size()
                                      for t in inputs)


def scratch_bytes(q, k, v, log_w, u, inclusive: bool,
                  design: str = "auto") -> int:
    """Bytes of the f32 scratch a call allocates for its duration: the
    chunk-parallel designs' chunk states and per-chunk log-decays; the
    serial design (and the plain version) none."""
    if design == "serial" or not (takes_ssd(q, k, v, log_w, u, inclusive)
                                  or takes_rwkv6(q, v, inclusive)):
        return 0
    b, s, h, dk = q.shape
    n = -(-s // CHUNK)
    per_channel = dk if takes_rwkv6(q, v, inclusive) else 1
    return 4 * b * h * n * (dk * v.shape[-1] + per_channel)


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
        inclusive: bool = False, chunk: int = CHUNK,
        initial_state: Optional[torch.Tensor] = None,
        design: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk] or None;
    initial_state: [B, H, dk, dv] f32 or None (zeros). Returns (out [B, S,
    H, dv] in v's dtype, final_state [B, H, dk, dv] f32). Any S. On the
    card: q, k, v f32 or bf16 (one dtype), log_w, u and the state f32,
    dk <= 64, dv <= 128, chunk 64; q, k, v and log_w may have any strides
    (Mamba2's broadcast views are read with zero strides). ``design``
    ("auto", "ssd" or "serial") pins one design on the card, to time the
    two side by side; "ssd" raises where ``takes_ssd`` is false."""
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} not in {DESIGNS}")
    no_graph_inputs("gla_chunk", "gla_fn", q, k, v, log_w, u, initial_state)
    args = (q, k, v, log_w, u, inclusive, chunk, initial_state, design)
    if _build.COUNTER is not None:
        return _build.counted_call(
            "gla_chunk", lambda: _gla(*args),
            lambda out: work(q, k, v, log_w, u, inclusive=inclusive,
                             chunk=chunk, initial_state=initial_state),
            scratch_bytes(q, k, v, log_w, u, inclusive, design))
    return _gla(*args)


def _gla(q, k, v, log_w, u, inclusive, chunk, initial_state, design):
    if q.device.type != "meta" and not on_cuda(q, "gla_chunk"):
        out, final = gla_chunk_ref(q, k, v, log_w, u, inclusive=inclusive,
                                   chunk=chunk, initial_state=initial_state)
        return out.contiguous(), final.contiguous()
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
    ssd = takes_ssd(q, k, v, log_w, u, inclusive)
    rwkv6 = takes_rwkv6(q, v, inclusive)
    if design == "ssd" and not ssd:
        raise ValueError("the SSD design takes the Mamba2 regime in bf16 "
                         f"only, at dk in {SSD_DK} and dv in {SSD_DV}")
    if design == "rwkv6" and not rwkv6:
        raise ValueError("the RWKV6 design takes the lag-1 regime in bf16 "
                         f"only, at dk in {SSD_DK} and dv in {SSD_DV}")
    chunked = (ssd or rwkv6) and design != "serial"
    if chunked:
        n = -(-s // CHUNK)
        # the chunk states (ΔS, then each chunk's start state) and each
        # chunk's total log-decay (per channel for RWKV6)
        states = torch.empty((b, h, n, dk, dv), dtype=torch.float32,
                             device=dev)
        lc = torch.empty((b, h, n) + ((dk,) if rwkv6 else ()),
                         dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out, final
    stream = torch.cuda.current_stream(dev).cuda_stream
    s0 = None if initial_state is None else initial_state.data_ptr()
    if chunked:
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr())
        tail = (b, s, h, dk, dv, *q.stride(), *k.stride(), *v.stride(),
                *log_w.stride(), stream)
        if ssd:
            err = _ssd_fn()(*ptrs, s0, out.data_ptr(), final.data_ptr(),
                            states.data_ptr(), lc.data_ptr(), *tail)
        else:
            err = _rwkv6_fn()(*ptrs, None if u is None else u.data_ptr(),
                              s0, out.data_ptr(), final.data_ptr(),
                              states.data_ptr(), lc.data_ptr(), *tail)
        name = "gla_chunk_ssd" if ssd else "gla_chunk_rwkv6"
        raise_on(err, name)
        count_launch(launches, "gla_chunk", name)
        return out, final
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                None if u is None else u.data_ptr(),
                s0, out.data_ptr(), final.data_ptr(), _DTYPES[q.dtype], b,
                s, h, dk, dv, int(inclusive), *q.stride(), *k.stride(),
                *v.stride(), *log_w.stride(), stream)
    raise_on(err, "gla_chunk")
    count_launch(launches, "gla_chunk")
    return out, final


def plain_for(q, k, v, log_w, u, inclusive: bool, chunk: int = CHUNK):
    """The plain version whose gradient ``GlaChunkFn`` returns for these
    inputs, as ``f(q, k, v, log_w, u, initial_state) -> (out, final)``."""
    if takes_ssd(q, k, v, log_w, u, inclusive):
        return lambda q, k, v, log_w, u, s0: gla_ssd_ref(
            q, k, v, log_w, chunk=chunk, initial_state=s0)
    return lambda q, k, v, log_w, u, s0: gla_chunk_ref(
        q, k, v, log_w, u, inclusive=inclusive, chunk=chunk,
        initial_state=s0)


class GlaChunkFn(torch.autograd.Function):
    """``gla`` with a gradient: the kernel forward (the plain version for
    CPU tensors), the gradient of ``plain_for``'s plain version backward
    (recomputed from the saved inputs). Broadcast (zero-stride) inputs
    get their gradient summed by ``expand``'s own backward."""

    @staticmethod
    def forward(ctx, q, k, v, log_w, u, initial_state, inclusive: bool,
                chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_w, u, initial_state)
        ctx.inclusive, ctx.chunk = inclusive, chunk
        return gla(q, k, v, log_w, u, inclusive=inclusive, chunk=chunk,
                   initial_state=initial_state)

    @staticmethod
    def backward(ctx, grad_out, grad_final):
        saved = ctx.saved_tensors          # unpacked once (checkpointing)
        q, k, v, log_w, u, _ = saved

        plain = plain_for(q, k, v, log_w, u, ctx.inclusive, ctx.chunk)

        def run():
            if q.device.type == "meta":
                grads = [torch.empty_like(t) if t is not None and n
                         else None
                         for t, n in zip(saved, ctx.needs_input_grad)]
            else:
                grads = recompute_grads(plain, saved, ctx.needs_input_grad,
                                        (grad_out, grad_final))
            return [None if t is None else like(t, g)
                    for t, g in zip(saved, grads)]

        if _build.COUNTER is not None:
            # the recompute's activations and temporaries, live during the
            # call on every device (on meta nothing runs)
            key = ("gla", ctx.inclusive, ctx.chunk, ctx.needs_input_grad,
                   grad_final is None,
                   *(None if t is None else (t.shape, t.dtype)
                     for t in saved))
            grads = _build.counted_call(
                "gla_chunk_backward", run,
                lambda grads: backward_work(*saved, inclusive=ctx.inclusive,
                                            chunk=ctx.chunk),
                _build.recompute_scratch(key, plain, saved,
                                         ctx.needs_input_grad,
                                         (grad_out, grad_final)))
        else:
            grads = run()
        return (*grads, None, None)


def gla_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
           inclusive: bool = False, chunk: int = CHUNK,
           initial_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gla`` (the default design) through ``GlaChunkFn``: what the model
    calls in every mode."""
    return GlaChunkFn.apply(q, k, v, log_w, u, initial_state, inclusive,
                            chunk)


__all__ = ["GlaChunkFn", "backward_work", "gla", "gla_chunk_ref", "gla_fn",
           "launches", "plain_for", "scratch_bytes", "takes_rwkv6",
           "takes_ssd", "work"]
