"""Gated linear recurrence, shared by RWKV6 and Mamba2/SSD.

Recurrence per head (state S in R^{dk x dv}):

    S_t = diag(w_t) @ S_{t-1} + k_t v_t^T            (w_t in (0,1])
    o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)        lag=1 w/ bonus  (RWKV6)
    o_t = q_t @ S_t                                  lag=0           (Mamba2)

``gla_chunk`` (train and prefill) is the hand-written ``gla_chunk`` kernel
on the card (``kernels.gla_chunk.ops.gla``; its plain version, the
chunked form with f32 decay ratios, on the CPU), through its autograd
Function ``gla_fn``, whose gradient is the plain version's. ``gla_step``
(decode) is one token of the recurrence in plain torch.

The JAX package's ``models/gla.py:gla_chunk`` rounds q, k and the decay
ratios of the intra-chunk term to ``ratio_dtype`` (bf16 by default, which
Mamba2 uses); the port keeps f32 accuracy there, as the Pallas kernel
does: the serial design computes in f32, the SSD design (Mamba2 in bf16)
and the RWKV6 design (RWKV6 in bf16) split each f32 operand of their
bf16 products into hi + lo parts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gla_chunk import ops as gla_ops


def gla_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, *, u: Optional[torch.Tensor] = None,
              inclusive: bool = False, chunk: int = 64,
              initial_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk] or None.

    Returns (out [B, S, H, dv], final_state [B, H, dk, dv] f32).
    ``inclusive=False`` reads the state *before* the current token (RWKV6,
    combined with the ``u`` bonus for the diagonal); ``inclusive=True``
    reads the state after the update (Mamba2 — pass ``u=None``)."""
    return gla_ops.gla_fn(q, k, v, log_w.float(),
                          None if u is None else u.float(),
                          inclusive=inclusive, chunk=chunk,
                          initial_state=(None if initial_state is None
                                         else initial_state.float()))


def gla_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, state: torch.Tensor, *,
             u: Optional[torch.Tensor] = None,
             inclusive: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step (decode). q, k, log_w: [B, H, dk]; v: [B, H,
    dv]; state: [B, H, dk, dv] (f32). Returns (o [B, H, dv], new_state)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    kv = kf[..., :, None] * vf[..., None, :]               # [B,H,dk,dv]
    s_new = w[..., None] * state + kv
    read = s_new if inclusive else state
    o = torch.einsum("bhk,bhkv->bhv", qf, read)
    if u is not None:
        dot = (qf * u.float()[None] * kf).sum(dim=-1)
        o = o + dot[..., None] * vf
    return o.to(v.dtype), s_new
