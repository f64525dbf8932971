"""Plain PyTorch versions of the ``gla_chunk`` CUDA kernels.

``gla_chunk_ref`` is the oracle the card checks both designs against and
what ``ops.gla`` runs for CPU tensors: the chunked form of the JAX
package's ``models/gla.py:gla_chunk`` in torch, with f32 decay ratios (the
Pallas kernel's precision, the reference's ``ratio_dtype=jnp.float32``),
an optional initial state and the final state returned. ``gla_ssd_ref``
and ``gla_rwkv6_ref`` are the chunk-parallel decompositions of the SSD
and the RWKV6 design, for the tests.

Recurrence per head (state S in R^{dk x dv}):

    S_t = diag(w_t) @ S_{t-1} + k_t v_t^T            (w_t in (0,1])
    o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)        lag=1 w/ bonus  (RWKV6)
    o_t = q_t @ S_t                                  lag=0           (Mamba2)

Both compute in f32 (f64 for f64 inputs, so that their gradients can be
checked numerically).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def gla_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                  inclusive: bool = False, chunk: int = 64,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk] or None;
    initial_state: [B, H, dk, dv] or None (zeros). Returns (out [B, S, H,
    dv] in v's dtype, final_state [B, H, dk, dv] f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    s_orig = s
    if s % chunk:
        # pad with k=0 (no state contribution), log_w=0 (w=1: state frozen)
        pad = chunk - s % chunk
        q, k, v, log_w = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (q, k, v, log_w))
        s += pad
    n = s // chunk
    acc = torch.promote_types(q.dtype, torch.float32)

    def chunks(x):                                   # [n, b, h, C, d] f32
        return x.reshape(b, n, chunk, h, -1).permute(1, 0, 3, 2, 4).to(acc)

    qc, kc, vc, lw = chunks(q), chunks(k), chunks(v), chunks(log_w)
    lag = 0 if inclusive else 1
    t_idx = torch.arange(chunk, device=q.device)
    # masked (t, i) pairs: i > t - lag
    masked = t_idx[:, None] < (t_idx[None, :] + lag)
    S = (initial_state.to(acc) if initial_state is not None
         else torch.zeros((b, h, dk, dv), dtype=acc, device=q.device))
    outs = []
    for c in range(n):
        qb, kb, vb, lwb = qc[c], kc[c], vc[c], lw[c]          # [b,h,C,*]
        L = torch.cumsum(lwb, dim=2)          # inclusive cumulative log-decay
        Lq = L if inclusive else L - lwb      # L_t or L_{t-1}
        # inter-chunk: q_t (decayed) @ S_in
        inter = torch.einsum("bhtk,bhkv->bhtv", qb * torch.exp(Lq), S)
        # intra-chunk: A[t,i] = sum_d q_td k_id exp(Lq_td - L_id), masked
        # before the exp
        diff = Lq[:, :, :, None, :] - L[:, :, None, :, :]    # [b,h,t,i,dk]
        diff = diff.masked_fill(masked[:, :, None], NEG_INF)
        A = (qb[:, :, :, None, :] * kb[:, :, None, :, :]
             * torch.exp(diff)).sum(dim=-1)
        out = inter + torch.einsum("bhti,bhiv->bhtv", A, vb)
        if u is not None:                     # RWKV6 current-token bonus
            dot = (qb * u.to(acc)[None, :, None, :] * kb).sum(dim=-1)
            out = out + dot[..., None] * vb
        # state update: S <- diag(exp(L_C)) S + sum_i k_i exp(L_C-L_i) v_i
        Ltot = L[:, :, -1:, :]
        k_dec = kb * torch.exp(Ltot - L)
        S = torch.exp(Ltot[:, :, 0])[..., None] * S + \
            torch.einsum("bhtk,bhtv->bhkv", k_dec, vb)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    return out[:, :s_orig].to(v.dtype), S


def gla_ssd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, *, chunk: int = 64,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel (SSD) decomposition that ``csrc/gla_ssd.cu``
    computes, in plain f32 torch, for the tests: the Mamba2 regime
    (inclusive read, no bonus, one log-decay per (token, head): channel 0
    of ``log_w`` is read). Shapes and returns as ``gla_chunk_ref``.

      1. chunk states: per chunk and head, dS = Σ_i k_i exp(L_C − L_i) v_iᵀ
         and the chunk's total log-decay L_C;
      2. state passing: S_c = exp(L_C) S_{c-1} + dS_c from the initial
         state, keeping each chunk's start state;
      3. chunk scan: out_t = exp(L_t) q_t S_{c-1}
                           + Σ_{i<=t} (q_t·k_i) exp(L_t − L_i) v_i."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        q, k, v, log_w = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (q, k, v, log_w))
        s += pad
    n = s // chunk
    acc = torch.promote_types(q.dtype, torch.float32)

    def chunks(x):                                # [b, h, n, C, d] f32
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4).to(acc)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    L = torch.cumsum(chunks(log_w[..., :1])[..., 0], dim=-1)   # [b,h,n,C]
    Lc = L[..., -1]
    # 1. chunk states
    d_state = torch.einsum("bhnid,bhnij->bhndj", kc,
                           torch.exp(Lc[..., None] - L)[..., None] * vc)
    # 2. state passing
    S = (initial_state.to(acc) if initial_state is not None
         else torch.zeros((b, h, dk, dv), dtype=acc, device=q.device))
    starts = []
    for c in range(n):
        starts.append(S)
        S = torch.exp(Lc[:, :, c])[..., None, None] * S + d_state[:, :, c]
    # 3. chunk scan
    t_idx = torch.arange(chunk, device=q.device)
    masked = t_idx[:, None] < t_idx[None, :]
    ratios = torch.exp((L[..., :, None] - L[..., None, :])
                       .masked_fill(masked, NEG_INF))
    scores = torch.einsum("bhntd,bhnid->bhnti", qc, kc) * ratios
    out = (torch.einsum("bhnti,bhnij->bhntj", scores, vc)
           + torch.exp(L)[..., None] * torch.einsum(
               "bhntd,bhndj->bhntj", qc, torch.stack(starts, dim=2)))
    out = out.permute(0, 2, 3, 1, 4).reshape(b, s, h, dv)
    return out[:, :s_orig].to(v.dtype), S


def gla_rwkv6_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                  chunk: int = 64, sub: int = 16,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel decomposition that ``csrc/gla_rwkv6.cu``
    computes, in plain f32 torch, for the tests: the RWKV6 regime (lag-1
    read, bonus ``u`` or none, per-head q and k, one log-decay per
    channel). Shapes and returns as ``gla_chunk_ref``. With L the
    inclusive cumulative log-decay in a chunk and Lq = L − log_w:

      1. chunk states: dS = (k∘exp(L_C − L))ᵀ v and L_C per channel;
      2. state passing: S_c = exp(L_C)∘S_{c-1} + dS_c from the initial
         state, keeping each chunk's start state;
      3. chunk scan: out = (q∘exp(Lq))·S_{c-1} + A·v, where A over query
         sub-chunk a (``sub`` tokens) and key sub-chunk b < a is
         (q∘exp(Lq − Λ_a))·(k∘exp(Λ_a − L))ᵀ with the anchor Λ_a = Lq at
         a's first token (both exponents <= 0; keys of b >= a are masked
         before the exp), the diagonal blocks are exact, masked before the
         exp (i < t), and the bonus q_t·u·k_t sits on the diagonal."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        q, k, v, log_w = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (q, k, v, log_w))
        s += pad
    n, m = s // chunk, chunk // sub
    acc = torch.promote_types(q.dtype, torch.float32)

    def chunks(x):                                # [b, h, n, C, d] f32
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4).to(acc)

    qc, kc, vc, lw = chunks(q), chunks(k), chunks(v), chunks(log_w)
    L = torch.cumsum(lw, dim=3)
    Lq = L - lw
    Lc = L[..., -1, :]                                        # [b,h,n,dk]
    # 1. chunk states
    d_state = torch.einsum("bhnid,bhnij->bhndj",
                           kc * torch.exp(Lc[..., None, :] - L), vc)
    # 2. state passing
    S = (initial_state.to(acc) if initial_state is not None
         else torch.zeros((b, h, dk, dv), dtype=acc, device=q.device))
    starts = []
    for c in range(n):
        starts.append(S)
        S = torch.exp(Lc[:, :, c])[..., None] * S + d_state[:, :, c]
    # 3. chunk scan: inter
    out = torch.einsum("bhntd,bhndj->bhntj", qc * torch.exp(Lq),
                       torch.stack(starts, dim=2))
    # off-diagonal sub-chunk pairs through the anchors
    by_sub = lambda x: x.reshape(b, h, n, m, sub, -1)         # noqa: E731
    qs, ks, Ls, Lqs = by_sub(qc), by_sub(kc), by_sub(L), by_sub(Lq)
    anchor = Lqs[..., :1, :]                              # [b,h,n,m,1,dk]
    q_sc = qs * torch.exp(Lqs - anchor)
    key_sub = torch.arange(chunk, device=q.device) // sub
    later = key_sub[None, :] >= torch.arange(m, device=q.device)[:, None]
    k_exp = (anchor - L[:, :, :, None]).masked_fill(
        later[:, :, None], NEG_INF)                       # [b,h,n,m,C,dk]
    A = torch.einsum("bhnatd,bhnaid->bhnati", q_sc,
                     kc[:, :, :, None] * torch.exp(k_exp))
    # diagonal blocks, exact, and the bonus on their diagonal
    t_idx = torch.arange(sub, device=q.device)
    masked = t_idx[:, None] <= t_idx[None, :]                 # i >= t
    diff = (Lqs[..., :, None, :] - Ls[..., None, :, :]).masked_fill(
        masked[..., None], NEG_INF)
    diag = (qs[..., :, None, :] * ks[..., None, :, :]
            * torch.exp(diff)).sum(-1)                    # [b,h,n,m,t,i]
    if u is not None:
        bonus = (qs * u.to(acc)[None, :, None, None, None, :] * ks).sum(-1)
        diag = diag + torch.diag_embed(bonus)
    eye = torch.eye(m, dtype=acc, device=q.device)
    A = A + (diag[..., None, :] * eye[:, None, :, None]).reshape(
        b, h, n, m, sub, chunk)
    out = out + torch.einsum("bhnti,bhnij->bhntj",
                             A.reshape(b, h, n, chunk, chunk), vc)
    out = out.permute(0, 2, 3, 1, 4).reshape(b, s, h, dv)
    return out[:, :s_orig].to(v.dtype), S
