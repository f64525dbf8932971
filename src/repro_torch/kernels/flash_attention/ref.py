"""Plain PyTorch version of the ``flash_attention`` CUDA kernel: the
oracle the card checks it against and what ``ops.mha`` runs for CPU
tensors. The JAX package's ``kernels/flash_attention/ref.py`` in torch:
scores and softmax in f32 (f64 for f64 inputs, so that its gradient can
be checked numerically), masked scores ``NEG_INF``, output in q's
dtype."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (any strides) ->
    [B, Hq, Sq, D]. The causal mask is query i sees keys j <= i."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, sq, d).to(acc)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(acc)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc))
    return o.reshape(b, hq, sq, d).to(q.dtype)
