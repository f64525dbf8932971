"""Plain PyTorch version of the hash-join probe: the oracle of the CUDA
kernel and what the wrapper runs for CPU tensors. Same contract as the
reference's ``_hash_probe_np`` (bitwise): lowbias32 hash, h = hash %
n_slots, up to ``MAX_PROBES`` linear probes, a hit tested before an empty
slot (-1)."""
from __future__ import annotations

from typing import Tuple

import torch

MAX_PROBES = 16
_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without int64
    overflow: split ``c`` into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """lowbias32 of the keys' low 32 bits, as int64 in [0, 2**32). Written
    in int64 arithmetic: uint32 shifts are not implemented on the CPU."""
    x = keys.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_join_ref(query_keys: torch.Tensor, keys_tbl: torch.Tensor,
                  vals_tbl: torch.Tensor, txn_tbl: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """query_keys [N] i32, keys_tbl [S] i32, vals_tbl [S, W] f32, txn_tbl
    [S] i32 -> (vals [N, W] f32, found [N] bool, txn [N] i32)."""
    n_slots = keys_tbl.shape[0]
    q = query_keys.to(torch.int32)
    h = hash32(q) % n_slots
    n = q.shape[0]
    done = torch.zeros(n, dtype=torch.bool, device=q.device)
    slot = torch.full((n,), -1, dtype=torch.int64, device=q.device)
    for p in range(MAX_PROBES):
        cand = (h + p) % n_slots
        k = keys_tbl[cand]
        hit = (k == q) & ~done
        slot = torch.where(hit, cand, slot)
        done = done | hit | (k == -1)
    found = slot >= 0
    safe = slot.clamp(min=0)
    vals = torch.where(found[:, None], vals_tbl[safe],
                       torch.zeros((), dtype=vals_tbl.dtype,
                                   device=q.device))
    txn = torch.where(found, txn_tbl[safe].to(torch.int32),
                      torch.zeros((), dtype=torch.int32, device=q.device))
    return vals, found, txn
