"""Plain PyTorch versions of the hash-join probes: the oracles of the CUDA
kernels and what the wrappers run for CPU tensors. Same contract as the
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


_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


def key_to_int32(x: torch.Tensor) -> torch.Tensor:
    """A float join key cast to int32 as the JAX reference's device
    backends cast it (``astype(jnp.int32)``) and as the CUDA kernels do
    (``__float2int_rz``, PTX ``cvt.rzi.s32.f32``): NaN gives 0, values
    outside int32 saturate to [-2**31, 2**31 - 1], the rest truncate
    toward zero. (``.to(torch.int32)`` on the CPU gives -2**31 for NaN,
    +-inf and every value out of range.)"""
    x = x.to(torch.float64)
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device), x)
    return x.clamp(_INT32_MIN, _INT32_MAX).to(torch.int32)


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


def hash_join_pair_ref(prod: torch.Tensor, eq_table, q_table
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The transform's two probes as separate ops: prod's col 1 and col 0
    cast to int32 (``key_to_int32``), probed against the equipment and
    quality caches (``eq_table`` / ``q_table``: keys, vals, txn), a
    missed row's key lane (col 1) set to -1.0, found = eq_found &
    q_found. Returns (eq_rows, q_rows, found)."""
    equip_id = key_to_int32(prod[:, 1])
    prod_id = key_to_int32(prod[:, 0])
    eq_rows, eq_found, _ = hash_join_ref(equip_id, *eq_table)
    q_rows, q_found, _ = hash_join_ref(prod_id, *q_table)
    # the probe outputs are fresh tensors, safe to write in place
    eq_rows[:, 1].masked_fill_(~eq_found, -1.0)
    q_rows[:, 1].masked_fill_(~q_found, -1.0)
    return eq_rows, q_rows, eq_found & q_found
