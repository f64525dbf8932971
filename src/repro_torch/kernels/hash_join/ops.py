"""Wrappers of the hash-join CUDA kernels (``csrc/hash_join.cu``): the
single-table probe and the transform's probe of both master caches.

For CPU tensors each runs its plain version (``ref.py``); for CUDA
tensors it launches its kernel on the current stream or raises.
``launches[<wrapper>]`` counts kernel launches (plain-version calls do
not count)."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels._build import check, count_launch, on_cuda, raise_on
from repro_torch.kernels.hash_join.ref import (hash_join_pair_ref,
                                               hash_join_ref)

launches = {"hash_join": 0, "hash_join_pair": 0}
MAX_PAIR_WIDTH = 64   # a half-warp copies a joined row as 16 float4s

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "hash_join_launch": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "hash_join_pair_launch": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I,
                              _P, _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    from repro_torch.kernels._build import library
    fn = getattr(library("hash_join"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _I
    return fn


def check_table(keys, vals, name: str, dev, max_width=None) -> None:
    """Raise unless (keys [S] i32, vals [S, W] f32) is a cache table on
    ``dev`` that the probe kernels take: S >= 1, W % 4 == 0 (at most
    ``max_width``), vals 16-byte aligned."""
    check(keys, f"{name} keys", torch.int32, (None,), dev)
    check(vals, f"{name} vals", torch.float32, (None, None), dev)
    n_slots, width = vals.shape
    if keys.shape[0] != n_slots:
        raise ValueError(f"{name}: keys and vals disagree on the slot count")
    limit = "" if max_width is None else f" up to {max_width}"
    if (n_slots < 1 or width % 4 or vals.data_ptr() % 16
            or (max_width is not None and width > max_width)):
        raise ValueError(f"{name} vals needs >= 1 slot, a width divisible "
                         f"by 4{limit} and 16-byte alignment")


def hash_join(query_keys: torch.Tensor, keys_tbl: torch.Tensor,
              vals_tbl: torch.Tensor, txn_tbl: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe ``query_keys`` [N] i32 against the open-addressing table
    (keys [S] i32, vals [S, W] f32, txn [S] i32). Returns (vals [N, W]
    f32, found [N] bool, txn [N] i32). -2 is the conventional pad key (it
    never matches a slot)."""
    if not on_cuda(query_keys, "hash_join"):
        return hash_join_ref(query_keys, keys_tbl, vals_tbl, txn_tbl)
    dev = query_keys.device
    check(query_keys, "query_keys", torch.int32, (None,), dev)
    check_table(keys_tbl, vals_tbl, "table", dev)
    check(txn_tbl, "txn_tbl", torch.int32, (None,), dev)
    n_slots, width = vals_tbl.shape
    if txn_tbl.shape[0] != n_slots:
        raise ValueError("keys/vals/txn tables disagree on the slot count")
    n = query_keys.shape[0]
    out_vals = torch.empty((n, width), dtype=torch.float32, device=dev)
    out_found = torch.empty(n, dtype=torch.bool, device=dev)
    out_txn = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_vals, out_found, out_txn
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("hash_join_launch")(query_keys.data_ptr(), n,
                                  keys_tbl.data_ptr(),
                                  vals_tbl.data_ptr(), txn_tbl.data_ptr(),
                                  n_slots, width, out_vals.data_ptr(),
                                  out_found.data_ptr(), out_txn.data_ptr(),
                                  stream)
    raise_on(err, "hash_join")
    count_launch(launches, "hash_join")
    return out_vals, out_found, out_txn


def hash_join_pair(prod: torch.Tensor, eq_table, q_table
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both probes of one transform in one launch: prod [N, P] f32
    (P >= 2) probed against the equipment cache with col 1 and against
    the quality cache with col 0, each truncated toward zero to int32;
    ``eq_table`` / ``q_table`` are a cache's (keys [S] i32, vals [S, W]
    f32, txn [S] i32), txn unread. Returns (eq_rows [N, W_eq] f32, q_rows
    [N, W_q] f32, found [N] bool): the hit rows, a miss's row zeros with
    col 1 set to -1.0, and found = eq_found & q_found. Bitwise
    ``hash_join_pair_ref``."""
    if not on_cuda(prod, "hash_join_pair"):
        return hash_join_pair_ref(prod, eq_table, q_table)
    dev = prod.device
    check(prod, "prod", torch.float32, (None, None), dev)
    (eqk, eqv, _), (qk, qv, _) = eq_table, q_table
    check_table(eqk, eqv, "eq_table", dev, MAX_PAIR_WIDTH)
    check_table(qk, qv, "q_table", dev, MAX_PAIR_WIDTH)
    n, prod_w = prod.shape
    if prod_w < 2 or eqv.shape[1] < 2 or qv.shape[1] < 2:
        raise ValueError("prod and the joined rows need a key column 1")
    eq_rows = torch.empty((n, eqv.shape[1]), dtype=torch.float32, device=dev)
    q_rows = torch.empty((n, qv.shape[1]), dtype=torch.float32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return eq_rows, q_rows, found
    err = _fn("hash_join_pair_launch")(
        prod.data_ptr(), n, prod_w, eqk.data_ptr(), eqv.data_ptr(),
        eqv.shape[0], eqv.shape[1], qk.data_ptr(), qv.data_ptr(),
        qv.shape[0], qv.shape[1], eq_rows.data_ptr(), q_rows.data_ptr(),
        found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "hash_join_pair")
    count_launch(launches, "hash_join_pair")
    return eq_rows, q_rows, found


__all__ = ["check_table", "hash_join", "hash_join_pair", "hash_join_pair_ref",
           "hash_join_ref", "launches"]
