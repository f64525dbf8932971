"""Wrapper of the hash-join CUDA kernel (``csrc/hash_join.cu``).

For CPU tensors it runs the plain version (``ref.hash_join_ref``); for
CUDA tensors it launches the kernel on the current stream or raises.
``launches["hash_join"]`` counts kernel launches (plain-version calls do
not count)."""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels._build import check, count_launch, on_cuda, raise_on
from repro_torch.kernels.hash_join.ref import hash_join_ref

launches = {"hash_join": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels._build import library
    lib = library("hash_join")
    fn = lib.hash_join_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


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
    check(keys_tbl, "keys_tbl", torch.int32, (None,), dev)
    check(vals_tbl, "vals_tbl", torch.float32, (None, None), dev)
    check(txn_tbl, "txn_tbl", torch.int32, (None,), dev)
    n_slots, width = vals_tbl.shape
    if keys_tbl.shape[0] != n_slots or txn_tbl.shape[0] != n_slots:
        raise ValueError("keys/vals/txn tables disagree on the slot count")
    if n_slots < 1 or width % 4 or vals_tbl.data_ptr() % 16:
        raise ValueError("vals_tbl needs >= 1 slot, a width divisible by 4 "
                         "and 16-byte alignment")
    n = query_keys.shape[0]
    out_vals = torch.empty((n, width), dtype=torch.float32, device=dev)
    out_found = torch.empty(n, dtype=torch.bool, device=dev)
    out_txn = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_vals, out_found, out_txn
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(query_keys.data_ptr(), n, keys_tbl.data_ptr(),
                 vals_tbl.data_ptr(), txn_tbl.data_ptr(), n_slots, width,
                 out_vals.data_ptr(), out_found.data_ptr(),
                 out_txn.data_ptr(), stream)
    raise_on(err, "hash_join")
    count_launch(launches, "hash_join")
    return out_vals, out_found, out_txn


__all__ = ["hash_join", "hash_join_ref", "launches"]
