"""Carry weights across from the JAX package: its ``Model.init`` pytree,
given as numpy arrays (the caller does the ``np.asarray``), becomes the
port's parameter tree. The two trees have the same structure and leaf
shapes — the port keeps the stacked ``[L, ...]`` layer axis — so the
conversion is leaf for leaf, checked against the port's ParamDefs. An
``AdamWState`` (step, mu, nu as numpy) carries across the same way
(``opt_from_reference``), so both packages can start from one optimizer
state."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.param import ParamDef


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)          # a writable, contiguous copy of its own
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bf16, as JAX hands it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_reference(defs, tree) -> Any:
    """``tree``: nested dicts of numpy arrays shaped as ``defs`` (a port
    ``Model.defs``), of any family. Returns the same tree as CPU torch
    tensors in the arrays' dtypes (the reference's init: bf16 leaves and
    the MoE router's f32). Raises on a missing or extra key or a shape
    that differs."""
    if isinstance(defs, ParamDef):
        if not isinstance(tree, np.ndarray):
            raise TypeError(f"expected a numpy array, got {type(tree)}")
        if tuple(tree.shape) != tuple(defs.shape):
            raise ValueError(f"shape {tree.shape}, expected {defs.shape}")
        return _tensor(tree)
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"keys {got}, expected {sorted(defs)}")
    return {k: from_reference(defs[k], tree[k]) for k in defs}


def opt_from_reference(defs, state):
    """The reference's ``AdamWState`` (any ``(step, mu, nu)`` sequence of
    numpy arrays; mu and nu shaped as ``defs``) as the port's, on the
    CPU."""
    from repro_torch.optim import AdamWState
    step, mu, nu = state
    return AdamWState(step=_tensor(np.asarray(step, dtype=np.int32)),
                      mu=from_reference(defs, mu), nu=from_reference(defs, nu))
