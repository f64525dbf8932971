"""The sharded serving plane's device mesh (the JAX package's
``launch/mesh.py``, only ``make_shard_mesh`` and ``mesh_devices``).

A mesh here is a plain object that holds one ``torch.device`` per serving
shard along one axis, ``shards``. It places nothing: the torch backend
folds every shard of a card on that card (the K masked folds of a delta
are K items of one launch), so on one card every shard maps to the same
device. ``ComputeBackend.set_mesh`` attaches it; ``mesh_report`` reads
whether the attached mesh has one device per shard. The JAX package's
host-device tricks (``virtual_devices``, ``jax_initialized``) have no
counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.backend import resolve_device

Device = Union[str, torch.device]


class ShardMesh:
    """A 1-D mesh: ``devices[k]`` is the device of serving shard ``k``."""

    axis_names: Tuple[str, ...] = ("shards",)

    def __init__(self, devices: Sequence[Device]):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"


def make_shard_mesh(n_shards: int,
                    devices: Optional[Sequence[Device]] = None) -> ShardMesh:
    """The serving plane's mesh of ``n_shards`` shards: ``devices`` (one
    per shard), or by default every shard on the card (``cuda``; raises
    where there is none)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [resolve_device(None)] * n_shards
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return ShardMesh(devices)


def mesh_devices(mesh: ShardMesh) -> int:
    return len(mesh.devices)


__all__ = ["ShardMesh", "make_shard_mesh", "mesh_devices"]
