"""Meshes (the JAX package's ``launch/mesh.py``): the model's
("data", "model") or multi-pod ("pod", "data", "model") mesh
(``make_mesh``, ``make_production_mesh``) and the sharded serving
plane's (``make_shard_mesh``, ``mesh_devices``).

A model mesh (``Mesh``) holds the axis names, their sizes, this rank's
coordinates (row-major: on ("data", "model") the ranks of one model
group are consecutive) and one process group per axis for the rank's
group along it (and one per run of consecutive axes short of the whole
mesh, such as "pod+data", the multi-pod batch's), made with ``torch.distributed.new_group`` once the
default group is initialized (gloo or NCCL; the caller gives
``init_process_group`` its address, world size and rank). Its
process-free form (``rank=`` given, no groups) is what the dry run traces
with on ``meta``: ``group(axis)`` then returns an ``AxisGroup`` stand-in
that a recorder of collectives reads. The reference's mesh of 256 TPU
chips becomes a 16 x 16 mesh of ranks, one per card.

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

import itertools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

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


class AxisGroup(NamedTuple):
    """The group of a process-free mesh's axis: its name and size."""
    axis: str
    size: int


class Mesh:
    """An n-D mesh of ranks: ``shape`` (sizes per axis), ``axis_names``,
    ``rank``, its coordinates ``coord(axis)`` and ``group(axis)``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, groups: Optional[Dict[str, object]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} for axes {axis_names}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, rest = {}, rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            rest, coords[name] = divmod(rest, n)
        self.coords = {a: coords[a] for a in self.axis_names}
        self.groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The rank's group along ``axis``, or along consecutive axes
        together named "a+b" (the multi-pod batch's "pod+data")."""
        if self.groups is None:
            return AxisGroup(axis, math.prod(
                self.shape[self.axis_names.index(a)]
                for a in axis.split("+")))
        return self.groups[axis]

    def world_group(self):
        """The group of every rank of the mesh: the default group (None)
        of a mesh with processes; for the process-free form an
        ``AxisGroup`` named by its axes of size > 1 ("data+model")."""
        if self.groups is not None:
            return None
        name = "+".join(a for a, n in zip(self.axis_names, self.shape)
                        if n > 1) or self.axis_names[0]
        return AxisGroup(name, self.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank}{'' if self.groups else ', process-free'})")


def _axis_ranks(shape: Tuple[int, ...], axis: int, stop: int = 0) -> list:
    """Every group of ranks along ``axis`` (through axis ``stop - 1``
    where ``stop`` is given: consecutive axes together; row-major rank
    order), in a fixed order: each rank must create every group, in the
    same order."""
    stop = stop or axis + 1
    others = [range(n) for i, n in enumerate(shape)
              if not axis <= i < stop]
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = []
    for rest in itertools.product(*others):
        coord = list(rest)
        for i in range(axis, stop):
            coord.insert(i, 0)
        base = sum(c * s for c, s in zip(coord, strides))
        groups.append([base + j * strides[stop - 1]
                       for j in range(math.prod(shape[axis:stop]))])
    return groups


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              rank: Optional[int] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. With ``rank`` given: the
    process-free form for that rank. Else the default process group must
    be initialized with ``prod(shape)`` ranks: one group per axis is made
    for this rank (``torch.distributed.new_group``; every rank calls this
    with the same arguments)."""
    shape = tuple(shape)
    if rank is not None:
        return Mesh(shape, axes, rank)
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(or rank= for the process-free form)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    me = dist.get_rank()
    groups = {}
    # one group per axis, then per run of consecutive axes short of the
    # whole mesh (the multi-pod batch's "pod+data")
    runs = [(i, i + 1) for i in range(len(axes))] + [
        (i, j) for i in range(len(axes)) for j in range(i + 2, len(axes) + 1)
        if j - i < len(axes)]
    for i, j in runs:
        for ranks in _axis_ranks(shape, i, j):
            g = dist.new_group(ranks)
            if me in ranks:
                groups["+".join(axes[i:j])] = g
    return Mesh(shape, axes, me, groups)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: Optional[int] = None) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks, one per card.
    Multi-pod: (pod=2, data=16, model=16) = 512. ``rank`` as in
    ``make_mesh`` (the dry run: the process-free form at rank 0)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, rank=rank)


__all__ = ["AxisGroup", "Mesh", "ShardMesh", "make_mesh",
           "make_production_mesh", "make_shard_mesh", "mesh_devices"]
