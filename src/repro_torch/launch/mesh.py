"""Production mesh factory: the port of ``repro/launch/mesh.py``.

Torch has no ``jax.sharding.Mesh``: a mesh here is a plain description,
its axis names and sizes (the duck type ``distributed/sharding.py``'s rules
read: ``axis_names`` and a ``shape`` mapping) and, for a host mesh, the
devices it is laid over, one a rank.  The production mesh holds no
devices: the dry run works on ``meta`` tensors and only reads its shape.
Functions, not module-level constants, as in ``repro``: importing this
module touches no device.

Ranks are laid out row-major over the axes, as ``jax.make_mesh((d, m),
("data", "model"))`` lays out its devices: ``rank = data_index * m +
model_index``.  A rank's own view of the mesh (:meth:`MeshSpec.at`, made by
``distributed.collectives.init_rank``) adds its coordinates and its process
group along each axis; a device list may repeat one card, so ``[cuda:0] *
4`` is a 2x2 mesh of one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..distributed.lanes import visible_devices

__all__ = ["MeshSpec", "make_production_mesh", "make_host_mesh"]


@dataclass(frozen=True)
class MeshSpec:
    """A device mesh by its axes: ``axis_names`` and their ``sizes``, and
    the ``devices`` laid over it row-major (empty for a description).  A
    rank's view adds its ``coords`` (its index along each axis) and
    ``groups`` (its ``torch.distributed`` process group along each
    axis)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] = ()
    coords: tuple[int, ...] = ()
    groups: tuple = ()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Ranks of the mesh."""
        return math.prod(self.sizes)

    def coords_of(self, rank: int) -> tuple[int, ...]:
        """The coordinates of ``rank`` (row-major, the last axis
        fastest)."""
        out = []
        for n in reversed(self.sizes):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        rank = 0
        for c, n in zip(coords, self.sizes):
            rank = rank * n + c
        return rank

    @property
    def rank(self) -> int:
        """This view's rank (a rank's view only)."""
        return self.rank_of(self.coords)

    @property
    def device(self) -> torch.device:
        """This view's device (a rank's view only)."""
        return self.devices[self.rank]

    def index(self, axis: str) -> int:
        """This view's coordinate along ``axis`` (0 where the mesh has no
        such axis)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This view's process group along ``axis``."""
        return self.groups[self.axis_names.index(axis)]

    def at(self, rank: int, groups: tuple = ()) -> "MeshSpec":
        """The view of ``rank``: its coordinates and its ``groups``, one
        an axis."""
        return replace(self, coords=self.coords_of(rank),
                       groups=tuple(groups))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 (256-chip pod) or 2x16x16 (2 pods = 512 chips)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1,
                   devices=None) -> MeshSpec:
    """Small mesh over ``devices`` (default: the visible cards): the first
    data x model of them, one a rank (a list may repeat a device); raises
    ``ValueError`` when fewer exist."""
    devs = list(visible_devices() if devices is None else devices)
    n = len(devs)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    return MeshSpec(("data", "model"), (data, model),
                    tuple(devs[:data * model]))
