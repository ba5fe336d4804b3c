"""Production mesh factory: the port of ``repro/launch/mesh.py``.

Torch has no ``jax.sharding.Mesh``: a mesh here is a plain description,
its axis names and sizes (the duck type ``distributed/sharding.py``'s rules
read: ``axis_names`` and a ``shape`` mapping) and, for a host mesh, the
devices it is laid over.  The production mesh holds no devices: the dry
run works on ``meta`` tensors and only reads its shape.  Functions, not
module-level constants, as in ``repro``: importing this module touches no
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..distributed.lanes import visible_devices

__all__ = ["MeshSpec", "make_production_mesh", "make_host_mesh"]


@dataclass(frozen=True)
class MeshSpec:
    """A device mesh by its axes: ``axis_names`` and their ``sizes``, and
    the ``devices`` laid over it row-major (empty for a description)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] = ()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 (256-chip pod) or 2x16x16 (2 pods = 512 chips)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1,
                   devices=None) -> MeshSpec:
    """Small mesh over ``devices`` (default: the visible cards): the first
    data x model of them; raises ``ValueError`` when fewer exist."""
    devs = list(visible_devices() if devices is None else devices)
    n = len(devs)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    return MeshSpec(("data", "model"), (data, model),
                    tuple(devs[:data * model]))
