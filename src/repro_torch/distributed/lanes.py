"""Simulation placement: lanes and block groups over a list of devices.

The port of ``repro.distributed.lanes``.  The simulator's multi-device
story (paper §4.2, multi-GPU) has two tiers, both laid out along one 1-D
axis, :data:`LANE_AXIS`:

* **lane sharding**: a ``run_batch`` / trajectory run of K lanes splits
  its lanes into contiguous :class:`LaneShard` slices, one a device.
  Each device runs its lane slice of every wave against its own
  partition of the block store (lane keys never collide), so nothing is
  exchanged; the only gather is the host-side readout
  (:func:`gather_lanes`).
* **block sharding**: a single state's SV groups are placed by the
  plan's ``StagePlan.device_slot`` round-robin (:func:`device_slots`
  mirrors it).  Stage boundaries exchange only the encoded wire blobs
  through the host store; the engine's exchange ledger
  (``SimStats.exchange_bytes``) accounts every byte whose block changed
  owners.

torch has no ``Mesh`` and no sharding objects: placement here is a plain
list of :class:`torch.device`, and :func:`make_lane_mesh` returns a small
frozen :class:`LaneMesh` over it.  ``repro``'s ``lane_spec``,
``lane_sharding`` and ``activate_mesh`` name JAX sharding objects and
have no counterpart.  A list may repeat a device (``[cuda:0] * 4``): D
slots on one card, the placement the tests and the one-card smoke run.
``torch.device`` objects are not singletons, so devices are compared by
equality, never by identity.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "LANE_AXIS",
    "LaneMesh",
    "LaneShard",
    "device_slots",
    "gather_lanes",
    "make_lane_mesh",
    "make_lane_shards",
    "sim_devices",
    "visible_devices",
]

#: the one axis of the simulation tier: independent lanes (batch lanes /
#: noise trajectories), or, for a single-lane run, the round-robin slot
#: dimension its SV groups are placed over
LANE_AXIS = "lanes"


def visible_devices() -> list[torch.device]:
    """The CUDA cards this process sees, ``cuda:0`` first; raises where
    there are none (the CPU is only ever used when asked for by name)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; ask for the CPU explicitly (e.g. "
            "EngineConfig(devices=[torch.device('cpu')] * D))")
    return [torch.device("cuda", i) for i in range(n)]


def sim_devices(n_devices: int | None = None,
                devices: Sequence[torch.device] | None = None
                ) -> list[torch.device]:
    """The device list one simulation placement is built over.

    ``devices`` (default: :func:`visible_devices`) is truncated to
    ``n_devices`` when given; asking for more devices than the list holds
    clamps to its length with a ``RuntimeWarning``: a device is never
    repeated silently (pass ``[d] * D`` for D slots on one device, as
    ``qsim --devices D`` does).
    """
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices())
    if not devs:
        raise ValueError("no devices given")
    if n_devices is None:
        return devs
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1")
    if n_devices > len(devs):
        warnings.warn(
            f"requested {n_devices} devices but only {len(devs)} are "
            f"visible; clamping (pass an explicit device list such as "
            f"[torch.device('cuda', 0)] * {n_devices} for slots on one "
            "device)", RuntimeWarning, stacklevel=2)
        return devs
    return devs[:n_devices]


@dataclass(frozen=True)
class LaneMesh:
    """The 1-D simulation placement: ``devices`` along ``axis``."""

    devices: tuple
    axis: str = LANE_AXIS

    @property
    def shape(self) -> tuple[int]:
        return (len(self.devices),)


def make_lane_mesh(mesh_shape: tuple[int, ...] | int | None = None,
                   devices: Sequence[torch.device] | None = None
                   ) -> LaneMesh:
    """Build the 1-D simulation placement (axis :data:`LANE_AXIS`).

    ``mesh_shape`` is ``(n_devices,)`` (or a bare int); ``None`` spans
    every device of ``devices`` (default: every visible card).  Only 1-D
    placements exist in the simulation tier: lanes and block slots are
    both laid out along the one axis.
    """
    if isinstance(mesh_shape, int):
        mesh_shape = (mesh_shape,)
    if mesh_shape is not None:
        if len(mesh_shape) != 1:
            raise ValueError(
                f"simulation meshes are 1-D (lanes axis); got "
                f"mesh_shape={mesh_shape!r}")
        n = int(mesh_shape[0])
    else:
        n = None
    return LaneMesh(tuple(sim_devices(n, devices)))


@dataclass(frozen=True)
class LaneShard:
    """One device's contiguous lane slice of a batched run.

    ``lanes`` indexes the run's lane axis (and thereby its
    ``lane_offsets`` row block and its store-key range): the shard's
    partition of the block store is ``[lane.start * n_blocks,
    lane.stop * n_blocks)`` shifted by the chunk base.
    """

    device: torch.device
    lanes: slice

    @property
    def n_lanes(self) -> int:
        return self.lanes.stop - self.lanes.start


def make_lane_shards(devices: Sequence[torch.device], n_lanes: int
                     ) -> list[LaneShard]:
    """Contiguous, near-even lane shards over ``devices``.

    The first ``n_lanes % len(devices)`` shards get one extra lane
    (``np.array_split`` semantics); devices with zero lanes are dropped,
    so K < D simply uses K devices.  A ragged split is legal; the plan
    verifier reports lane counts the devices do not divide as a warning.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes={n_lanes} must be >= 1")
    d = max(1, len(devices))
    base, extra = divmod(n_lanes, d)
    shards = []
    lo = 0
    for i, dev in enumerate(devices):
        width = base + (1 if i < extra else 0)
        if width == 0:
            break
        shards.append(LaneShard(dev, slice(lo, lo + width)))
        lo += width
    return shards


def device_slots(n_groups: int, n_devices: int) -> np.ndarray:
    """Round-robin slot of every group: mirrors
    :meth:`repro_torch.core.plan.StagePlan.device_slot`, so the engine's
    placement and the plan artifact cannot drift."""
    return np.arange(n_groups, dtype=np.int64) % max(1, n_devices)


def gather_lanes(parts: Sequence[np.ndarray]) -> np.ndarray:
    """The one readout gather of a lane-sharded batch: the per-shard host
    results concatenated back into lane order (shards are contiguous, so
    this is the inverse of :func:`make_lane_shards`)."""
    arrs = [np.asarray(p) for p in parts]
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
