"""Multi-device placement, the port of ``repro.distributed``: for the
simulator, lanes and block groups over a list of devices
(:mod:`repro_torch.distributed.lanes`); for the models, the FSDP x TP
partition-spec rules over a mesh description
(:mod:`repro_torch.distributed.sharding`), which the dry run reads
(``launch/dryrun.py``) and the sharded train step executes; and the
collective layer under that step, process groups of a host mesh over
``torch.distributed`` with the FSDP gather and Megatron's *f* and *g*
(:mod:`repro_torch.distributed.collectives`; ROADMAP A12h: the dense
family, the rest is A12h-b)."""
from .lanes import (  # noqa: F401
    LANE_AXIS, LaneMesh, LaneShard, device_slots, gather_lanes,
    make_lane_mesh, make_lane_shards, sim_devices, visible_devices,
)
