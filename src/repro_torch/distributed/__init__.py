"""Multi-device placement, the port of ``repro.distributed``: for the
simulator, lanes and block groups over a list of devices
(:mod:`repro_torch.distributed.lanes`); for the models, the FSDP x TP
partition-spec rules over a mesh description
(:mod:`repro_torch.distributed.sharding`), which the dry run reads
(``launch/dryrun.py``).  Sharded execution of a model step is not ported
(ROADMAP A12h)."""
from .lanes import (  # noqa: F401
    LANE_AXIS, LaneMesh, LaneShard, device_slots, gather_lanes,
    make_lane_mesh, make_lane_shards, sim_devices, visible_devices,
)
