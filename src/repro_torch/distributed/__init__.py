"""Multi-device placement for the simulator: lanes and block groups over
a list of devices (:mod:`repro_torch.distributed.lanes`), the port of
``repro.distributed``.  ``repro``'s quarantined training rules
(``distributed/sharding.py``) are not ported here."""
from .lanes import (  # noqa: F401
    LANE_AXIS, LaneMesh, LaneShard, device_slots, gather_lanes,
    make_lane_mesh, make_lane_shards, sim_devices, visible_devices,
)
