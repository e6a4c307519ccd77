"""OSD tier: cluster map, placement groups, backends, the daemon.

The data plane (osd/ analog): OSDMap (epoch-versioned cluster state +
placement math), PG peering/recovery, ReplicatedBackend and ECBackend
(the device-accelerated erasure path on the CUDA kernels), scrub.
"""

from .osdmap import OSDMap, OSDMapIncremental, Pool, PgId

__all__ = ["OSDMap", "OSDMapIncremental", "Pool", "PgId"]
