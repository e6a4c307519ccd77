"""OSDMap: epoch-versioned cluster state + placement math.

The analog of osd/OSDMap.{h,cc}: who is up/in, pool definitions, the
CRUSH map, EC profiles; placement goes object name -> pg (rjenkins +
stable_mod, osd/osd_types.h pg math) -> up/acting osd sets
(_pg_to_up_acting_osds at OSDMap.cc:1702: crush do_rule on the pool's
rule with the pg seed, honoring pg_temp and osd weights).  State moves
forward only via Incrementals committed by the monitor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

from ..crush import CrushMap, do_rule
from ..utils import denc
from ..utils.denc import denc_type
from ..crush.hashing import crush_hash32_2, rjenkins_hash
from ..crush.map import ITEM_NONE

REPLICATED = 1
ERASURE = 3

# osd state flags
UP = 1
IN = 2  # "exists + in" collapsed; weight handles partial in


@denc_type
class PgId(NamedTuple):
    pool: int
    seed: int

    def __str__(self):
        return f"{self.pool}.{self.seed:x}"

    @staticmethod
    def parse(s: str) -> "PgId":
        pool, seed = s.split(".")
        return PgId(int(pool), int(seed, 16))


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Bucket x into b buckets, stable as b grows (osd_types.h)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def pg_num_mask(pg_num: int) -> int:
    """Smallest 2^n-1 >= pg_num-1 (calc_pg_masks semantics)."""
    return (1 << (pg_num - 1).bit_length()) - 1 if pg_num > 1 else 0


def parent_seed(child: int, old_pg_num: int) -> int:
    """The pg seed that held a child's objects BEFORE pg_num grew past
    it (pg split ancestry, pg_t::is_split semantics): stable_mod keeps
    existing buckets in place, so a new seed c (>= old_pg_num) drains
    from the old bucket its low bits named."""
    if child < old_pg_num:
        return child
    mask = pg_num_mask(old_pg_num)
    p = child & mask
    if p >= old_pg_num:
        p = child & (mask >> 1)
    return p


@denc_type
@dataclass
class Pool:
    id: int
    name: str
    type: int = REPLICATED             # REPLICATED | ERASURE
    size: int = 3
    min_size: int = 2
    pg_num: int = 8
    crush_ruleset: int = 0
    erasure_code_profile: str = ""
    snap_seq: int = 0                  # self-managed snap id allocator
    removed_snaps: list = field(default_factory=list)
    # cache tiering (pg_pool_t tier fields, osd/osd_types.h)
    tier_of: int = -1                  # this pool IS a cache for pool id
    tiers: list = field(default_factory=list)   # cache pools over us
    read_tier: int = -1                # overlay: redirect reads here
    write_tier: int = -1               # overlay: redirect writes here
    cache_mode: str = "none"           # none | writeback | readonly
    hit_set_count: int = 4
    hit_set_period: float = 60.0
    target_max_objects: int = 0        # agent trigger; 0 = no agent

    DENC_VERSION = 3                   # v2: snaps; v3: tiering

    @staticmethod
    def _denc_upgrade(fields: dict, version: int) -> dict:
        if version < 2:
            fields.setdefault("snap_seq", 0)
            fields.setdefault("removed_snaps", [])
        if version < 3:
            fields.setdefault("tier_of", -1)
            fields.setdefault("tiers", [])
            fields.setdefault("read_tier", -1)
            fields.setdefault("write_tier", -1)
            fields.setdefault("cache_mode", "none")
            fields.setdefault("hit_set_count", 4)
            fields.setdefault("hit_set_period", 60.0)
            fields.setdefault("target_max_objects", 0)
        return fields

    @property
    def is_erasure(self) -> bool:
        return self.type == ERASURE

    def raw_pg_to_pg(self, seed: int) -> int:
        return ceph_stable_mod(seed, self.pg_num, pg_num_mask(self.pg_num))


@denc_type
@dataclass
class OsdInfo:
    up: bool = False
    in_cluster: bool = False
    weight: float = 1.0                # 0..1 reweight
    addr: tuple | None = None          # public messenger addr
    heartbeat_addr: tuple | None = None

    def state_weight(self) -> int:
        """16.16 fixed-point weight for crush is_out checks."""
        if not self.in_cluster:
            return 0
        return int(self.weight * 0x10000)


@denc_type
@dataclass
class OSDMapIncremental:
    epoch: int
    new_pools: dict[int, Pool] = field(default_factory=dict)
    removed_pools: list[int] = field(default_factory=list)
    new_up: dict[int, tuple] = field(default_factory=dict)    # osd -> addr
    new_down: list[int] = field(default_factory=list)
    new_in: list[int] = field(default_factory=list)
    new_out: list[int] = field(default_factory=list)
    new_weights: dict[int, float] = field(default_factory=dict)
    new_max_osd: int | None = None
    new_crush: bytes | None = None            # denc-encoded CrushMap
    new_ec_profiles: dict[str, dict] = field(default_factory=dict)
    new_pg_temp: dict[PgId, list[int]] = field(default_factory=dict)
    new_pool_snap_seq: dict[int, int] = field(default_factory=dict)
    new_removed_snaps: dict[int, list] = field(default_factory=dict)
    new_mgr: tuple | None = None        # (name, addr) active mgr
    new_mds: tuple | None = None        # (name, addr) active mds
    # rank -> (name, addr) | None(remove): multi-rank FSMap deltas
    new_mds_ranks: dict[int, tuple] = field(default_factory=dict)
    # pg_temp entries with empty list = removal

    DENC_VERSION = 5    # v2: snap; v3: new_mgr; v4: new_mds; v5: ranks

    @staticmethod
    def _denc_upgrade(fields: dict, version: int) -> dict:
        if version < 2:
            fields.setdefault("new_pool_snap_seq", {})
            fields.setdefault("new_removed_snaps", {})
        if version < 3:
            fields.setdefault("new_mgr", None)
        if version < 4:
            fields.setdefault("new_mds", None)
        if version < 5:
            fields.setdefault("new_mds_ranks", {})
        return fields


@denc_type
class OSDMap:
    DENC_VERSION = 4    # v2: mgr fields; v3: mds fields; v4: mds ranks

    @staticmethod
    def _denc_upgrade(fields: dict, version: int) -> dict:
        if version < 2:
            fields.setdefault("mgr_name", "")
            fields.setdefault("mgr_addr", None)
        if version < 3:
            fields.setdefault("mds_name", "")
            fields.setdefault("mds_addr", None)
        if version < 4:
            fields.setdefault("mds_ranks", {})
        return fields

    def __init__(self):
        self.epoch = 0
        self.fsid = ""
        self.max_osd = 0
        self.osds: dict[int, OsdInfo] = {}
        self.pools: dict[int, Pool] = {}
        self.pool_max = -1
        self.crush = self._default_crush()
        self.ec_profiles: dict[str, dict] = {}
        self.pg_temp: dict[PgId, list[int]] = {}
        self.mgr_name: str = ""          # active mgr (MgrMap folded in)
        self.mgr_addr: tuple | None = None
        self.mds_name: str = ""          # rank-0 mds (FSMap folded in)
        self.mds_addr: tuple | None = None
        self.mds_ranks: dict[int, tuple] = {}   # rank -> (name, addr)

    @staticmethod
    def _default_crush() -> CrushMap:
        """root 'default' + rule 0 (replicated firstn over osds) — the
        vstart-style initial map; booting OSDs join the root."""
        from ..crush.map import (BUCKET_STRAW2, Rule, Step,
                                 STEP_CHOOSE_FIRSTN, STEP_EMIT, STEP_TAKE)
        m = CrushMap()
        root = m.new_bucket(BUCKET_STRAW2, 4, name="default")
        m.add_rule(Rule("replicated_rule", [
            Step(STEP_TAKE, root.id),
            Step(STEP_CHOOSE_FIRSTN, 0, 0),
            Step(STEP_EMIT)]))
        return m

    def crush_add_osd(self, osd: int, weight: float = 1.0) -> None:
        """Deterministically place a new osd under the default root."""
        if osd not in self.crush.devices:
            self.crush.add_device(osd)
        root = self.crush.bucket_by_name("default")
        if root is not None and osd not in root.items:
            root.add_item(osd, int(weight * 0x10000))

    # -- epoch advance -----------------------------------------------------

    def apply_incremental(self, inc: OSDMapIncremental) -> None:
        if inc.epoch != self.epoch + 1:
            raise ValueError(f"incremental {inc.epoch} != {self.epoch}+1")
        self.epoch = inc.epoch
        if inc.new_max_osd is not None:
            self.max_osd = inc.new_max_osd
        if inc.new_crush is not None:
            self.crush = denc.loads(inc.new_crush)
        for pid in inc.removed_pools:
            self.pools.pop(pid, None)
        for pid, pool in inc.new_pools.items():
            self.pools[pid] = pool
            self.pool_max = max(self.pool_max, pid)
        for osd, addr in inc.new_up.items():
            info = self.osds.setdefault(osd, OsdInfo())
            info.up = True
            info.in_cluster = True
            info.addr = addr
            self.max_osd = max(self.max_osd, osd + 1)
            self.crush_add_osd(osd)
        for osd in inc.new_down:
            self.osds.setdefault(osd, OsdInfo()).up = False
        for osd in inc.new_in:
            self.osds.setdefault(osd, OsdInfo()).in_cluster = True
        for osd in inc.new_out:
            self.osds.setdefault(osd, OsdInfo()).in_cluster = False
        for osd, wgt in inc.new_weights.items():
            self.osds.setdefault(osd, OsdInfo()).weight = wgt
        if inc.new_mgr is not None:
            self.mgr_name, self.mgr_addr = inc.new_mgr
        if inc.new_mds is not None:
            self.mds_name, self.mds_addr = inc.new_mds
        for rank, ent in inc.new_mds_ranks.items():
            if ent is None:
                self.mds_ranks.pop(rank, None)
                if rank == 0:
                    # a pruned rank 0 must not leave the legacy
                    # single-mds pointer routing to the dead address
                    self.mds_name, self.mds_addr = "", None
            else:
                self.mds_ranks[rank] = (ent[0], tuple(ent[1]))
                if rank == 0:
                    self.mds_name, self.mds_addr = ent[0], tuple(ent[1])
        for pool_id, seq in inc.new_pool_snap_seq.items():
            if pool_id in self.pools:
                self.pools[pool_id].snap_seq = seq
        for pool_id, snaps in inc.new_removed_snaps.items():
            if pool_id in self.pools:
                cur = set(self.pools[pool_id].removed_snaps)
                cur.update(snaps)
                self.pools[pool_id].removed_snaps = sorted(cur)
        for pname, prof in inc.new_ec_profiles.items():
            if prof is None:
                self.ec_profiles.pop(pname, None)   # tombstone
            else:
                self.ec_profiles[pname] = prof
        for pgid, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pgid] = osds
            else:
                self.pg_temp.pop(pgid, None)

    # -- queries -----------------------------------------------------------

    def is_up(self, osd: int) -> bool:
        info = self.osds.get(osd)
        return bool(info and info.up)

    def is_in(self, osd: int) -> bool:
        info = self.osds.get(osd)
        return bool(info and info.in_cluster)

    def get_addr(self, osd: int):
        info = self.osds.get(osd)
        return info.addr if info else None

    def pool_by_name(self, name: str) -> Pool | None:
        for p in self.pools.values():
            if p.name == name:
                return p
        return None

    # -- placement ---------------------------------------------------------

    def object_to_pg(self, pool_id: int, objname: str) -> PgId:
        pool = self.pools[pool_id]
        raw = rjenkins_hash(objname.encode())
        return PgId(pool_id, pool.raw_pg_to_pg(raw))

    def _weight_map(self) -> dict[int, int]:
        wm = {}
        for osd in self.crush.devices:
            info = self.osds.get(osd)
            wm[osd] = info.state_weight() if info else 0
        return wm

    def pg_to_raw_osds(self, pgid: PgId) -> list[int]:
        """CRUSH mapping, ignoring up/down (OSDMap.cc:1530)."""
        pool = self.pools[pgid.pool]
        pps = crush_hash32_2(pgid.seed, pgid.pool)
        out = do_rule(self.crush, pool.crush_ruleset, pps, pool.size,
                      self._weight_map())
        return out

    def pg_to_up_acting_osds(self, pgid: PgId) -> tuple[list[int], list[int]]:
        """(up, acting): up = crush result filtered to up osds; acting =
        pg_temp override if present, else up (OSDMap.cc:1702)."""
        raw = self.pg_to_raw_osds(pgid)
        pool = self.pools[pgid.pool]
        if pool.is_erasure:
            # positions matter: keep holes as ITEM_NONE
            up = [o if (o != ITEM_NONE and self.is_up(o)) else ITEM_NONE
                  for o in raw]
        else:
            up = [o for o in raw if o != ITEM_NONE and self.is_up(o)]
        acting = self.pg_temp.get(pgid, up)
        return up, acting

    def pg_primary(self, pgid: PgId) -> int | None:
        _, acting = self.pg_to_up_acting_osds(pgid)
        for o in acting:
            if o != ITEM_NONE and self.is_up(o):
                return o
        return None

    def all_pgs(self) -> list[PgId]:
        return [PgId(pid, s) for pid, pool in sorted(self.pools.items())
                for s in range(pool.pg_num)]

    # -- serialization -----------------------------------------------------

    def encode(self) -> bytes:
        return denc.dumps(self)

    @staticmethod
    def decode(data: bytes) -> "OSDMap":
        m = denc.loads(data)
        if not isinstance(m, OSDMap):
            raise denc.DencError("not an OSDMap")
        return m
