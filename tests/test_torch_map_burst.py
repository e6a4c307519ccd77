"""A burst of osdmaps must not stall the OSDs, on the CPU.

An OSD maps every pg of the cluster to its up and acting sets at each
new map.  It used to run CRUSH for every pg of every pool at every map,
on the messenger's one thread and under the daemon's pg lock, so a burst
of maps (a script creating five profiles and five pools back to back)
held ping replies and the heartbeat tick long enough for the mon to mark
OSDs down.  `osdmap.PGMapping` keeps each pg's raw CRUSH placement from
map to map and runs CRUSH again only where the map changed its inputs.

- The property test holds the kept mapping equal to the full loop's
  (`OSDMap.pg_to_up_acting_osds` for every pg) over random sequences of
  map changes.  The port's pools have no pgp_num: a pg's seed places it.
- The count test counts the pgs each OSD places through CRUSH while it
  handles a map: none for a map that only sets a profile, exactly the
  new pool's pg_num for one that creates a pool.
- The burst test creates five profiles and five pools back to back on a
  cluster with heartbeats every 0.5 s and an 8 s grace: no OSD is marked
  down, and every pool goes clean.
- An OSD hears no ping reply while its messenger's one thread handles a
  map, however long that takes: its heartbeat tick waits for the map,
  and the map's time is credited to the peers' last replies, so it
  accuses no peer of the silence.
"""

import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import ceph_tpu_torch
from ceph_tpu_torch.crush.map import Rule, Step, STEP_CHOOSE_INDEP, \
    STEP_EMIT, STEP_TAKE
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.osdmap import (ERASURE, REPLICATED, OSDMap,
                                       OSDMapIncremental, PGMapping, PgId,
                                       Pool)
from ceph_tpu_torch.utils import denc
from ceph_tpu_torch.utils.clock import SystemClock
from ceph_tpu_torch.utils.config import Config
from ceph_tpu_torch.vstart import MiniCluster
from mon_setup_steps import MapMeter

OSDS = 6
BURST_BASE_PG_NUM = 128
BURST_CLEAN_S = 60.0


def _full(osdmap) -> dict:
    return {pgid: osdmap.pg_to_up_acting_osds(pgid)
            for pgid in osdmap.all_pgs()}


def _boot_map() -> OSDMap:
    m = OSDMap()
    m.apply_incremental(OSDMapIncremental(
        epoch=1, new_up={o: ("127.0.0.1", 6800 + o) for o in range(OSDS)}))
    return m


def _change(m: OSDMap, op: int, a: int, b: int) -> OSDMapIncremental:
    """One map change of kind `op`, its targets drawn from a and b."""
    inc = OSDMapIncremental(epoch=m.epoch + 1)
    osd = a % OSDS
    pools = sorted(m.pools)
    if op == 0 or not pools:                       # pool create
        pid = m.pool_max + 1
        if b % 2:
            crush = denc.loads(denc.dumps(m.crush))
            root = crush.bucket_by_name("default").id
            ruleno = crush.add_rule(Rule(f"ec-{pid}", [
                Step(STEP_TAKE, root), Step(STEP_CHOOSE_INDEP, 0, 0),
                Step(STEP_EMIT)], type="erasure"))
            inc.new_crush = denc.dumps(crush)
            inc.new_pools[pid] = Pool(pid, f"p{pid}", type=ERASURE,
                                      size=3, min_size=2, pg_num=1 + a % 4,
                                      crush_ruleset=ruleno)
        else:
            inc.new_pools[pid] = Pool(pid, f"p{pid}", type=REPLICATED,
                                      size=2 + b % 2, pg_num=1 + a % 4)
        return inc
    pool = m.pools[pools[b % len(pools)]]
    if op == 1:                                    # pool delete
        inc.removed_pools.append(pool.id)
    elif op == 2:                                  # pg_num growth
        grown = Pool(**{**vars(pool), "pg_num": pool.pg_num + 1 + a % 3})
        inc.new_pools[pool.id] = grown
    elif op == 3:                                  # down / up
        if m.is_up(osd):
            inc.new_down.append(osd)
        else:
            inc.new_up[osd] = ("127.0.0.1", 6900 + osd)
    elif op == 4:                                  # out / in
        (inc.new_out if m.is_in(osd) else inc.new_in).append(osd)
    elif op == 5:                                  # reweight
        inc.new_weights[osd] = (0.25, 0.5, 1.0)[b % 3]
    elif op == 6:                                  # pg_temp set / clear
        pgid = PgId(pool.id, a % pool.pg_num)
        inc.new_pg_temp[pgid] = ([] if pgid in m.pg_temp else
                                 [(a + i) % OSDS for i in range(pool.size)])
    else:                                          # CRUSH weight change
        crush = denc.loads(denc.dumps(m.crush))
        root = crush.bucket_by_name("default")
        root.remove_item(osd)
        root.add_item(osd, (1 + b % 4) * 0x4000)
        inc.new_crush = denc.dumps(crush)
    return inc


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 7), st.integers(0, 63),
                          st.integers(0, 63)), min_size=1, max_size=12))
def test_kept_mapping_equals_the_full_loop(changes):
    m = _boot_map()
    mapping = PGMapping()
    assert mapping.update(m) == _full(m)
    for op, a, b in changes:
        m.apply_incremental(_change(m, op, a, b))
        assert mapping.update(m) == _full(m), (op, a, b)


@pytest.fixture
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    c = MiniCluster(num_mons=1, num_osds=4).start()
    try:
        yield c
    finally:
        c.stop()
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)


def _command(admin, cmd: dict) -> None:
    rv, out, _ = admin.mon_command(cmd)
    assert rv == 0, (cmd, rv, out)


@pytest.fixture
def meter(cluster):
    m = MapMeter(cluster, OSDMap)
    yield m
    m.close()


def test_only_changed_pgs_go_through_crush(cluster, meter):
    admin = cluster.client()
    admin.create_pool("base", pg_num=16)
    cluster.wait_for_clean(60)

    def handled_by_all() -> int:
        epoch = cluster.leader().osdmon.osdmap.epoch
        cluster._wait(lambda: all(meter.handled.get(o, 0) >= epoch
                                  for o in cluster.osds),
                      30, "an OSD has not handled the leader's map")
        return epoch

    def per_osd(epoch) -> dict:
        return {o: meter.placed.get((o, epoch)) for o in cluster.osds}

    _command(admin, {"prefix": "osd erasure-code-profile set",
                     "name": "k2m1", "profile": [
                         "plugin=jerasure", "technique=reed_sol_van",
                         "k=2", "m=1"]})
    epoch = handled_by_all()
    assert per_osd(epoch) == {o: set() for o in cluster.osds}, \
        "a profile-only map placed pgs through CRUSH"
    for cmd, pg_num in (({"prefix": "osd pool create", "pool": "ec",
                          "pg_num": 8, "pool_type": "erasure",
                          "erasure_code_profile": "k2m1"}, 8),
                        ({"prefix": "osd pool create", "pool": "rep",
                          "pg_num": 4}, 4)):
        _command(admin, cmd)
        epoch = handled_by_all()
        pool_id = cluster.leader().osdmon.osdmap.pool_by_name(
            cmd["pool"]).id
        want = {PgId(pool_id, s) for s in range(pg_num)}
        assert per_osd(epoch) == {o: want for o in cluster.osds}, \
            f"creating {cmd['pool']} placed other pgs through CRUSH"


def test_a_burst_of_pools_marks_no_osd_down():
    prev = ceph_tpu_torch.set_device("cpu")
    # real time, as daemons in their own processes keep it: a stalled
    # thread's seconds count against the heartbeat grace
    cluster = MiniCluster(num_mons=1, num_osds=8,
                          clock=SystemClock()).start()
    try:
        admin = cluster.client()
        admin.create_pool("base", pg_num=BURST_BASE_PG_NUM)
        cluster.wait_for_clean(60)
        assert float(cluster.conf.osd_heartbeat_interval) == 0.5
        assert float(cluster.conf.osd_heartbeat_grace) == 8.0
        leader = cluster.leader()
        first = leader.osdmon.osdmap.epoch
        for i in range(5):
            _command(admin, {"prefix": "osd erasure-code-profile set",
                             "name": f"burst{i}", "profile": [
                                 "plugin=jerasure", "technique=reed_sol_van",
                                 "k=4", "m=2"]})
            _command(admin, {"prefix": "osd pool create", "pool": f"burst{i}",
                             "pg_num": 16, "pool_type": "erasure",
                             "erasure_code_profile": f"burst{i}"})
        unclean = None
        try:
            cluster.wait_for_clean(BURST_CLEAN_S)
        except TimeoutError as e:
            unclean = e
        incs = [denc.loads(b) for b in
                leader.osdmon.get_incrementals(first)]
        down = sorted({o for inc in incs for o in inc.new_down})
        assert not down, f"osds {down} marked down in the burst"
        assert unclean is None, unclean
        assert len(incs) >= 10
    finally:
        cluster.stop()
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)


def test_a_map_that_outlasts_the_grace_accuses_no_peer():
    prev = ceph_tpu_torch.set_device("cpu")
    grace, stall = 2.0, 3.0
    cluster = MiniCluster(num_mons=1, num_osds=4, clock=SystemClock(),
                          conf=Config({"mon_tick_interval": 0.5,
                                       "osd_heartbeat_interval": 0.5,
                                       "osd_heartbeat_grace": grace,
                                       "mon_osd_min_down_reporters": 2,
                                       "mon_osd_down_out_interval": 1e6})
                          ).start()
    try:
        reports = []
        for osd in cluster.osds.values():
            def report(target, silent, osd=osd, real=osd.monc.report_failure):
                reports.append((osd.whoami, target, silent))
                return real(target, silent)
            osd.monc.report_failure = report
        slow = cluster.osds[0]
        real_update = slow._pg_mapping.update

        def update(osdmap):
            time.sleep(stall)
            return real_update(osdmap)

        slow._pg_mapping.update = update
        time.sleep(2 * grace)
        assert reports == [], "peers accused before the slow map"
        _command(cluster.client(), {
            "prefix": "osd erasure-code-profile set", "name": "slow",
            "profile": ["plugin=jerasure", "k=2", "m=1"]})
        epoch = cluster.leader().osdmon.osdmap.epoch
        cluster._wait(lambda: slow.osdmap.epoch >= epoch, 30,
                      "the slow OSD never handled the map")
        time.sleep(2 * grace)
        mine = [r for r in reports if r[0] == slow.whoami]
        assert mine == [], f"its own stall read as peers' silence: {mine}"
    finally:
        cluster.stop()
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)
