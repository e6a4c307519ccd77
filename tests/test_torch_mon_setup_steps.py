"""chip_smoke.py phase 10's setup steps on an aged cluster cost the mon
no more rounds than the commands need, and the OSDs no CRUSH work beyond
the new pools, on the CPU.

On phase 9's aged cluster the tier commands had taken 62-101 s on the
card's host, against 10 s on a fresh cluster.  Counted per step with
`tests/mon_setup_steps.py`, the mon was never the cause: each step took
one osdmap epoch and one paxos commit per map-changing command, with no
election and no retry.  The time went to the OSDs, which ran CRUSH for
every pg of every pool at each new map, all of them under one GIL; what
waited on them (clean pools, the MDS's first I/O) waited that long.  The
test counts both on a cut of the same ageing: the mon's rounds per step,
and the pgs the OSDs place through CRUSH, which must be only the new
pools' pgs, on each OSD once.
"""

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.utils.config import Config
from ceph_tpu_torch.vstart import MiniCluster
from mon_setup_steps import CONF, MapMeter, age, setup_steps

OSDS, K, M, PG_NUM = 6, 2, 1, 16
DOORS_PG_NUM, META_PG_NUM = 8, 4


@pytest.fixture
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    c = MiniCluster(num_mons=3, num_osds=OSDS, conf=Config(dict(CONF)))
    c.start(timeout=120.0)
    try:
        yield c
    finally:
        c.stop()
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)


def test_setup_steps_on_an_aged_cluster(cluster):
    admin = cluster.client("client.setup")
    aged = age(cluster, admin, np.random.default_rng(3), osds=OSDS, k=K,
               m=M, pg_num=PG_NUM, objects=8, object_bytes=64 << 10)
    meter = MapMeter(cluster, OSDMap)
    try:
        steps = setup_steps(cluster, admin, meter, pg_num=DOORS_PG_NUM,
                            meta_pg_num=META_PG_NUM, k=K, m=M)
    finally:
        meter.close()
    live = OSDS - 1                       # the aged cluster's victim is out
    new_pgs = 2 * DOORS_PG_NUM + META_PG_NUM
    # map-changing commands: a profile and three pools; tier add,
    # cache-mode, set-overlay and three pool sets; the MDS's registration
    want = {"pools": (4, live * new_pgs), "tier": (6, 0), "daemons": (1, 0)}
    for name, (epochs, crush_pgs) in want.items():
        got = steps[name]
        assert got["epochs"] == epochs, (name, aged, got)
        assert got["paxos_commits"] == epochs, (name, got)
        assert got["elections"] == 0 and got["mon_retries"] == 0, \
            (name, got)
        assert got["marked_down"] == [], (name, got)
        assert got["crush_pgs"] == crush_pgs, (name, got)
