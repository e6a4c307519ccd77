"""A pool created while its OSDs learn maps as full maps must go active,
on the CPU.

An OSD that instantiates a pg copy of a pool whose birth it did not
watch keeps that copy incomplete until a backfill restores it: a pool of
unknown age may hold data elsewhere.  A running OSD that learns a new
pool from a full map (a gap refetch after a lost push, a new session
after a mon hunt: under a burst of maps both happen) did watch it come
to life all the same, since the pool was not in the map it already
held.  When every member of a new pool's pgs learned it that way, the
pgs stayed incomplete for good: no copy could vote, and no backfill
could start from one.
"""

import time

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.mon.messages import MOSDMapMsg
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.vstart import MiniCluster

PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
           "k": 2, "m": 1}


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


def _maps_as_full_maps(cluster) -> None:
    """Every OSD receives each later map push as the mon's current full
    map, as a gap refetch or a new mon session delivers it."""
    for osd in cluster.osds.values():
        monc = osd.monc
        handle = monc._handle_osdmap

        def as_full(msg, handle=handle):
            if msg.full is None and msg.incrementals:
                cur = cluster.leader().osdmon.osdmap
                msg = MOSDMapMsg(full=cur.encode(), incrementals=[],
                                 epoch=cur.epoch)
            handle(msg)

        monc._handle_osdmap = as_full


def test_a_pool_born_while_osds_take_full_maps_goes_active(cluster):
    _maps_as_full_maps(cluster)
    r = cluster.client()
    r.create_ec_pool("fresh", "k2m1", PROFILE, pg_num=8)
    cluster.wait_for_clean(60)
    io = r.open_ioctx("fresh")
    body = np.random.default_rng(3).integers(
        0, 256, 100_000, dtype=np.uint8).tobytes()
    end = time.monotonic() + 30
    while True:
        try:
            io.write_full("o", body)
            break
        except Exception:
            assert time.monotonic() < end, "the new pool never took a write"
            time.sleep(0.2)
    assert io.read("o") == body
