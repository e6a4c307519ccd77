"""A copy that joins an EC pg after the pg's first interval is not
complete, on the CPU.

An OSD that watched a pool come to life keeps a fresh, empty copy of the
pool's pg complete: in the interval in which the pool was born, that is
the whole of the pg.  An OSD that was up at the pool's birth but is
mapped into the pg's acting set only later (a remap after a mark-out)
joins a pg that already took writes.  Its empty log's (0, 0) head must
not count in the EC head vote: with a hole where the third shard was, a
vote that counted it found (0, 0) held by k shards and rewound the one
copy that held every acknowledged write.

Such a copy is backfilled.  Where the pg holds an object that fewer than
k shards still hold (unfound), the backfill cannot rebuild it: the copy
completes but for that object, which enters its missing set, rather
than the whole pg being scanned again without end.
"""

import time

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.daemon import OSDDaemon
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.store.objectstore import Transaction
from ceph_tpu_torch.vstart import MiniCluster

PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": 2, "m": 1}
OBJECTS = 6


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


def _wait_until(cluster, pred, timeout: float, what: str) -> None:
    end = time.time() + timeout
    while not pred():
        assert time.time() < end, what
        cluster.tick(0.25)


def test_a_remapped_member_does_not_vote_its_empty_log(cluster,
                                                       monkeypatch):
    admin = cluster.client()
    admin.create_ec_pool("ecpool", "k2m1", PROFILE, pg_num=1)
    cluster.wait_for_clean(60)
    io = admin.open_ioctx("ecpool")
    rng = np.random.default_rng(11)
    payloads = {f"obj{i}": rng.integers(0, 256, 9000 + 100 * i,
                                        dtype=np.uint8).tobytes()
                for i in range(OBJECTS)}
    for oid, data in payloads.items():
        io.write_full(oid, data)
    osdmap = cluster.leader().osdmon.osdmap
    pgid = osdmap.object_to_pg(io.pool_id, "obj0")
    a, b, c = osdmap.pg_to_up_acting_osds(pgid)[1]
    (x,) = set(cluster.osds) - {a, b, c}
    # x was up when the pool was born, but holds no copy of the pg
    assert cluster.osds[x].witnessed_pool_birth(io.pool_id)
    assert cluster.osds[x].pgs.get(pgid) is None
    head = cluster.osds[a].get_pg(pgid).pglog.head
    assert head > (0, 0)

    votes = []
    real = PG._ec_choose_and_rewind

    def vote(self, infos):
        auth = real(self, infos)
        if self.pgid == pgid:
            votes.append((self.osd.whoami, self.interval_epoch, auth))
        return auth

    monkeypatch.setattr(PG, "_ec_choose_and_rewind", vote)
    # b and c out (up, holding their shards, but no longer mapped):
    # CRUSH maps a and x, and leaves a hole for the third shard
    cluster.mark_osd_out(b)
    cluster.mark_osd_out(c)

    def remapped():
        up, acting = cluster.osds[a].osdmap.pg_to_up_acting_osds(pgid)
        return sorted(o for o in acting if o != ITEM_NONE) == \
            sorted([a, x])

    _wait_until(cluster, remapped, 30, "the pg was not remapped to a, x")
    epoch = cluster.osds[a].osdmap.epoch
    _wait_until(cluster, lambda: any(ep >= epoch for _o, ep, _v in votes),
                30, "no head vote in the remapped interval")
    late = [auth for _o, ep, auth in votes if ep >= epoch]
    assert all(auth is None for auth in late), \
        f"the head vote chose {late}: the new member's copy voted"
    kept = cluster.osds[a].get_pg(pgid)
    assert kept.pglog.head == head, "the holder of every write rewound"
    assert set(payloads) <= set(kept.pglog.objects)
    assert not cluster.osds[x].get_pg(pgid).backfill_complete, \
        "a copy mapped in after the pg's first interval counts complete"

    # b back in: k copies hold the head again, the pg goes clean and
    # every acknowledged write reads back
    admin.mon_command({"prefix": "osd in", "id": b})
    cluster.wait_for_clean(120)
    for oid, data in payloads.items():
        assert io.read(oid) == data, oid


def test_a_remapped_member_completes_but_for_an_unfound_object(
        cluster, monkeypatch):
    admin = cluster.client()
    admin.create_ec_pool("ecpool", "k2m1", PROFILE, pg_num=1)
    cluster.wait_for_clean(60)
    io = admin.open_ioctx("ecpool")
    rng = np.random.default_rng(12)
    payloads = {f"obj{i}": rng.integers(0, 256, 9000 + 100 * i,
                                        dtype=np.uint8).tobytes()
                for i in range(OBJECTS)}
    for oid, data in payloads.items():
        io.write_full(oid, data)
    osdmap = cluster.leader().osdmon.osdmap
    pgid = osdmap.object_to_pg(io.pool_id, "obj0")
    a, b, c = osdmap.pg_to_up_acting_osds(pgid)[1]
    (x,) = set(cluster.osds) - {a, b, c}
    lost = "obj0"
    version = cluster.osds[a].get_pg(pgid).pglog.objects[lost]
    # two of its three shards gone: the primary's is left, fewer than k
    for osd, shard in ((b, 1), (c, 2)):
        cluster.osds[osd].store.apply_transaction(
            Transaction().try_remove(f"pg_{pgid}", f"{lost}.s{shard}"))
    hbm_cache.get().clear()

    passes = []
    real = OSDDaemon._backfill_round

    def backfill_round(self, pgid_, target, cursor, *a, **k):
        if pgid_ == pgid and target == x and not cursor:
            passes.append(time.time())
        return real(self, pgid_, target, cursor, *a, **k)

    monkeypatch.setattr(OSDDaemon, "_backfill_round", backfill_round)
    # c out: CRUSH maps x into c's place, and x is backfilled
    cluster.mark_osd_out(c)

    def member():
        return cluster.osds[x].pgs.get(pgid)

    _wait_until(cluster, lambda: member() is not None
                and member().backfill_complete, 60,
                "the new member's backfill never completed")
    assert member().pglog.missing == {lost: version}, \
        "the new member must hold the unfound object as missing"
    assert passes, "the new member was not backfilled"
    # the member asks for the object every couple of seconds; no ask
    # starts another pass over the pg
    done = len(passes)
    end = time.time() + 8.0
    while time.time() < end:
        cluster.tick(0.25)
    assert len(passes) == done, \
        f"{len(passes) - done} more backfill passes after completion"
    assert member().backfill_complete
    for oid, data in payloads.items():
        if oid != lost:
            assert io.read(oid) == data, oid
