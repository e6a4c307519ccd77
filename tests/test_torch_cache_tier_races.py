"""The writeback tier's promote/evict race and re-executed reads, on the CPU.

One module cluster (1 mon, 4 MemStore OSDs, CPU lanes) holds a replicated
writeback tier ``hot`` (3 copies, target_max_objects 1 over 4 PGs: a
full agent scan evicts every clean object it may) in front of a k=2 m=1
``plugin=tpu`` EC base ``base``, and a k=2 m=1 EC pool ``ec`` with no
tier.  Each case pins one repair and fails without it:

- a read that misses the tier parks behind a promote, which installs
  the base's copy through a replicated write and re-runs the read at
  the write's commit.  A full agent scan run while that install is
  applied but not committed, or at its commit just before the read
  re-runs, evicts nothing: the promote is in flight.  A read whose
  installed copy is gone when it re-runs promotes again.  The read
  never answers ENOENT; it returns the base's bytes;
- an RBD image header read (the ``rbd.get_info`` class method) across
  such a scan or a lost copy still finds its omap key, and the image
  opens;
- the evict op refuses (EBUSY, nothing removed) a dirty object or a
  whiteout, and the agent's evict stays internal: the object still
  reads back;
- a listing of the tier pool (``rados -p <tier> ls``) lists the
  objects the tier holds: it is not a read of an object to promote;
- a degraded EC read whose service is delayed past the objecter's
  backoff (``osd_debug_inject_dispatch_delay_*``) is resent while its
  first copy is queued or running; the resend attaches to that copy, so
  the read gathers and decodes once (the pipeline's decode dispatches)
  and returns exact bytes;
- a copy the client resends while the reply is on its way back waits
  for that reply: delivered (the client's messenger acknowledged it),
  the copy runs nothing; a copy sent once the reply has arrived runs
  nothing either, and the same copy again runs anew (nothing is
  cached); a reply the link lost lets the client's next copy run at
  once.
"""

import time

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.messages import MOSDOp
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.osd.pglog import DIRTY_KEY, WHITEOUT_KEY
from ceph_tpu_torch.rbd import RBD, Image, header_oid
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.utils import faults
from ceph_tpu_torch.vstart import MiniCluster

K, M = 2, 1
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": K, "m": M,
           "host_cutover": "1"}
BASE, HOT, EC = "base", "hot", "ec"
PG_NUM = 4
SEED = 20261019
# the degraded read's service time: past the objecter's first backoff
# (objecter_backoff_base, 0.5 s), so the client resends it once
DELAY_S = 1.2
DEGRADED_BYTES = 256 << 10     # 32 stripes of 2 x 4 KiB: a device decode


def _mon(rados, cmd: dict) -> None:
    rv, out, _ = rados.mon_command(cmd)
    assert rv == 0, (cmd, rv, out)


@pytest.fixture(scope="module")
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    faults.get().reset(seed=0)
    c = MiniCluster(num_mons=1, num_osds=K + M + 1).start()
    try:
        r = c.client()
        r.create_ec_pool(BASE, "k2m1", PROFILE, pg_num=PG_NUM)
        r.create_ec_pool(EC, "k2m1", PROFILE, pg_num=PG_NUM)
        r.create_pool(HOT, pg_num=PG_NUM)
        c.wait_for_clean(60)
        for cmd in ({"prefix": "osd tier add", "pool": BASE,
                     "tierpool": HOT},
                    {"prefix": "osd tier cache-mode", "pool": HOT,
                     "mode": "writeback"},
                    {"prefix": "osd tier set-overlay", "pool": BASE,
                     "overlaypool": HOT},
                    {"prefix": "osd pool set", "pool": HOT,
                     "var": "target_max_objects", "val": "1"}):
            _mon(r, cmd)
        yield c
    finally:
        c.stop()
        faults.get().reset(seed=0)
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)


@pytest.fixture(autouse=True)
def _clean():
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


def _body(i: int, n: int = 100_003) -> bytes:
    return np.random.default_rng([SEED, i]).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _primary_pg(cluster, pool: str, oid: str):
    osdmap = cluster.leader().osdmon.osdmap
    pgid = osdmap.object_to_pg(osdmap.pool_by_name(pool).id, oid)
    return cluster.osds[osdmap.pg_primary(pgid)].pgs[pgid]


def _in_tier(cluster, oid: str) -> bool:
    pg = _primary_pg(cluster, HOT, oid)
    return pg.osd.store.exists(pg.cid, oid)


def _in_base(cluster, oid: str) -> bool:
    pg = _primary_pg(cluster, BASE, oid)
    return oid in pg.pglog.objects


def _full_scan(pg) -> None:
    """One agent tick that is a full scan (the heartbeat's every 20th):
    flushes dirty objects, evicts clean ones past the target."""
    pg._agent_tick = 19
    pg.agent_work()


def _drain(cluster, oids) -> None:
    """Until every object sits in the base and none in the tier."""
    end = time.time() + 60
    while any(_in_tier(cluster, o) or not _in_base(cluster, o)
              for o in oids):
        assert time.time() < end, [(o, _in_tier(cluster, o),
                                    _in_base(cluster, o)) for o in oids]
        for o in oids:
            _full_scan(_primary_pg(cluster, HOT, o))
        time.sleep(0.05)


@pytest.fixture
def at_install(monkeypatch):
    """arm(oid, when) acts once on the tier primary in the middle of the
    next promote of `oid`.  when="applied": a full agent scan right
    after the install's replicated write applied locally (its commit
    waits for the replicas); "committed": a full agent scan at the
    commit, before the parked op re-runs; "lost": the installed copy
    removed from the primary's store at the commit, as if anything had
    dropped it.  Returns the list each action notes `when` in."""
    orig = PG._internal_write
    armed: dict = {}
    acted: list = []

    def act(pg, oid, when):
        if when == "lost":
            pg.osd.store.apply_transaction(
                Transaction().remove(pg.cid, oid))
        else:
            _full_scan(pg)
        acted.append(when)

    def hooked(self, oid, ops, done=None):
        # a promote's install is the one internal write with a callback
        when = armed.pop(oid, None) if done is not None else None
        if when is None or when == "applied":
            orig(self, oid, ops, done)
            if when is not None:
                act(self, oid, when)
            return
        inner = done

        def at_commit(result):
            act(self, oid, when)
            inner(result)

        orig(self, oid, ops, at_commit)

    def arm(oid: str, when: str) -> list:
        armed[oid] = when
        return acted

    monkeypatch.setattr(PG, "_internal_write", hooked)
    return arm


@pytest.mark.parametrize("when", ["applied", "committed", "lost"])
def test_a_promote_evicted_before_its_read_runs_returns_the_base_bytes(
        cluster, at_install, when):
    io = cluster.client().open_ioctx(BASE)
    oid = f"race_{when}"
    body = _body(len(when))
    io.write_full(oid, body)
    _drain(cluster, [oid])
    acted = at_install(oid, when)
    assert bytes(io.read(oid)) == body
    assert acted == [when]


@pytest.mark.parametrize("when", ["committed", "lost"])
def test_an_rbd_header_read_across_an_evict_finds_its_key(
        cluster, at_install, when):
    io = cluster.client().open_ioctx(BASE)
    name = f"img_{when}"
    RBD(io).create(name, 3 << 20, order=20)
    _drain(cluster, [header_oid(name)])
    acted = at_install(header_oid(name), when)
    with Image(io, name) as img:
        assert img.stat()["size"] == 3 << 20
    assert acted == [when]


@pytest.mark.parametrize("state", ["dirty", "whiteout"])
def test_an_evict_of_a_dirty_object_is_refused(cluster, state):
    io = cluster.client().open_ioctx(BASE)
    oid = f"keep_{state}"
    body = _body(7)
    io.write_full(oid, body)
    if state == "whiteout":
        io.remove_object(oid)
    pg = _primary_pg(cluster, HOT, oid)
    results = []
    with pg.lock:        # the agent's flush cannot clear the state now
        attrs = pg.osd.store.getattrs(pg.cid, oid)
        assert DIRTY_KEY in attrs
        assert (WHITEOUT_KEY in attrs) == (state == "whiteout")
        pg._internal_write(oid, [("evict",)], results.append)
        kept = pg.osd.store.exists(pg.cid, oid)
    assert kept and results == [-16]
    if state == "dirty":
        assert bytes(io.read(oid)) == body
    else:
        with pytest.raises(Exception) as ei:
            io.read(oid)
        assert getattr(ei.value, "errno", None) == 2


def test_a_tier_pool_lists_its_own_objects(cluster):
    io = cluster.client().open_ioctx(BASE)
    io.write_full("listed", _body(13))
    hot = cluster.client().open_ioctx(HOT)
    assert "listed" in hot.list_objects()


def _decodes() -> int:
    return ec_pipeline.stats()["dev_dispatches_dec"]


def _degraded(io, oid: str, seed: int) -> bytes:
    """Write `oid`, fail its shard 1's store reads (every read then
    gathers shard 0 and the parity and decodes data row 1), and read it
    until its decode runs on a warm lane; returns its body.  The caller
    clears the fault rules."""
    body = _body(seed, DEGRADED_BYTES)
    io.write_full(oid, body)
    faults.get().store_eio("osd.*", f"{oid}.s1", 1.0)
    end = time.time() + 60
    while True:
        hbm_cache.get().clear()
        before = ec_pipeline.stats()
        assert bytes(io.read(oid)) == body
        after = ec_pipeline.stats()
        if after["dev_dispatches_dec"] - before["dev_dispatches_dec"] == 1 \
                and after["host_dispatches"] == before["host_dispatches"]:
            return body
        assert time.time() < end, (before, after)
        time.sleep(0.2)


def test_a_resent_degraded_read_decodes_once(cluster):
    io = cluster.client().open_ioctx(EC)
    oid = "slow"
    conf = cluster.conf
    try:
        body = _degraded(io, oid, 11)
        hbm_cache.get().clear()
        conf.set_val("osd_debug_inject_dispatch_delay_duration", DELAY_S)
        conf.set_val("osd_debug_inject_dispatch_delay_probability", 1.0)
        before = _decodes()
        t0 = time.perf_counter()
        got = bytes(io.read(oid))
        waited = time.perf_counter() - t0
        # a resend queued behind the first copy would run after it
        time.sleep(2 * DELAY_S)
        assert got == body
        assert waited > float(conf.objecter_backoff_base)
        assert _decodes() - before == 1
    finally:
        conf.set_val("osd_debug_inject_dispatch_delay_probability", 0.0)
        conf.set_val("osd_debug_inject_dispatch_delay_duration", 0.1)
        faults.get().clear()


def _answered(monkeypatch, oid: str) -> list:
    """(pg, conn, msg) of every client read of `oid` a PG answers from
    now on."""
    answered = []
    orig = PG._reply

    def spy(self, conn, msg, result, outdata, version=0):
        if conn is not None and msg.oid == oid and msg.ops[0][0] == "read":
            answered.append((self, conn, msg))
        return orig(self, conn, msg, result, outdata, version)

    monkeypatch.setattr(PG, "_reply", spy)
    return answered


def _queued(monkeypatch, oid: str, copies: list | None = None) -> list:
    """What PG.note_queued_read answered for each copy of a read of
    `oid` from now on (True: the copy was queued to run); the copies
    themselves go to `copies`."""
    seen = []
    orig = PG.note_queued_read

    def spy(self, conn, msg):
        got = orig(self, conn, msg)
        if msg.oid == oid:
            seen.append(got)
            if copies is not None:
                copies.append(msg)
        return got

    monkeypatch.setattr(PG, "note_queued_read", spy)
    return seen


def test_a_resend_behind_a_reply_in_transit_runs_nothing(cluster,
                                                         monkeypatch):
    """The reply is held on the link past the objecter's first backoff,
    so the client resends while it is on its way: the copy waits for
    the reply and, once the client's messenger has acknowledged it, is
    dropped.  The read decodes once."""
    io = cluster.client().open_ioctx(EC)
    oid = "trailing"
    try:
        body = _degraded(io, oid, 17)
        primary = _primary_pg(cluster, EC, oid).osd.whoami
        queued = _queued(monkeypatch, oid)
        faults.get().delay("client.*", DELAY_S, src=f"osd.{primary}")
        decodes = _decodes()
        hbm_cache.get().clear()
        t0 = time.perf_counter()
        assert bytes(io.read(oid)) == body
        assert time.perf_counter() - t0 > float(
            cluster.conf.objecter_backoff_base)
        time.sleep(2 * DELAY_S)       # a copy run again would end here
        assert False in queued, queued
        assert _decodes() - decodes == 1
    finally:
        faults.get().clear()


def test_a_resend_after_its_reply_arrived_runs_only_once_more(
        cluster, monkeypatch):
    """A copy sent once the reply reached the client's messenger runs
    nothing; the same copy again is a new read (nothing is cached)."""
    io = cluster.client().open_ioctx(EC)
    oid = "late"
    try:
        body = _degraded(io, oid, 19)
        answered = _answered(monkeypatch, oid)
        hbm_cache.get().clear()
        assert bytes(io.read(oid)) == body
        pg, conn, first = answered[-1]
        reqid = (first.src, first.tid)
        end = time.time() + 30
        while pg.osd.msgr.delivery(pg._reads[reqid]["sent"]) is not True:
            assert time.time() < end, "the reply was never acknowledged"
            time.sleep(0.05)
        resend = MOSDOp(tid=first.tid, pgid=first.pgid, oid=oid,
                        ops=first.ops, epoch=first.epoch)
        resend.src = first.src
        decodes = _decodes()
        hbm_cache.get().clear()
        pg.osd.ms_dispatch(conn, resend)
        time.sleep(1.0)
        assert _decodes() == decodes
        pg.osd.ms_dispatch(conn, resend)
        while _decodes() == decodes:
            assert time.time() < end, "the same copy did not run again"
            time.sleep(0.1)
    finally:
        faults.get().clear()


def test_a_resend_behind_a_lost_reply_runs_at_once(cluster, monkeypatch):
    """The link drops the reply (a lossy client link loses the frame):
    the client's next copy finds the reply lost and runs, and the read
    returns its bytes."""
    io = cluster.client().open_ioctx(EC)
    oid = "dropped"
    try:
        body = _degraded(io, oid, 23)
        primary = f"osd.{_primary_pg(cluster, EC, oid).osd.whoami}"
        queued = _queued(monkeypatch, oid)
        armed, dropped_at = [], []
        fs = faults.get()
        orig_drop = fs.should_drop

        def drop_once(src, dst):
            if armed and src == primary and dst.startswith("client."):
                armed.clear()
                dropped_at.append(len(queued))
                return True
            return orig_drop(src, dst)

        orig_reply = PG._reply

        def arm(self, conn, msg, result, outdata, version=0):
            # the first reply of the read, only
            if conn is not None and msg.oid == oid and \
                    msg.ops[0][0] == "read" and not dropped_at:
                armed.append(True)
            return orig_reply(self, conn, msg, result, outdata, version)

        monkeypatch.setattr(fs, "should_drop", drop_once)
        monkeypatch.setattr(PG, "_reply", arm)
        decodes = _decodes()
        hbm_cache.get().clear()
        assert bytes(io.read(oid)) == body
        # the first copy after the lost reply ran: it did not wait on it
        assert dropped_at and queued[dropped_at[0]] is True, (dropped_at,
                                                              queued)
        assert _decodes() - decodes == 2
    finally:
        faults.get().clear()


def test_a_resend_held_behind_a_reply_the_link_then_loses_runs(
        cluster, monkeypatch):
    """The reply sits on the link past the objecter's first backoff, so
    the client's copy waits on it; then the link drops it.  The waiting
    copy itself runs, and the read returns its bytes."""
    io = cluster.client().open_ioctx(EC)
    oid = "held_lost"
    try:
        body = _degraded(io, oid, 29)
        primary = f"osd.{_primary_pg(cluster, EC, oid).osd.whoami}"
        copies = []
        queued = _queued(monkeypatch, oid, copies)
        fs = faults.get()
        delay = fs.delay("client.*", DELAY_S, src=primary)
        orig_drop = fs.should_drop

        def drop_delayed(src, dst):
            if src == primary and dst.startswith("client.") and \
                    fs.clear(delay):
                return True          # the delayed frame, once
            return orig_drop(src, dst)

        monkeypatch.setattr(fs, "should_drop", drop_delayed)
        decodes = _decodes()
        hbm_cache.get().clear()
        assert bytes(io.read(oid)) == body
        held = [m for m, q in zip(copies, queued) if q is False]
        assert held, queued
        assert any(m is held[0] and q for m, q in zip(copies, queued)), \
            queued
        assert _decodes() - decodes == 2
    finally:
        faults.get().clear()

