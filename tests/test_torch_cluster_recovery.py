"""Recovery drills of a ceph_tpu_torch cluster on the CPU.

Each case pins one fault of the OSD code the port carried over from
ceph_tpu and repaired, and fails at the carried-over behaviour:

- an EC primary whose peering round heard only "unknown" (the map had
  not reached its peers) must re-peer and go active;
- the EC head vote must not rewind a head that the shards which did not
  answer could still bring to k holders (a copy new to the pg votes its
  empty log as complete);
- a client connection reset must not wait on a pg lock (an EC read may
  hold it across a peer RPC whose reply only the messenger delivers);
- an EC shard sub-read must be served while the holder's op shard for
  that pg is busy;
- a device failure in a read's decode fails the read with EIO, never
  reads as a missing object;
- an EC read of an object whose write has its shards applied on some
  holders and not yet on others waits for the write, and never decodes
  the two generations into one payload;
- an EC object's omap sits on every shard, and its xattrs and omap read
  from a shard file the primary holds under another role (a member
  going down moves the roles) instead of failing or reading empty;
- the EC shard-role audit after a mark-out repeats until every member
  holds every object, through a shard scan that timed out and a rebuild
  push that was lost; the cluster is not clean before that;
- a rebuilt EC shard carries the object's user xattrs and omap, so
  once the holder of shard 0 is marked out they still read back;
- a primary that rewinds a divergent entry never mints its version
  again: a replica that applied the rewound write late holds a log
  entry at that version, and would ack the next write there as a resend
  without applying it;
- an EC read of an object the primary's log holds, whose shard
  gather fell short (peers slower than the sub-read window under load),
  answers EAGAIN and the client resends; it never answers ENOENT, which
  tells the client an acknowledged object does not exist;
- a new interval drops the catch-up a primary began in the last one,
  whose poll ends without clearing it: the pg must not stay unclean.

One module cluster (1 mon, 5 MemStore OSDs, CPU lanes, an EC pool k=2
m=1); the cases run in file order and the two OSD kills come last.
"""

import threading
import time
import types

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.client import RadosError
from ceph_tpu_torch.ops import gf, hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.daemon import OSDDaemon
from ceph_tpu_torch.osd.messages import MPGPush
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.utils import faults
from ceph_tpu_torch.vstart import MiniCluster

K, M, UNIT = 2, 1, 4096
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": K, "m": M}


@pytest.fixture(scope="module")
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    faults.get().reset(seed=0)
    c = MiniCluster(num_mons=1, num_osds=5).start()
    c.client().create_ec_pool("ecpool", "k2m1", PROFILE, pg_num=8)
    c.wait_for_clean(60)
    yield c
    c.stop()
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


@pytest.fixture(autouse=True)
def _clean():
    from ceph_tpu.ops import hbm_cache as jhbm_cache
    from ceph_tpu.ops import pipeline as jpipeline
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


@pytest.fixture(scope="module")
def io(cluster):
    return cluster.client().open_ioctx("ecpool")


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _acting(cluster, pool_id, oid):
    m = cluster.leader().osdmon.osdmap
    pgid = m.object_to_pg(pool_id, oid)
    return pgid, m.pg_to_up_acting_osds(pgid)[1]


def _shards(payload: bytes) -> list[bytes]:
    """The k+m shard files of `payload`: numpy GF(2^8) encode."""
    W = K * UNIT
    S = -(-len(payload) // W)
    buf = np.zeros(S * W, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    stripes = buf.reshape(S, K, UNIT)
    mat = gf.reed_sol_van_matrix(K, M)
    parity = np.stack([gf.encode_np(mat, s) for s in stripes])
    chunks = np.concatenate([stripes, parity], axis=1)
    return [chunks[:, s].tobytes() for s in range(K + M)]


def _wait_until(cluster, pred, timeout: float, what: str) -> None:
    end = time.time() + timeout
    while not pred():
        assert time.time() < end, what
        cluster.tick(0.25)


def test_incomplete_ec_peering_round_is_retried(cluster, io):
    """An EC primary with a complete copy of its own runs a peering
    round in which every peer answers "unknown" (the map has not reached
    them): fewer than k shards are known and the pg stays inactive.  No
    map change follows, so only the heartbeat's re-peer of the
    incomplete pg brings it active again."""
    payload = _payload(1, 3 * K * UNIT)
    io.write_full("pobj", payload)
    pgid, acting = _acting(cluster, io.pool_id, "pobj")
    pg = cluster.osds[acting[0]].get_pg(pgid)
    assert pg.backfill_complete and not pg.pglog.missing
    with pg.lock:
        pg.active = False
    pg._peering_done({o: {"last_update": (0, 0), "log_tail": (0, 0),
                          "unknown": True} for o in acting[1:]},
                     pg.interval_epoch)
    assert not pg.active
    _wait_until(cluster, lambda: pg.active, 20,
                "the incomplete pg was never re-peered")
    assert io.read("pobj") == payload


def test_ec_head_vote_does_not_rewind_past_unheard_shards(cluster, io):
    """The primary holds an object's newest write; one peer did not
    answer and the other is a copy new to the pg, at (0, 0).  Fewer than
    k known shards hold the head, but with the unheard one k may: the
    write may have been acked, so the vote leaves the pg incomplete
    instead of rewinding it."""
    payload = _payload(4, 2 * K * UNIT)
    io.write_full("vobj", payload)
    pgid, acting = _acting(cluster, io.pool_id, "vobj")
    pg = cluster.osds[acting[0]].get_pg(pgid)
    head = pg.pglog.head
    assert head > (0, 0)
    auth = pg._ec_choose_and_rewind({
        acting[1]: {"last_update": (0, 0), "log_tail": (0, 0),
                    "unknown": True, "unreachable": True},
        acting[2]: {"last_update": (0, 0), "log_tail": (0, 0)}})
    assert auth is None
    assert pg.pglog.head == head and "vobj" in pg.pglog.objects
    assert io.read("vobj") == payload


def test_client_reset_does_not_wait_on_a_held_pg_lock(cluster, io):
    """ms_handle_reset runs on the messenger thread: with a pg's lock
    held elsewhere it returns at once, and the watch cleanup runs on the
    pg's op shard once the lock is free."""
    watcher = cluster.client("client.watcher").open_ioctx("ecpool")
    io.write_full("wobj", b"watched")
    watcher.watch("wobj", lambda nid, payload: b"")
    pgid, acting = _acting(cluster, io.pool_id, "wobj")
    osd = cluster.osds[acting[0]]
    pg = osd.get_pg(pgid)
    entity = next(iter(pg.watchers["wobj"]))[0]
    conn = types.SimpleNamespace(peer_name=entity)
    with pg.lock:
        t = threading.Thread(target=osd.ms_handle_reset, args=(conn,))
        t.start()
        t.join(timeout=3.0)
        returned = not t.is_alive()
    t.join(timeout=30.0)
    assert returned, "ms_handle_reset waited on a pg lock"
    assert not t.is_alive()
    _wait_until(cluster, lambda: "wobj" not in pg.watchers, 20,
                "the reset client's watch was not removed")


def test_ec_sub_read_is_served_while_the_op_shard_is_busy(cluster, io,
                                                          monkeypatch):
    """The holder of data shard 1 has its op shard for the pg blocked;
    the primary's read still gets that shard's sub-read answered."""
    payload = _payload(2, 3 * K * UNIT)
    io.write_full("sobj", payload)
    pgid, acting = _acting(cluster, io.pool_id, "sobj")
    holder = cluster.osds[acting[1]]
    hbm_cache.get().clear()
    served = []
    real = PG.handle_ec_sub_read

    def note(self, conn, msg):
        if self.osd.whoami == holder.whoami and self.pgid == pgid:
            served.append(gate.is_set())
        return real(self, conn, msg)

    monkeypatch.setattr(PG, "handle_ec_sub_read", note)
    gate = threading.Event()
    holder.op_wq.queue(pgid, gate.wait, 30.0)
    out = []
    reader = threading.Thread(target=lambda: out.append(io.read("sobj")))
    try:
        reader.start()
        end = time.time() + 5.0
        while not served and time.time() < end:
            time.sleep(0.05)
        assert served and served[0] is False, \
            "the shard sub-read waited behind the busy op shard"
    finally:
        gate.set()
        reader.join(timeout=60)
    assert out == [payload]


def test_decode_device_error_fails_the_read_with_eio(cluster, io,
                                                     monkeypatch):
    """A read whose data shard is gone must decode; when the decode's
    device dispatch raises, the client gets EIO (the error is not read
    as a missing object)."""
    payload = _payload(3, 2 * K * UNIT)
    io.write_full("dobj", payload)
    pgid, acting = _acting(cluster, io.pool_id, "dobj")
    cluster.osds[acting[1]].store.apply_transaction(
        Transaction().try_remove(f"pg_{pgid}", "dobj.s1"))
    hbm_cache.get().clear()
    primary = cluster.osds[acting[0]]
    codec = primary.get_ec_codec(primary.osdmap.pools[io.pool_id])
    calls = []

    def device_lost(*a, **k):
        calls.append(1)
        raise RuntimeError("injected device failure in the decode")

    monkeypatch.setattr(codec, "decode_batch_async", device_lost)
    with pytest.raises(RadosError) as ei:
        io.read("dobj")
    assert ei.value.errno == 5 and calls
    monkeypatch.undo()
    assert io.read("dobj") == payload
    # the module's cluster goes on: a later test's OSD death could take
    # a second shard of this one before the role audit rebuilds the
    # first, and an unfound object's pg never reads clean again
    io.remove_object("dobj")


def test_read_behind_a_gathering_write_waits_for_it(cluster, io,
                                                    monkeypatch):
    """The primary has applied its shard of a new write while the
    sub-writes to the other holders are held back.  A read of the object
    then must not gather the primary's new shard beside the old ones:
    it waits, and once the sub-writes go out it returns the new bytes."""
    v1, v2 = _payload(5, 2 * K * UNIT), _payload(6, 2 * K * UNIT)
    io.write_full("gobj", v1)
    pgid, acting = _acting(cluster, io.pool_id, "gobj")
    primary = cluster.osds[acting[0]]
    pg = primary.get_pg(pgid)
    held = []
    real_send = OSDDaemon.send_osd

    def hold(self, osd_id, msg):
        if self is primary and getattr(msg, "pgid", None) == str(pgid) \
                and type(msg).__name__ == "MOSDECSubOpWrite":
            held.append((osd_id, msg))
            return
        return real_send(self, osd_id, msg)

    cap = hbm_cache.get().capacity
    hbm_cache.configure(0)          # every read gathers shards
    monkeypatch.setattr(OSDDaemon, "send_osd", hold)
    head = pg.pglog.objects["gobj"]
    writer = threading.Thread(target=io.write_full, args=("gobj", v2))
    out = []
    reader = threading.Thread(target=lambda: out.append(io.read("gobj")))
    try:
        writer.start()
        end = time.time() + 20
        while pg.pglog.objects.get("gobj") == head or len(held) < K:
            assert time.time() < end, "the write never reached its gather"
            time.sleep(0.02)
        reader.start()
        reader.join(timeout=2.0)
        assert out in ([], [v2]), "the read decoded two generations"
        assert out == [], "the read did not wait for the write"
    finally:
        monkeypatch.undo()
        for osd_id, msg in held:
            primary.send_osd(osd_id, msg)
        writer.join(timeout=60)
        reader.join(timeout=60)
        hbm_cache.configure(cap)
    assert out == [v2]
    assert io.read("gobj") == v2


def test_xattrs_and_omap_read_from_a_shard_under_another_role(cluster, io):
    """Every shard holder keeps the object's omap.  The primary's shard
    file is then moved to another role's name, as when a member going
    down shifts the roles before the audit moves the files: the xattr
    and the omap still read back through librados, and the data
    decodes from the peers."""
    payload = _payload(7, 2 * K * UNIT + 99)
    io.write_full("xobj", payload)
    io.set_xattr("xobj", "tag", b"xattr value")
    io.set_omap("xobj", {"key": b"omap value"})
    pgid, acting = _acting(cluster, io.pool_id, "xobj")
    cid = f"pg_{pgid}"
    for shard, holder in enumerate(acting):
        assert cluster.osds[holder].store.omap_get(
            cid, f"xobj.s{shard}") == {"key": b"omap value"}, shard
    store = cluster.osds[acting[0]].store
    other = f"xobj.s{K + M - 1}"
    store.apply_transaction(Transaction().clone(cid, "xobj.s0", other)
                            .remove(cid, "xobj.s0"))
    hbm_cache.get().clear()
    try:
        assert io.get_xattr("xobj", "tag") == b"xattr value"
        assert io.get_omap("xobj") == {"key": b"omap value"}
        assert io.read("xobj") == payload
    finally:
        store.apply_transaction(Transaction().clone(cid, other, "xobj.s0")
                                .remove(cid, other))


def test_omap_comes_from_a_shard_at_the_current_version(cluster, io):
    """The lowest live shard's holder has no file of the object at its
    current version (a member that lags behind a write, or whose file
    has not landed): the omap read passes it over for a holder that
    has one, and is never answered from the missing file as empty.  A
    cache-tier promote that took that empty omap installed the object
    without it (an RBD header then read as "no such image")."""
    io.write_full("mobj", _payload(8, K * UNIT + 5))
    io.set_omap("mobj", {"hdr": b"header value"})
    pgid, acting = _acting(cluster, io.pool_id, "mobj")
    cid = f"pg_{pgid}"
    store = cluster.osds[acting[0]].store
    store.apply_transaction(Transaction().clone(cid, "mobj.s0", "mobj.keep")
                            .remove(cid, "mobj.s0"))
    hbm_cache.get().clear()
    try:
        assert io.get_omap("mobj") == {"hdr": b"header value"}
    finally:
        store.apply_transaction(Transaction().clone(cid, "mobj.keep",
                                                    "mobj.s0")
                                .remove(cid, "mobj.keep"))


def test_role_audit_repeats_until_every_shard_lands(cluster, io,
                                                    monkeypatch):
    """Kill an OSD and mark it out.  The first shard scan each primary
    sends to each member times out and the first push of each rebuilt
    shard is lost; once the cluster is clean every object's shards sit
    on their current holders, the lost ones rebuilt byte for byte."""
    payloads = {f"r{i}": _payload(100 + i, K * UNIT * (1 + i % 3) + 77 * i)
                for i in range(12)}
    for oid, p in payloads.items():
        io.write_full(oid, p)
    cluster.wait_for_clean(60)
    victim = 1
    lost = {}
    for oid in payloads:
        pgid, acting = _acting(cluster, io.pool_id, oid)
        if victim in acting:
            lost[oid] = acting.index(victim)
    assert lost
    hbm_cache.get().clear()
    scans, pushes = set(), set()
    dropped = {"scans": 0, "pushes": 0}
    real_call, real_send = OSDDaemon._call_async, OSDDaemon.send_osd

    def call(self, osd_id, msg, done, timeout=5.0):
        key = (self.whoami, osd_id, msg.pgid)
        if getattr(msg, "op", None) == "shard_scan" and key not in scans:
            scans.add(key)
            dropped["scans"] += 1
            done(None)                    # as a timed-out RPC
            return
        real_call(self, osd_id, msg, done, timeout=timeout)

    def send(self, osd_id, msg):
        if isinstance(msg, MPGPush) and msg.shard is not None:
            key = (msg.pgid, msg.oid, msg.shard)
            if key not in pushes:
                pushes.add(key)
                dropped["pushes"] += 1
                return                    # lost on the wire
        real_send(self, osd_id, msg)

    monkeypatch.setattr(OSDDaemon, "_call_async", call)
    monkeypatch.setattr(OSDDaemon, "send_osd", send)
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    cluster.wait_for_osd_down(victim)
    cluster.mark_osd_out(victim)
    cluster.wait_for_clean(120)
    assert dropped["scans"] and dropped["pushes"], dropped
    absent = []
    for oid, p in payloads.items():
        pgid, acting = _acting(cluster, io.pool_id, oid)
        want = _shards(p)
        for shard, holder in enumerate(acting):
            assert holder != victim
            store = cluster.osds[holder].store
            name = f"{oid}.s{shard}"
            if name not in store.collection_list(f"pg_{pgid}"):
                absent.append((name, holder))
                continue
            assert bytes(store.read(f"pg_{pgid}", name)) == want[shard], \
                (name, holder)
    assert absent == [], f"clean with shards not rebuilt: {absent}"
    monkeypatch.undo()
    for oid, p in payloads.items():
        assert io.read(oid) == p


def test_a_short_shard_gather_is_retried_not_enoent(cluster, io,
                                                    monkeypatch):
    """The primary holds one shard of a k=2 object and fetches the rest;
    its first two gathers (the acting gather and the degraded sweep)
    come back empty, as when every peer's sub-read misses its window.
    The read must still return the object: the first try answers
    EAGAIN and the client's resend reads it."""
    payload = _payload(310, 3 * K * UNIT + 11)
    io.write_full("slowpeers", payload)
    pgid, acting = _acting(cluster, io.pool_id, "slowpeers")
    osd = cluster.osds[acting[0]]
    hbm_cache.get().clear()
    real, calls = osd.ec_fetch_shards, []

    def short(*a, **kw):
        calls.append(1)
        return {} if len(calls) <= 2 else real(*a, **kw)

    monkeypatch.setattr(osd, "ec_fetch_shards", short)
    assert io.read("slowpeers") == payload
    assert len(calls) > 2, "the gather was never short"


def test_a_new_interval_drops_the_dead_intervals_catch_up():
    """A primary that was catching up from an auth peer (its pulls in
    flight, `_catchup_pending` set) when the interval changed: the poll
    of the dead interval returns without clearing the pending set, and
    the new interval's round, in which the primary is no longer behind,
    never fetches again.  The new interval must drop the dead one's
    catch-up, or the pg never reads clean (the ledger-door drill's 240 s
    `restart_osd` timeout)."""
    c = MiniCluster(num_mons=1, num_osds=3).start()
    try:
        rados = c.client()
        rados.create_pool("catchup", pg_num=1, size=3, min_size=2)
        io = rados.open_ioctx("catchup")
        io.write_full("o", b"catch-up" * 64)
        c.wait_for_clean(60)
        pgid, acting = _acting(c, io.pool_id, "o")
        primary = c.osds[acting[0]].get_pg(pgid)
        with primary.lock:
            primary._catchup_pending = {"o": tuple(primary.pglog.head)}
            primary._catchup_polls = 0
        victim = acting[2]
        c.kill_osd(victim)
        c.mark_osd_down(victim)
        c.wait_for_osd_down(victim, 60.0)
        c.start_osd(victim)
        c.wait_for_osds(3, 60.0)
        c.wait_for_clean(30)
        assert io.read("o") == b"catch-up" * 64
    finally:
        c.stop()


def test_a_rewound_version_is_never_minted_again():
    """The primary applies a write at version v and its peering round
    rewinds it (its replicas had not applied it yet when they answered),
    in the same interval.  The write's sub-writes then land late on both
    replicas, whose logs hold an entry at v.  The next client write must
    get a version past v: at v itself each replica would take it for a
    resend, ack it and apply nothing, and the acked object would live on
    one shard of three (the pg_split drill's ENOENT)."""
    from ceph_tpu_torch.osd.backend_ec import VER_KEY
    c = MiniCluster(num_mons=1, num_osds=3).start()
    try:
        io = c.client()
        io.create_ec_pool("rewound", "k2m1", PROFILE, pg_num=1)
        io = io.open_ioctx("rewound")
        io.write_full("base", _payload(300, K * UNIT))
        c.wait_for_clean(60)
        pgid, acting = _acting(c, io.pool_id, "base")
        primary = c.osds[acting[0]].get_pg(pgid)
        replicas = [c.osds[o].get_pg(pgid) for o in acting[1:]]
        with primary.lock:
            head = primary.pglog.head
            primary.version += 1
            ghost = (primary.interval_epoch, primary.version)
            for pg in [primary] + replicas:
                entry = dict(pg.pglog.entries[-1], ev=ghost, oid="ghost",
                             op="modify", prior=None, rollback=None)
                pg._log_and_apply(Transaction(), entry)
            primary.rewind_divergent_log(head)
        payload = _payload(301, K * UNIT + 7)
        io.write_full("victim", payload)
        for shard, osd in enumerate(acting):
            pg = c.osds[osd].get_pg(pgid)
            ver = c.osds[osd].store.getattr(pg.cid, f"victim.s{shard}",
                                             VER_KEY)
            assert "victim" in pg.pglog.objects, (osd, ghost)
            assert ver == repr(tuple(pg.pglog.objects["victim"])).encode()
            assert tuple(pg.pglog.objects["victim"]) > ghost
        assert io.read("victim") == payload
    finally:
        c.stop()


def test_rebuilt_shards_carry_user_xattrs_and_omap(cluster, io):
    """Write EC objects with a user xattr and an omap, kill and mark out
    the holder of the first one's shard 0, and wait for clean: the
    rebuilt shards (local on the new primary, pushed to the others)
    carry both, so the xattr and the omap read back through librados
    and every shard file at its holder has them."""
    oids = [f"meta{i}" for i in range(6)]
    for i, oid in enumerate(oids):
        io.write_full(oid, _payload(200 + i, K * UNIT + 13 * i))
        io.set_xattr(oid, "tag", b"xattr %d" % i)
        io.set_omap(oid, {"key": b"omap %d" % i, "n": b"%d" % i})
    cluster.wait_for_clean(60)
    _pgid, acting = _acting(cluster, io.pool_id, oids[0])
    victim = acting[0]
    moved = [oid for oid in oids
             if victim in _acting(cluster, io.pool_id, oid)[1]]
    hbm_cache.get().clear()
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    cluster.wait_for_osd_down(victim)
    cluster.mark_osd_out(victim)
    cluster.wait_for_clean(120)
    for i, oid in enumerate(oids):
        omap = {"key": b"omap %d" % i, "n": b"%d" % i}
        assert io.get_xattr(oid, "tag") == b"xattr %d" % i, oid
        assert io.get_omap(oid) == omap, oid
        pgid, acting = _acting(cluster, io.pool_id, oid)
        for shard, holder in enumerate(acting):
            assert holder != victim
            store = cluster.osds[holder].store
            name = f"{oid}.s{shard}"
            assert store.getattrs(f"pg_{pgid}", name)["u.tag"] == \
                b"xattr %d" % i, (name, holder, oid in moved)
            assert store.omap_get(f"pg_{pgid}", name) == omap, \
                (name, holder, oid in moved)
