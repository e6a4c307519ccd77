"""A ceph_tpu_torch cluster stores what a ceph_tpu cluster stores, on the
CPU.

The same seeded payloads (mixed sizes, ragged tails, one append) go into
a ceph_tpu cluster and a ceph_tpu_torch cluster, each 1 mon and 6
MemStore OSDs with an EC pool k=4 m=2: every (oid, shard) file and its
HashInfo xattr must be byte-identical between the two.  Each package's
librados client then reads the other cluster's objects over the wire,
bit-exact.
"""

import importlib
import time

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline

PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": 4, "m": 2}
K, M = 4, 2
SIZES = (1, 4095, 4096, 16384, 16385, 100_001, 3 * 16384 + 5,
         (256 << 10) + 777)
APPEND = ("obj5", 12_345)
HINFO_KEY = "_hinfo"


def _payloads() -> dict:
    rng = np.random.default_rng(20261017)
    return {f"obj{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for i, n in enumerate(SIZES)}


def _start(pkg: str):
    MiniCluster = importlib.import_module(f"{pkg}.vstart").MiniCluster
    c = MiniCluster(num_mons=1, num_osds=K + M).start()
    r = c.client()
    r.create_ec_pool("ecpool", "k4m2", PROFILE, pg_num=8)
    c.wait_for_clean(60)
    return c


def _fill(cluster, payloads: dict, delta: bytes) -> dict:
    io = cluster.client().open_ioctx("ecpool")
    for oid, p in payloads.items():
        io.write_full(oid, p)
    io.append(APPEND[0], delta)
    want = dict(payloads)
    want[APPEND[0]] += delta
    for oid, p in want.items():
        assert io.read(oid) == p, oid
    return want


def _shard_files(cluster, oids) -> dict:
    """(oid, shard) -> (file bytes, HashInfo xattr bytes), read from the
    holders' stores through the cluster's own map."""
    io = cluster.client().open_ioctx("ecpool")
    m = cluster.leader().osdmon.osdmap
    out = {}
    end = time.time() + 30
    for oid in oids:
        pgid = m.object_to_pg(io.pool_id, oid)
        _up, acting = m.pg_to_up_acting_osds(pgid)
        for shard, holder in enumerate(acting):
            store = cluster.osds[holder].store
            name = f"{oid}.s{shard}"
            while True:        # replica sub-writes land just after the ack
                try:
                    out[(oid, shard)] = (
                        bytes(store.read(f"pg_{pgid}", name)),
                        bytes(store.getattr(f"pg_{pgid}", name,
                                            HINFO_KEY)))
                    break
                except Exception:
                    assert time.time() < end, name
                    time.sleep(0.05)
    return out


@pytest.fixture(scope="module")
def clusters():
    prev = ceph_tpu_torch.set_device("cpu")
    ours = theirs = None
    try:
        theirs = _start("ceph_tpu")
        ours = _start("ceph_tpu_torch")
        yield ours, theirs
    finally:
        for c in (ours, theirs):
            if c is not None:
                c.stop()
        from ceph_tpu.ops import hbm_cache as jhbm_cache
        from ceph_tpu.ops import pipeline as jpipeline
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        jpipeline.get().stop()
        jhbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)


@pytest.fixture(scope="module")
def written(clusters):
    ours, theirs = clusters
    payloads = _payloads()
    delta = np.random.default_rng(7).integers(
        0, 256, APPEND[1], dtype=np.uint8).tobytes()
    want = _fill(theirs, payloads, delta)
    assert _fill(ours, payloads, delta) == want
    return want


def test_shard_files_and_hashinfo_are_byte_identical(clusters, written):
    from ceph_tpu_torch.utils import denc
    ours, theirs = clusters
    mine = _shard_files(ours, written)
    ref = _shard_files(theirs, written)
    assert set(mine) == set(ref) == {(o, s) for o in written
                                     for s in range(K + M)}
    for key in sorted(ref):
        assert mine[key][0] == ref[key][0], f"shard file {key}"
        assert mine[key][1] == ref[key][1], f"HashInfo of {key}"
    for oid, p in written.items():
        hinfo = denc.loads(mine[(oid, 0)][1])
        assert hinfo["size"] == len(p)


def test_reference_client_reads_the_port_cluster_over_the_wire(clusters,
                                                                written):
    """librados of either package reads the other's cluster: the
    messages, maps and op replies are the same bytes."""
    ours, theirs = clusters
    for server, pkg in ((ours, "ceph_tpu"), (theirs, "ceph_tpu_torch")):
        Rados = importlib.import_module(f"{pkg}.client").Rados
        MonMap = importlib.import_module(f"{pkg}.mon.monmap").MonMap
        monmap = MonMap(fsid=server.monmap.fsid)
        for name in server.monmap.ranks():
            monmap.add(name, tuple(server.monmap.addr_of(name)))
        client = Rados(monmap, f"client.cross_{pkg}")
        client.connect()
        try:
            io = client.open_ioctx("ecpool")
            for oid, p in written.items():
                assert io.read(oid) == p, (pkg, oid)
            io.write_full("cross", b"written by the other package")
            assert server.client().open_ioctx("ecpool").read("cross") == \
                b"written by the other package"
        finally:
            client.shutdown()
