"""A ceph_tpu_torch cluster stores what a ceph_tpu cluster stores, on the
CPU.

The same seeded payloads (mixed sizes, ragged tails, one append) go into
a ceph_tpu cluster and a ceph_tpu_torch cluster, each 1 mon and 9
MemStore OSDs with an EC pool k=4 m=2 of the tpu plugin and a pool of
each of BASELINE.md configs #1-#5 under its own plugin: every (oid,
shard) file and its HashInfo xattr must be byte-identical between the
two.  Each package's librados client then reads the other cluster's
objects over the wire, bit-exact.  On the port's cluster, the OSD's
`ec warm` answers for a pool of every plugin with the device calls that
plugin's path makes, and its perf dump reports an lrc pool's routing.
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
OSDS = 9
# BASELINE.md configs #1-#5, one pool each; widths are cut only where a
# pool's chunks would not fit on 9 OSDs (a pool as wide as the cluster
# gets CRUSH holes: 8 chunks on 8 OSDs left lrc PGs incomplete)
PLUGIN_POOLS = {
    "jerasure": {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": 2, "m": 1},                       # #1 as published
    "isa": {"plugin": "isa", "technique": "reed_sol_van",
            "k": 5, "m": 3},                            # #2: k=8 cut to 5
    "cauchy": {"plugin": "jerasure", "technique": "cauchy_good",
               "packetsize": 32, "k": 5, "m": 3},       # #3: k=6 cut to 5
    "shec": {"plugin": "shec", "k": 4, "m": 3, "c": 2},  # #4: k8 m4 c3 cut
    "lrc": {"plugin": "lrc", "k": 4, "m": 2, "l": 3},   # #5 as published
}
PLUGIN_PG_NUM = 4
PLUGIN_SIZES = (1, 4096, 100_001, (256 << 10) + 777)
PLUGIN_APPEND = ("p2", 12_345)
# an lrc pool whose 16 KiB unit puts each (4, 16 KiB) stripe encode on
# the device branch, so that its routing has samples
LRC_WIDE = ("lrc16k", {**PLUGIN_POOLS["lrc"], "stripe_unit": 16384})
# `ec warm` at these batches: the kinds each pool's OSD path sends (the
# 4 KiB unit keeps every stripe of shec, lrc and the per-stripe decodes
# of the others under TorchBackend.MIN_DEVICE_BYTES, on the host)
WARM_STRIPES = [1, 2, 4, 8, 16, 32, 64]
WARM_KINDS = {"jerasure": {"bytes": 4}, "isa": {"bytes": 5},
              "cauchy": {"packets": 5}, "shec": {}, "lrc": {},
              LRC_WIDE[0]: {"bytes": 1}}
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
    c = MiniCluster(num_mons=1, num_osds=OSDS).start()
    r = c.client()
    r.create_ec_pool("ecpool", "k4m2", PROFILE, pg_num=8)
    if pkg == "ceph_tpu_torch":
        c.wait_for_clean(60)
    else:
        _wait_clean_repeering(c, 60)
    return c


def _wait_clean_repeering(cluster, timeout: float) -> None:
    """ceph_tpu's EC primary can stay inactive after an incomplete
    peering round (its known fault, which the port's heartbeat repairs:
    ROADMAP Queue 3, PR 4), in 2 of 12 setups of these pools.  Every
    10 s until clean, each inactive primary is re-peered as the port's
    heartbeat would."""
    end = time.monotonic() + timeout
    while True:
        try:
            cluster.wait_for_clean(10)
            return
        except TimeoutError:
            if time.monotonic() > end:
                raise
        for osd in cluster.osds.values():
            for pgid, pg in list(osd.pgs.items()):
                live = pg.acting_live()
                if live and live[0] == osd.whoami and not pg.active:
                    osd.queue_peering(pgid)


def _fill(cluster, payloads: dict, delta: bytes, pool: str = "ecpool",
          append: str = APPEND[0], tries: int = 1) -> dict:
    """Write, append and read back; a read that answers ENOENT is tried
    again up to `tries` times, a second apart."""
    io = cluster.client().open_ioctx(pool)
    for oid, p in payloads.items():
        io.write_full(oid, p)
    io.append(append, delta)
    want = dict(payloads)
    want[append] += delta
    for oid, p in want.items():
        for t in range(tries):
            try:
                got = io.read(oid)
                break
            except Exception as e:
                if getattr(e, "errno", None) != 2 or t == tries - 1:
                    raise
                time.sleep(1.0)
        assert got == p, oid
    return want


def _shard_files(cluster, oids, pool: str = "ecpool") -> dict:
    """(oid, shard) -> (file bytes, HashInfo xattr bytes), read from the
    holders' stores through the cluster's own map."""
    io = cluster.client().open_ioctx(pool)
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


@pytest.fixture(scope="module")
def plugin_clusters(clusters):
    """The clusters with the plugin pools beside "ecpool", each clean."""
    for c in clusters:
        r = c.client()
        for name, profile in [*PLUGIN_POOLS.items(), LRC_WIDE]:
            r.create_ec_pool(name, name, profile, pg_num=PLUGIN_PG_NUM)
    ours, theirs = clusters
    ours.wait_for_clean(60)
    _wait_clean_repeering(theirs, 60)
    return clusters


@pytest.fixture(scope="module")
def plugin_written(plugin_clusters):
    """{pool: {oid: bytes}} of the plugin pools, written alike into both
    clusters.  ceph_tpu reads an acknowledged object as ENOENT when the
    primary's shard gather falls short of what the decode needs, which
    its shec and lrc pools meet right after a write (its known fault,
    fixed in the port: ROADMAP Queue 3), so its reads are retried; the
    port's are not."""
    ours, theirs = plugin_clusters
    rng = np.random.default_rng(20261018)
    out = {}
    for pool in PLUGIN_POOLS:
        payloads = {f"p{i}": rng.integers(0, 256, n, dtype=np.uint8)
                    .tobytes() for i, n in enumerate(PLUGIN_SIZES)}
        delta = rng.integers(0, 256, PLUGIN_APPEND[1],
                             dtype=np.uint8).tobytes()
        out[pool] = _fill(theirs, payloads, delta, pool, PLUGIN_APPEND[0],
                          tries=30)
        assert _fill(ours, payloads, delta, pool,
                     PLUGIN_APPEND[0]) == out[pool]
    return out


@pytest.mark.parametrize("pool", sorted(PLUGIN_POOLS))
def test_plugin_pool_shards_and_hashinfo_are_byte_identical(
        plugin_clusters, plugin_written, pool):
    ours, theirs = plugin_clusters
    written = plugin_written[pool]
    mine = _shard_files(ours, written, pool)
    ref = _shard_files(theirs, written, pool)
    chunks = ours.osds[0].get_ec_codec(
        ours.osds[0].osdmap.pool_by_name(pool)).get_chunk_count()
    assert set(mine) == set(ref) == {(o, s) for o in written
                                     for s in range(chunks)}
    for key in sorted(ref):
        assert mine[key][0] == ref[key][0], f"shard file {key}"
        assert mine[key][1] == ref[key][1], f"HashInfo of {key}"


@pytest.mark.parametrize("pool", sorted(WARM_KINDS))
def test_ec_warm_answers_for_every_plugin(plugin_clusters, pool):
    """`ec warm` warms exactly the device calls the pool's codec makes
    on the OSD path at its unit, by kind, and nothing for a plugin whose
    path sends nothing there (shec and lrc at the 4 KiB unit)."""
    ours, _theirs = plugin_clusters
    osd = ours.osds[0]
    got = osd.asok.execute({"prefix": "ec warm", "pool": pool,
                            "stripes": WARM_STRIPES})
    assert got["kinds"] == WARM_KINDS[pool]
    assert got["shapes"] == sum(WARM_KINDS[pool].values())
    codec = osd.get_ec_codec(osd.osdmap.pool_by_name(pool))
    for s in codec.device_shapes(WARM_STRIPES, 16384 if pool ==
                                 LRC_WIDE[0] else 4096):
        assert s.backend.device_fn_if_ready(
            s.kind, s.matrix, s.extra, s.shape) is not None


def test_ec_warm_of_a_tpu_pool_warms_its_pipeline_calls(clusters):
    ours, _theirs = clusters
    osd = ours.osds[0]
    got = osd.asok.execute({"prefix": "ec warm", "pool": "ecpool",
                            "stripes": [1, 4], "scrub_sizes": [4096]})
    lanes = len(ec_pipeline.get().lane_devices())
    rows = int(osd.conf.osd_deep_scrub_stripe_batch).bit_length()
    assert got["kinds"] == {"fused": 2 * lanes, "bytes": 2 * M * lanes,
                            "crc": rows * lanes}


def test_perf_dump_reports_an_lrc_pools_routing(plugin_clusters):
    """The composed lrc matrix rides the measured router: its samples
    show in the primary's perf dump like a matrix plugin's."""
    ours, _theirs = plugin_clusters
    name, _profile = LRC_WIDE
    io = ours.client().open_ioctx(name)
    body = np.random.default_rng(5).integers(
        0, 256, 4 * 4 * 16384, dtype=np.uint8).tobytes()
    io.write_full("wide", body)
    assert io.read("wide") == body
    m = ours.leader().osdmon.osdmap
    primary = m.pg_primary(m.object_to_pg(io.pool_id, "wide"))
    routing = ours.osds[primary].asok.execute("perf dump")[
        "ec_codecs"][name]["routing"]
    assert sum(v["n"] for v in routing.values()) >= 4, routing
