"""The port's front doors store what the reference's store, on the CPU.

A ceph_tpu cluster and a ceph_tpu_torch cluster, each 1 mon and 6
MemStore OSDs, put a replicated writeback cache tier in front of a k=4
m=2 ``plugin=tpu`` EC base pool (the Kraken "erasure coded pool and
cache tiering" setup) and start one MDS and one RGW gateway on it.  The
same seeded S3 PUTs (SigV4, over HTTP), RBD writes (ObjectCacher on)
and CephFS file writes, ragged sizes included, go into both.  Once both
tier agents have flushed every object to the base and evicted the tier
down to its target:

- every data object's ``(oid, shard)`` file and HashInfo in the EC base
  is byte-identical between the two clusters;
- the metadata objects (bucket index, ``rbd_header.*``, the root
  directory's inode omap) are equal decoded, without their time fields;
- each package's CephFS client mounts the other package's cluster and
  reads its files, and each package's ``Image`` reads the other's image;
- on the port alone: a flush whose encode fails on the device leaves the
  object dirty in the tier until a flush on the device succeeds; the
  holder of the bucket index's shard 0 is killed, the tier is evicted
  again, and every object reads back degraded through the three doors;
  a promote whose rebuild decode fails fails the client's read with EIO
  and leaves no copy in the tier.

The tolerance is 0 bytes.
"""

import hashlib
import importlib
import time
import urllib.request
from urllib.parse import quote, urlparse

import numpy as np
import pytest

import ceph_tpu_torch
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline

K, M = 4, 2
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": K, "m": M}
BASE, HOT, META = "doors", "doors-hot", "cephfs_metadata"
TARGET_MAX_OBJECTS = 2
HINFO_KEY = "_hinfo"
ACCESS, SECRET = "AKIADOORS", "doors-secret"
BUCKET = "parity"
S3_SIZES = (1, 4095, 100_001, 600_000)
IMAGE, IMAGE_ORDER, IMAGE_SIZE = "img0", 20, 3 << 20
RBD_WRITES = ((0, 5000), (3 * 4096 + 17, 70_000), ((1 << 20) - 1000, 3000),
              (2 << 20, 1 << 20))
FS_SIZES = (1, 70_000, 300_001)
# fields that hold a wall-clock time: left out of the decoded metadata
TIME_FIELDS = {"mtime", "mtime_ns", "ctime", "created"}


def _traffic() -> dict:
    rng = np.random.default_rng(20261018)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    return {"s3": {f"key{i}": body(n) for i, n in enumerate(S3_SIZES)},
            "rbd": [(off, body(n)) for off, n in RBD_WRITES],
            "fs": {f"/file{i}": body(n) for i, n in enumerate(FS_SIZES)}}


def _image_bytes(writes) -> bytes:
    img = bytearray(IMAGE_SIZE)
    for off, data in writes:
        img[off:off + len(data)] = data
    return bytes(img)


def _s3(pkg: str, gw, method: str, path: str, data: bytes = b""):
    """One SigV4-signed request to the gateway; returns (status, headers,
    body)."""
    auth_v4 = importlib.import_module(f"{pkg}.rgw.auth_v4")
    base = f"http://127.0.0.1:{gw.port}"
    host = urlparse(base).netloc
    headers = auth_v4.sign_v4(method, path, "", {"host": host}, data,
                              ACCESS, SECRET)
    headers["Host"] = host
    req = urllib.request.Request(base + quote(path), data=data or None,
                                 method=method, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _mon(rados, cmd: dict) -> None:
    rv, out, _ = rados.mon_command(cmd)
    assert rv == 0, (cmd, rv, out)


def _start(pkg: str):
    MiniCluster = importlib.import_module(f"{pkg}.vstart").MiniCluster
    c = MiniCluster(num_mons=1, num_osds=K + M).start()
    r = c.client()
    r.create_ec_pool(BASE, "k4m2", PROFILE, pg_num=8)
    r.create_pool(HOT, pg_num=8)
    r.create_pool(META, pg_num=8)
    c.wait_for_clean(60)
    for cmd in ({"prefix": "osd tier add", "pool": BASE, "tierpool": HOT},
                {"prefix": "osd tier cache-mode", "pool": HOT,
                 "mode": "writeback"},
                {"prefix": "osd tier set-overlay", "pool": BASE,
                 "overlaypool": HOT}):
        _mon(r, cmd)
    for var, val in (("hit_set_count", "2"), ("hit_set_period", "5.0"),
                     ("target_max_objects", str(TARGET_MAX_OBJECTS))):
        _mon(r, {"prefix": "osd pool set", "pool": HOT, "var": var,
                 "val": val})
    c.start_mds("a", metadata_pool=META, data_pool=BASE)
    gw = c.start_rgw(access_key=ACCESS, secret_key=SECRET, data_pool=BASE)
    return c, gw


def _mount(pkg: str, rados, cluster):
    CephFS = importlib.import_module(f"{pkg}.fs").CephFS
    FsError = importlib.import_module(f"{pkg}.fs").FsError
    fs = CephFS(rados, data_pool=BASE, metadata_pool=META)
    end = time.time() + 60
    while True:
        try:
            return fs.mount(timeout=10.0)
        except FsError:
            assert time.time() < end, "CephFS mount"
            cluster.tick(0.5)


def _drive(pkg: str, cluster, gw, traffic) -> None:
    rbd = importlib.import_module(f"{pkg}.rbd")
    _s3(pkg, gw, "PUT", f"/{BUCKET}")
    for key, body in traffic["s3"].items():
        status, headers, _ = _s3(pkg, gw, "PUT", f"/{BUCKET}/{key}", body)
        assert status == 200
        assert headers["ETag"].strip('"') == hashlib.md5(body).hexdigest()
    io = cluster.client().open_ioctx(BASE)
    rbd.RBD(io).create(IMAGE, IMAGE_SIZE, order=IMAGE_ORDER)
    with rbd.Image(io, IMAGE, cache=True) as img:
        for off, data in traffic["rbd"]:
            img.write(off, data)
    fs = _mount(pkg, cluster.client("client.fs"), cluster)
    for path, body in traffic["fs"].items():
        f = fs.open(path, "w")
        f.write(body)
        f.close()


def _base_objects(cluster) -> dict:
    """{name: {shard: (file bytes, HashInfo bytes)}} of the EC base, read
    from every OSD's store."""
    pool = cluster.leader().osdmon.osdmap.pool_by_name(BASE).id
    out: dict = {}
    for osd in cluster.osds.values():
        for pgid in list(osd.pgs):
            if pgid.pool != pool:
                continue
            cid = f"pg_{pgid}"
            for n in osd.store.collection_list(cid):
                if n.startswith("_pgmeta") or "@" in n or ".s" not in n:
                    continue
                oid, shard = n.rsplit(".s", 1)
                out.setdefault(oid, {})[int(shard)] = (
                    bytes(osd.store.read(cid, n)),
                    bytes(osd.store.getattr(cid, n, HINFO_KEY)))
    return out


def _tier_objects(cluster) -> set:
    pool = cluster.leader().osdmon.osdmap.pool_by_name(HOT).id
    names = set()
    for osd in cluster.osds.values():
        for pgid, pg in list(osd.pgs.items()):
            if pgid.pool == pool and pg.is_primary:
                names |= {n for n in osd.store.collection_list(pg.cid)
                          if not n.startswith("_pgmeta") and "@" not in n}
    return names


def _data_oids(traffic, fs_inos) -> set:
    from ceph_tpu_torch.client.striper import object_name
    from ceph_tpu_torch.fs import data_oid as fs_oid
    from ceph_tpu_torch.rbd import data_oid as rbd_oid
    from ceph_tpu_torch.rgw import obj_soid
    oids = {object_name(obj_soid(BUCKET, k), 0) for k in traffic["s3"]}
    obj = 1 << IMAGE_ORDER
    oids |= {rbd_oid(IMAGE, n) for off, d in traffic["rbd"]
             for n in range(off // obj, (off + len(d) - 1) // obj + 1)}
    oids |= {fs_oid(ino, 0) for ino in fs_inos}
    return oids


def _settled(cluster, want: set) -> None:
    """Wait until every object in `want` sits complete in the EC base
    and the tier holds no more than its target."""
    def done():
        base = _base_objects(cluster)
        return all(len(base.get(o, ())) == K + M for o in want) and \
            len(_tier_objects(cluster)) <= TARGET_MAX_OBJECTS
    end = time.time() + 120
    while not done():
        assert time.time() < end, (
            sorted(want - set(_base_objects(cluster))),
            sorted(_tier_objects(cluster)))
        cluster.tick(0.5)


def _strip_times(v):
    if isinstance(v, dict):
        return {k: _strip_times(x) for k, x in v.items()
                if k not in TIME_FIELDS}
    if isinstance(v, list):
        return [_strip_times(x) for x in v]
    return v


def _metadata(pkg: str, cluster) -> dict:
    """The metadata objects decoded, through the cluster's librados."""
    denc = importlib.import_module(f"{pkg}.utils.denc")
    rgw = importlib.import_module(f"{pkg}.rgw")
    rbd = importlib.import_module(f"{pkg}.rbd")
    mds = importlib.import_module(f"{pkg}.fs.mds")
    r = cluster.client()
    base, meta = r.open_ioctx(BASE), r.open_ioctx(META)

    def decoded(io, oid):
        return _strip_times({k: denc.loads(v) for k, v in
                             io.get_omap(oid).items()})

    return {"bucket index": decoded(base, rgw.index_oid(BUCKET)),
            "rbd header": decoded(base, rbd.header_oid(IMAGE)),
            "root inodes": decoded(meta, mds.dir_oid(mds.ROOT_INO))}


def _stop_both() -> None:
    from ceph_tpu.ops import hbm_cache as jhbm_cache
    from ceph_tpu.ops import pipeline as jpipeline
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()


@pytest.fixture(scope="module")
def clusters():
    prev = ceph_tpu_torch.set_device("cpu")
    started = {}
    try:
        started["ceph_tpu"] = _start("ceph_tpu")
        started["ceph_tpu_torch"] = _start("ceph_tpu_torch")
        yield started
    finally:
        for c, _gw in started.values():
            c.stop()
        _stop_both()
        ceph_tpu_torch.set_device(prev)


@pytest.fixture(scope="module")
def settled(clusters):
    traffic = _traffic()
    inos = {}
    for pkg, (c, gw) in clusters.items():
        _drive(pkg, c, gw, traffic)
        end = time.time() + 60
        while True:      # the MDS writes its journal back to the dirfrag
            root = _metadata(pkg, c)["root inodes"]
            if len(root) == len(traffic["fs"]):
                break
            assert time.time() < end, (pkg, root)
            c.tick(0.5)
        inos[pkg] = sorted(e["ino"] for e in root.values())
    assert inos["ceph_tpu"] == inos["ceph_tpu_torch"]
    want = _data_oids(traffic, inos["ceph_tpu"])
    for c, _gw in clusters.values():
        _settled(c, want)
    return traffic, want


def test_base_shards_and_hashinfo_are_byte_identical(clusters, settled):
    traffic, want = settled
    ours = _base_objects(clusters["ceph_tpu_torch"][0])
    ref = _base_objects(clusters["ceph_tpu"][0])
    assert set(ours) == set(ref)
    assert want <= set(ours)
    for oid in sorted(want):
        assert set(ours[oid]) == set(range(K + M)), oid
        for shard in range(K + M):
            assert ours[oid][shard][0] == ref[oid][shard][0], (oid, shard)
            assert ours[oid][shard][1] == ref[oid][shard][1], (oid, shard)


def test_metadata_objects_are_equal_decoded(clusters, settled):
    ours = _metadata("ceph_tpu_torch", clusters["ceph_tpu_torch"][0])
    ref = _metadata("ceph_tpu", clusters["ceph_tpu"][0])
    assert ours == ref
    assert set(ours["bucket index"]) == set(settled[0]["s3"])


def test_each_package_reads_the_other_through_the_doors(clusters,
                                                        settled):
    traffic = settled[0]
    image = _image_bytes(traffic["rbd"])
    for pkg, server in (("ceph_tpu_torch", "ceph_tpu"),
                        ("ceph_tpu", "ceph_tpu_torch")):
        cluster, gw = clusters[server]
        Rados = importlib.import_module(f"{pkg}.client").Rados
        MonMap = importlib.import_module(f"{pkg}.mon.monmap").MonMap
        rbd = importlib.import_module(f"{pkg}.rbd")
        monmap = MonMap(fsid=cluster.monmap.fsid)
        for name in cluster.monmap.ranks():
            monmap.add(name, tuple(cluster.monmap.addr_of(name)))
        client = Rados(monmap, f"client.cross_{pkg}")
        client.connect()
        try:
            fs = _mount(pkg, client, cluster)
            for path, body in traffic["fs"].items():
                f = fs.open(path, "r")
                assert f.read() == body, (pkg, server, path)
                f.close()
            with rbd.Image(client.open_ioctx(BASE), IMAGE) as img:
                assert bytes(img.read(0, IMAGE_SIZE)) == image, (pkg,
                                                                 server)
            for key, body in traffic["s3"].items():
                assert _s3(pkg, gw, "GET", f"/{BUCKET}/{key}")[2] == body
        finally:
            client.shutdown()


def _fail_on_device(cluster, monkeypatch, method: str) -> list:
    """Every OSD codec's `method` raises as a failed device dispatch
    would; returns the list the calls are noted in."""
    calls = []

    def failed(*a, **k):
        calls.append(1)
        raise RuntimeError("injected device failure")

    for osd in cluster.osds.values():
        for codec in osd._ec_codecs.values():
            monkeypatch.setattr(codec, method, failed)
    return calls


def test_a_flush_that_fails_on_the_device_stays_dirty(clusters, settled,
                                                      monkeypatch):
    from ceph_tpu_torch.osd.pglog import DIRTY_KEY
    cluster = clusters["ceph_tpu_torch"][0]
    io = cluster.client().open_ioctx(BASE)
    body = np.random.default_rng(9).integers(0, 256, 70_000,
                                             dtype=np.uint8).tobytes()
    calls = _fail_on_device(cluster, monkeypatch,
                            "encode_stripes_with_crcs_async")
    io.write_full("late", body)
    end = time.time() + 60
    while len(calls) < 2:            # the agent tried, and tried again
        assert time.time() < end, "the agent never flushed"
        cluster.tick(0.5)
    assert "late" not in _base_objects(cluster)
    pool = cluster.leader().osdmon.osdmap.pool_by_name(HOT).id
    pgid = cluster.leader().osdmon.osdmap.object_to_pg(pool, "late")
    primary = cluster.osds[cluster.leader().osdmon.osdmap.pg_primary(pgid)]
    assert DIRTY_KEY in primary.store.getattrs(f"pg_{pgid}", "late")
    assert io.read("late") == body          # the tier copy is the truth
    monkeypatch.undo()
    _settled(cluster, {"late"})
    assert io.read("late") == body


def test_degraded_reads_through_the_doors_on_the_port(clusters, settled):
    traffic, want = settled
    cluster, gw = clusters["ceph_tpu_torch"]
    _settled(cluster, want)          # the cross reads promoted objects
    # the holder of shard 0 of the bucket index: its omap must still
    # reach every S3 read (writes set the omap on every shard)
    from ceph_tpu_torch.rgw import index_oid
    osdmap = cluster.leader().osdmon.osdmap
    pool = osdmap.pool_by_name(BASE).id
    victim = osdmap.pg_to_up_acting_osds(
        osdmap.object_to_pg(pool, index_oid(BUCKET)))[1][0]
    held = {n.rsplit(".s", 1)[0] for pgid in cluster.osds[victim].pgs
            if pgid.pool == pool
            for n in cluster.osds[victim].store.collection_list(
                f"pg_{pgid}")}
    assert held & want, "the victim holds no shard of the doors' data"
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    cluster.wait_for_osd_down(victim, 60.0)
    end = time.time() + 120          # every read below promotes
    while _tier_objects(cluster):
        assert time.time() < end, sorted(_tier_objects(cluster))
        cluster.tick(0.5)
    hbm_cache.get().clear()
    for key, body in traffic["s3"].items():
        status, headers, got = _s3("ceph_tpu_torch", gw, "GET",
                                   f"/{BUCKET}/{key}")
        assert got == body and headers["ETag"].strip('"') == \
            hashlib.md5(body).hexdigest()
    from ceph_tpu_torch.rbd import Image
    io = cluster.client().open_ioctx(BASE)
    with Image(io, IMAGE, cache=True) as img:
        assert bytes(img.read(0, IMAGE_SIZE)) == \
            _image_bytes(traffic["rbd"])
    fs = _mount("ceph_tpu_torch", cluster.client("client.fs2"), cluster)
    for path, body in traffic["fs"].items():
        f = fs.open(path, "r")
        assert f.read() == body, path
        assert fs.stat(path)["size"] == len(body)
        f.close()


def test_a_promote_whose_decode_fails_is_eio(clusters, settled,
                                             monkeypatch):
    from ceph_tpu_torch.client import RadosError
    traffic, want = settled
    cluster = clusters["ceph_tpu_torch"][0]
    end = time.time() + 120          # the degraded reads promoted
    while want & _tier_objects(cluster):
        assert time.time() < end, sorted(want & _tier_objects(cluster))
        cluster.tick(0.5)
    base = _base_objects(cluster)
    # an object that lost a data shard with the killed OSD: its read
    # must rebuild, on the device
    oid = next(o for o in sorted(want)
               if min(set(range(K + M)) - set(base[o]), default=K) < K)
    hbm_cache.get().clear()
    calls = _fail_on_device(cluster, monkeypatch, "decode_batch_async")
    io = cluster.client().open_ioctx(BASE)
    with pytest.raises(RadosError) as ei:
        io.read(oid)
    assert ei.value.errno == 5 and calls
    assert oid not in _tier_objects(cluster)
    monkeypatch.undo()
    assert len(io.read(oid)) > 0
