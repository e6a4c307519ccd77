"""The front doors as daemon processes on the CPU, held against ceph_tpu.

A mon, k+m+1 = 4 MemStore OSDs, one MDS and one RGW gateway, each a
process started with ``python -m ceph_tpu_torch.daemons`` on the CPU
(chip_smoke.py's ``ProcCluster``, as phase 15 starts them on the card),
with phase 10's pools made through the port's ceph CLI at k=2 m=1: a
replicated writeback tier over a ``plugin=tpu`` EC base, and a CephFS
metadata pool.  Seeded S3 PUTs (SigV4, over HTTP to the RGW process), an
RBD image written with the ObjectCacher on, and CephFS files written
through the MDS process go in.  Once the tier has flushed them, every
object of the base pool is read back, and each of its shard files and
its HashInfo, read over the holder's admin socket (``dump_shard``),
equals what ``ceph_tpu``'s codec and ecutil compute for the same bytes
under ``JAX_PLATFORMS=cpu``: the tolerance is 0 bytes.  The payloads
read back through their doors, and every daemon exits 0 on SIGTERM.
Each OSD's ``ec warm`` (the shapes phase 15 warms, here a few) and
``cache drop`` admin commands answer.

Beside it, the placement phase 15 relies on: with 12 of 13 OSDs in,
CRUSH maps every PG of a k=8 m=3 pool of 64 or 32 PGs onto 11 OSDs,
whichever OSD is out; with 11 in, some PG keeps a hole, so such a pool
can never be clean.
"""

import base64
import hashlib
import itertools
import os
import sys
import time

import numpy as np

from ceph_tpu_torch.crush.map import ITEM_NONE
from ceph_tpu_torch.osd.osdmap import ERASURE, OSDMap, OsdInfo, Pool
from ceph_tpu_torch.tools import connect_from_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_MAIN = ("import sys, ceph_tpu_torch; ceph_tpu_torch.set_device('cpu'); "
            "from ceph_tpu_torch.daemons import main; main(sys.argv[1:])")
K, M, UNIT = 2, 1, 4096
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": str(K),
           "m": str(M), "host_cutover": "1"}
PG_NUM = 8
CONF = {"mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
        "osd_heartbeat_grace": 8.0, "mon_osd_min_down_reporters": 2,
        "mon_osd_down_out_interval": 1e6, "objecter_op_timeout": 60.0}
SEED = 20261020
S3_SIZES = (1, 100_001, 300_000)
IMAGE, IMAGE_BYTES, IMAGE_ORDER = "img0", 3 << 20, 20
RBD_WRITES = ((0, 5000), ((1 << 20) - 1000, 3000), (2 << 20, 1 << 20))
FS_SIZES = (70_000, 300_001)
TIMEOUT = 60.0


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _bodies() -> dict:
    rng = np.random.default_rng(SEED)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    return {"s3": [body(n) for n in S3_SIZES],
            "rbd": [(off, body(n)) for off, n in RBD_WRITES],
            "fs": [body(n) for n in FS_SIZES]}


def _oracle(payload: bytes) -> dict:
    """{shard: (file bytes, HashInfo)} of `payload` by ceph_tpu."""
    from ceph_tpu.erasure.registry import registry
    from ceph_tpu.osd import ecutil
    codec = registry.factory("tpu", {k: v for k, v in PROFILE.items()
                                     if k != "plugin"})
    sinfo = ecutil.StripeInfo(K, UNIT)
    shards, stripe_crcs = ecutil.encode_object_ex(codec, sinfo, payload)
    crcs = ecutil.fold_shard_crcs(stripe_crcs, UNIT)
    prefix = ecutil.fold_shard_crcs(stripe_crcs, UNIT,
                                    upto=len(payload) // sinfo.stripe_width)
    return {s: (bytes(shards[s]), {"size": len(payload), "crc": crcs[s],
                                   "crc_prefix": prefix[s], "shard": s,
                                   "stripe_unit": UNIT})
            for s in range(K + M)}


def _shards(cs, cluster, osdmap, base_id: int, oid: str) -> dict:
    """{shard: (file bytes, HashInfo)} of `oid` as its holders keep it."""
    from ceph_tpu_torch.utils.admin_socket import admin_command
    pgid = osdmap.object_to_pg(base_id, oid)
    out = {}
    for shard, holder in enumerate(osdmap.pg_to_up_acting_osds(pgid)[1]):
        got = admin_command(cluster.asok(f"osd.{holder}"), {
            "prefix": "dump_shard", "pgid": str(pgid),
            "oid": f"{oid}.s{shard}", "data": True})
        if "error" in got:
            return {}
        data = base64.b64decode(got["data"])
        assert hashlib.sha256(data).hexdigest() == got["sha256"]
        out[shard] = (data, got["hinfo"])
    return out


def _drive(cs, cluster, port: int, bodies: dict) -> set:
    """Every door writes its payload; returns the names of the RADOS
    data objects they stripe it into."""
    from ceph_tpu_torch.client.striper import object_name
    from ceph_tpu_torch.fs import CephFS, FsError
    from ceph_tpu_torch.fs import data_oid as fs_oid
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd import data_oid as rbd_oid
    from ceph_tpu_torch.rgw import obj_soid
    obj = 1 << IMAGE_ORDER
    names = {object_name(obj_soid(cs.DOORS_BUCKET, f"key{i}"), 0)
             for i in range(len(bodies["s3"]))}
    names |= {rbd_oid(IMAGE, n) for off, d in bodies["rbd"]
              for n in range(off // obj, (off + len(d) - 1) // obj + 1)}
    cs.s3_request(port, "PUT", f"/{cs.DOORS_BUCKET}")
    for i, body in enumerate(bodies["s3"]):
        headers, _ = cs.s3_request(port, "PUT", f"/{cs.DOORS_BUCKET}/key{i}",
                                   body)
        assert cs.etag_of(headers) == hashlib.md5(body).hexdigest()
    rados = connect_from_conf(cluster.conf_path, "client.doors")
    try:
        io = rados.open_ioctx(cs.DOORS_POOL)
        RBD(io).create(IMAGE, IMAGE_BYTES, order=IMAGE_ORDER)
        with Image(io, IMAGE, cache=True) as img:
            for off, data in bodies["rbd"]:
                img.write(off, data)
        fs = CephFS(rados, data_pool=cs.DOORS_POOL,
                    metadata_pool=cs.DOORS_META)
        end = time.monotonic() + TIMEOUT
        while True:
            try:
                fs.mount(timeout=10.0)
                break
            except FsError:
                assert time.monotonic() < end, "CephFS mount"
        for i, body in enumerate(bodies["fs"]):
            f = fs.open(f"/file{i}", "w")
            f.write(body)
            f.close()
            names.add(fs_oid(f.ino, 0))
    finally:
        rados.shutdown()
    return names


def _read_back(cs, cluster, port: int, bodies: dict) -> None:
    """Each payload through its own door, byte for byte."""
    from ceph_tpu_torch.fs import CephFS
    from ceph_tpu_torch.rbd import Image
    for i, body in enumerate(bodies["s3"]):
        headers, got = cs.s3_request(port, "GET",
                                     f"/{cs.DOORS_BUCKET}/key{i}")
        assert got == body
        assert cs.etag_of(headers) == hashlib.md5(body).hexdigest()
    image = bytearray(IMAGE_BYTES)
    for off, data in bodies["rbd"]:
        image[off:off + len(data)] = data
    rados = connect_from_conf(cluster.conf_path, "client.reader")
    try:
        with Image(rados.open_ioctx(cs.DOORS_POOL), IMAGE) as img:
            assert bytes(img.read(0, IMAGE_BYTES)) == bytes(image)
        fs = CephFS(rados, data_pool=cs.DOORS_POOL,
                    metadata_pool=cs.DOORS_META)
        fs.mount(timeout=10.0)
        for i, body in enumerate(bodies["fs"]):
            f = fs.open(f"/file{i}", "r")
            assert f.read() == body
            f.close()
    finally:
        rados.shutdown()


def test_the_doors_as_processes_store_what_ceph_tpu_computes(tmp_path):
    from ceph_tpu.ops import pipeline as jpipeline
    cs = _chip_smoke()
    cluster = cs.ProcCluster(str(tmp_path), 1, K + M + 1, CONF,
                             main=("-c", CPU_MAIN), env=_env(), mgr=False)
    bodies = _bodies()
    try:
        cluster.start(timeout=120.0)
        cs.doors_pools_cli(cluster, "k2m1-doors", PROFILE, PG_NUM, PG_NUM, {
            "target_max_objects": "2", "hit_set_count": "2",
            "hit_set_period": "5.0"})
        osds = list(range(K + M + 1))
        warm = cs.osds_command(cluster, osds, {
            "prefix": "ec warm", "pool": cs.DOORS_POOL, "stripes": [1, 2],
            "scrub_sizes": [UNIT]})
        # one CPU lane: 2 batches x (the encode + the m=1 decode), and
        # the CRC at 1..64 rows of one size
        assert [a["shapes"] for a in warm.values()] == [2 * 2 + 7] * len(osds)
        port = cs.free_port()
        boot = cs.start_doors_daemons(cluster, port, None)
        assert set(boot) >= {"mds.a_boot_s", "rgw_boot_s"}
        data_objects = _drive(cs, cluster, port, bodies)
        base = cluster.admin.open_ioctx(cs.DOORS_POOL)
        base_id = base.pool_id
        end = time.monotonic() + TIMEOUT
        while True:        # the tier agent flushes each object to the base
            names = base.list_objects()
            osdmap = cluster.osdmap()
            stored = {oid: _shards(cs, cluster, osdmap, base_id, oid)
                      for oid in names}
            if data_objects <= set(names) and all(
                    len(s) == K + M for s in stored.values()):
                payloads = {oid: bytes(base.read(oid)) for oid in names}
                if all(stored[o] == _oracle(payloads[o]) for o in names):
                    break
            assert time.monotonic() < end, sorted(names)
            time.sleep(0.5)
        jpipeline.get().stop()
        dropped = cs.osds_command(cluster, osds, {"prefix": "cache drop"})
        assert all("dropped" in a for a in dropped.values())
        _read_back(cs, cluster, port, bodies)
        codes = cluster.stop()
    finally:
        cluster.close()
    assert set(codes) == set(cluster.procs), codes
    assert all(rc == 0 for rc in codes.values()), codes


def _holes(outs) -> int:
    """PGs of a k=8 m=3 pool of 64 and one of 32 PGs that CRUSH leaves
    with a hole when the OSDs in `outs` of 13 are out."""
    m = OSDMap()
    for i in range(13):
        m.crush_add_osd(i)
        m.osds[i] = OsdInfo(up=i not in outs, in_cluster=i not in outs)
    for pid, pg_num in ((1, 64), (2, 32)):
        rule = m.crush.make_erasure_rule(f"ec-{pid}", 8, 3)
        m.pools[pid] = Pool(id=pid, name=f"p{pid}", type=ERASURE, size=11,
                            min_size=9, pg_num=pg_num, crush_ruleset=rule)
    return sum(ITEM_NONE in m.pg_to_up_acting_osds(pg)[1]
               for pg in m.all_pgs())


def test_twelve_osds_in_map_a_k8m3_pool_whole():
    assert [_holes((out,)) for out in range(13)] == [0] * 13


def test_eleven_osds_in_leave_a_k8m3_pool_a_hole():
    assert any(_holes(outs) for outs in itertools.combinations(range(13), 2))
