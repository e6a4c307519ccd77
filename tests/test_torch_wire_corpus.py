"""ceph_tpu_torch reads and writes ceph_tpu's formats, on the CPU.

* Wire and disk structs: the port's messages and denc structs, built
  like tests/test_wire_corpus.py:build_samples (the CephFS messages
  come with a later slice), hash to the CRCs pinned in
  tests/data/wire_corpus.json, which is read, never regenerated.
* CRUSH placement: the same OSDMap gives the same up/acting sets in
  both packages for every PG of replicated and EC pools, and a map
  encoded by one package decodes in the other with the same placement.
* FileStore interchange: an OSD directory written by one package mounts
  under the other and every object, xattr and omap entry reads back
  identical, both ways.
"""

import json
import os

import numpy as np
import pytest

from tests.test_wire_corpus import CORPUS_PATH
from tests.test_wire_corpus import build_samples as ref_build_samples

FS_MESSAGES = {"MClientRequest", "MClientReply"}


def build_samples() -> dict:
    """name -> bytes, tests/test_wire_corpus.py's samples built from the
    port's modules (without the CephFS messages)."""
    from ceph_tpu_torch.crush.map import CrushMap
    from ceph_tpu_torch.mon import messages as monm
    from ceph_tpu_torch.mon.monmap import MonMap
    from ceph_tpu_torch.osd import messages as osdm
    from ceph_tpu_torch.osd.osdmap import (OSDMap, OSDMapIncremental,
                                           OsdInfo, PgId, Pool)
    from ceph_tpu_torch.utils import denc

    samples: dict[str, bytes] = {}

    def add(name: str, obj) -> None:
        samples[name] = denc.dumps(obj)

    add("PgId", PgId(3, 7))
    add("Pool", Pool(2, "p", size=3, pg_num=16, snap_seq=5,
                     removed_snaps=[2, 3]))
    add("OsdInfo", OsdInfo(up=True, in_cluster=True, weight=0.5,
                           addr=("127.0.0.1", 6800)))
    inc = OSDMapIncremental(epoch=9)
    inc.new_up[1] = ("127.0.0.1", 6801)
    inc.new_down.append(2)
    inc.new_pool_snap_seq[0] = 4
    inc.new_mgr = ("x", ("127.0.0.1", 6900))
    add("OSDMapIncremental", inc)
    m = OSDMap()
    m.fsid = "corpus-fsid"
    m.apply_incremental(OSDMapIncremental(epoch=1))
    add("OSDMap", m)
    mm = MonMap(fsid="corpus-fsid")
    mm.add("a", ("127.0.0.1", 6789))
    add("MonMap", mm)
    add("CrushMap", CrushMap.build_flat(6, hosts=2))

    def addmsg(msg) -> None:
        samples[type(msg).__name__] = msg.encode(seq=7)

    addmsg(monm.MMonElection(op="propose", epoch=3, rank=0, quorum=[]))
    addmsg(monm.MMonPaxos(op="begin", pn=101, version=5, value=b"v",
                          last_committed=4))
    addmsg(monm.MMonSubscribe(what={"osdmap": 0}))
    addmsg(monm.MMonCommand(tid=1, cmd={"prefix": "status"}))
    addmsg(monm.MMonCommandAck(tid=1, retval=0, out="ok", data=b""))
    addmsg(monm.MOSDBoot(osd_id=0, addr=("127.0.0.1", 6800)))
    addmsg(monm.MOSDFailure(target_osd=1, failed_for=12.5))
    addmsg(monm.MOSDMapMsg(full=None, incrementals=[b"i"], epoch=2))
    addmsg(monm.MMgrBeacon(name="x", addr=("127.0.0.1", 6900)))
    addmsg(monm.MMgrReport(entity="osd.0", counters={"osd": {"op": 1}},
                           epoch=2))
    addmsg(monm.MMDSBeacon(name="a", addr=("127.0.0.1", 6901)))
    addmsg(osdm.MOSDOp(tid=4, pgid="0.1", oid="o",
                       ops=[("writefull", b"x")], epoch=2, snapc=None,
                       snapid=None))
    addmsg(osdm.MOSDOpReply(tid=4, result=0, outdata=[], version=(1, 1),
                            epoch=2))
    addmsg(osdm.MOSDRepOp(reqid=("c", 4), pgid="0.1", ops=[],
                          log={"ev": (1, 1), "oid": "o", "op": "modify",
                               "prior": None, "rollback": None,
                               "shard": None}, epoch=2))
    addmsg(osdm.MOSDRepOpReply(reqid=("c", 4), pgid="0.1", result=0))
    addmsg(osdm.MOSDECSubOpWrite(reqid=("c", 5), pgid="0.1", shard=1,
                                 ops=[], log={"ev": (1, 2), "oid": "o",
                                              "op": "modify",
                                              "prior": None,
                                              "rollback": {"type":
                                                           "stash"},
                                              "shard": 1},
                                 roll_forward_to=(1, 1), epoch=2))
    addmsg(osdm.MOSDECSubOpWriteReply(reqid=("c", 5), pgid="0.1",
                                      shard=1, result=0))
    addmsg(osdm.MOSDECSubOpRead(reqid=None, pgid="0.1", shard=1,
                                oid="o", off=0, length=0))
    addmsg(osdm.MOSDECSubOpReadReply(reqid=None, pgid="0.1", shard=1,
                                     result=0, data=b"d", hinfo=None))
    addmsg(osdm.MOSDPing(op="ping", stamp=1.0, epoch=2, pgid="0.0"))
    addmsg(osdm.MWatchNotify(oid="o", pgid="0.1", notify_id=1, cookie=2,
                             payload=b"p"))
    addmsg(osdm.MWatchNotifyAck(oid="o", pgid="0.1", notify_id=1,
                                cookie=2, reply=b"r"))
    return samples


def test_port_formats_match_the_pinned_corpus():
    from ceph_tpu_torch.ops import crc32c as crc_mod
    with open(CORPUS_PATH) as f:
        archived = json.load(f)
    samples = build_samples()
    assert set(samples) == set(archived) - FS_MESSAGES
    for name, blob in sorted(samples.items()):
        assert {"len": len(blob), "crc": crc_mod.crc32c(0, blob)} == \
            archived[name], f"wire format of {name} differs"


def test_port_samples_equal_reference_bytes_and_decode_across():
    """Byte-identical to ceph_tpu's encodings, and each package decodes
    the other's frames and structs."""
    from ceph_tpu.msg.message import Message as RefMessage
    from ceph_tpu.utils import denc as ref_denc
    from ceph_tpu_torch.msg.message import Message
    from ceph_tpu_torch.utils import denc

    ours = build_samples()
    theirs = ref_build_samples()
    for name, blob in ours.items():
        assert blob == theirs[name], name
        for decode_msg, loads in ((Message.decode, denc.loads),
                                  (RefMessage.decode, ref_denc.loads)):
            if blob[:4] == b"CTM1":
                type_id, _plen, seq = Message.parse_header(
                    blob[:Message.header_size()])
                msg = decode_msg(type_id, seq, blob[Message.header_size():])
                assert type(msg).__name__ == name
            else:
                assert type(loads(blob)).__name__ in (name, "tuple")


# -- CRUSH placement ----------------------------------------------------------

def _osdmap(pkg: str, n_osds: int = 10, down=(), out=()):
    """A map with `n_osds` OSDs, a replicated pool (size 3) and two EC
    pools (k=4 m=2 and k=8 m=3), built through `pkg`'s own classes."""
    import importlib
    osdmap = importlib.import_module(f"{pkg}.osd.osdmap")
    denc = importlib.import_module(f"{pkg}.utils.denc")
    m = osdmap.OSDMap()
    m.fsid = "parity-fsid"
    m.apply_incremental(osdmap.OSDMapIncremental(
        epoch=1, new_up={i: ("127.0.0.1", 6800 + i)
                         for i in range(n_osds)}))
    crush = m.crush
    inc = osdmap.OSDMapIncremental(epoch=2)
    inc.new_pools[1] = osdmap.Pool(1, "rep", size=3, pg_num=64)
    for pid, (k, mm) in ((2, (4, 2)), (3, (8, 3))):
        rid = crush.make_erasure_rule(f"ec-p{pid}", k, mm)
        inc.new_pools[pid] = osdmap.Pool(
            pid, f"ec{pid}", type=osdmap.ERASURE, size=k + mm,
            min_size=k + 1, pg_num=32, crush_ruleset=rid,
            erasure_code_profile=f"k{k}m{mm}")
    inc.new_crush = denc.dumps(crush)
    m.apply_incremental(inc)
    m.apply_incremental(osdmap.OSDMapIncremental(
        epoch=3, new_down=list(down), new_out=list(out)))
    return m


@pytest.mark.parametrize("down,out", [((), ()), ((3,), ()),
                                      ((3, 7), (3,))])
def test_crush_placement_parity(down, out):
    ours = _osdmap("ceph_tpu_torch", down=down, out=out)
    theirs = _osdmap("ceph_tpu", down=down, out=out)
    pgs = ours.all_pgs()
    assert [str(p) for p in pgs] == [str(p) for p in theirs.all_pgs()]
    assert len(pgs) == 64 + 32 + 32
    for pgid in pgs:
        assert ours.pg_to_up_acting_osds(pgid) == \
            theirs.pg_to_up_acting_osds(pgid), str(pgid)
    for name in ("a", "obj-17", "rbd_data.1234.0000000000000005"):
        for pool in (1, 2, 3):
            assert str(ours.object_to_pg(pool, name)) == \
                str(theirs.object_to_pg(pool, name))


def test_osdmap_encoding_interchanges():
    from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
    from ceph_tpu_torch.osd.osdmap import OSDMap
    ours = _osdmap("ceph_tpu_torch", down=(5,))
    theirs = _osdmap("ceph_tpu", down=(5,))
    assert ours.encode() == theirs.encode()
    back_ref = RefOSDMap.decode(ours.encode())
    back_ours = OSDMap.decode(theirs.encode())
    for pgid in ours.all_pgs():
        want = ours.pg_to_up_acting_osds(pgid)
        assert back_ref.pg_to_up_acting_osds(pgid) == want
        assert back_ours.pg_to_up_acting_osds(pgid) == want


# -- FileStore interchange ------------------------------------------------------

def _fill(store, Transaction, rng):
    """Objects with data, xattrs and omap in two collections; returns
    what each holds."""
    want = {}
    for cid in ("pg_1.0", "pg_2.3"):
        t = Transaction().create_collection(cid)
        store.apply_transaction(t)
        for i in range(6):
            oid = f"obj{i}.s{i % 3}"
            data = rng.integers(0, 256, int(rng.integers(0, 70000)),
                                dtype=np.uint8).tobytes()
            xattrs = {"_hinfo": rng.bytes(24), "_v": repr((1, i)).encode()}
            omap = {f"k{j}": rng.bytes(8) for j in range(i)}
            t = Transaction().write(cid, oid, 0, data)
            for name, val in xattrs.items():
                t.setattr(cid, oid, name, val)
            if omap:
                t.omap_setkeys(cid, oid, omap)
            store.apply_transaction(t)
            want[(cid, oid)] = (data, xattrs, omap)
    # a rewrite and a truncate, so the journal replays more than creates
    cid, oid = "pg_1.0", "obj1.s1"
    data, xattrs, omap = want[(cid, oid)]
    t = Transaction().write(cid, oid, 10, b"rewritten").truncate(
        cid, oid, 40)
    store.apply_transaction(t)
    data = (data[:10] + b"rewritten" + data[19:]).ljust(40, b"\0")[:40]
    want[(cid, oid)] = (data, xattrs, omap)
    return want


def _check(store, want):
    for (cid, oid), (data, xattrs, omap) in want.items():
        assert bytes(store.read(cid, oid)) == data, (cid, oid)
        got = store.getattrs(cid, oid)
        assert {k: bytes(v) for k, v in got.items()} == xattrs, (cid, oid)
        assert {k: bytes(v) for k, v in
                store.omap_get(cid, oid).items()} == omap, (cid, oid)
    for cid in {c for c, _o in want}:
        assert sorted(store.collection_list(cid)) == \
            sorted(o for c, o in want if c == cid)


@pytest.mark.parametrize("writer,reader", [("ceph_tpu", "ceph_tpu_torch"),
                                           ("ceph_tpu_torch", "ceph_tpu")])
def test_filestore_interchange(tmp_path, writer, reader):
    import importlib
    wstore = importlib.import_module(f"{writer}.store")
    rstore = importlib.import_module(f"{reader}.store")
    path = str(tmp_path / "osd0")
    store = wstore.create("filestore", path)
    store.mkfs()
    store.mount()
    want = _fill(store, wstore.Transaction, np.random.default_rng(7))
    store.umount()
    other = rstore.create("filestore", path)
    other.mount()
    try:
        _check(other, want)
    finally:
        other.umount()
    assert os.path.isdir(path)
