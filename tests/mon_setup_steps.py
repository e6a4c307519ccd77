"""What does each of chip_smoke.py phase 10's setup steps cost the mon on
a cluster that phase 9 has aged?  Runs a cut of both phases on a
MiniCluster of the port, on the CPU:

    JAX_PLATFORMS=cpu python tests/mon_setup_steps.py [--root <checkout>]

`--root` names the checkout whose `ceph_tpu_torch` runs (default: this
one), so that a parent commit unpacked with `git archive` can be
measured beside it.  Ageing, as phase 9: 3 mons and 13 OSDs, a k=8 m=3
pool of 64 pgs, 16 objects of 256 KiB written from 4 clients, one OSD
killed, marked down and out, and the pool clean again.  Then phase 10's
setup steps: `pools` (an EC base, a replicated tier and a metadata
pool, clean), `tier` (`osd tier add`, `cache-mode`, `set-overlay` and
three `osd pool set`s) and `daemons` (an MDS and an RGW).  For each
step: the leader's osdmap epochs, paxos commits and begins, elections,
mon command retries, the OSDs the maps marked down, the seconds, the
seconds every OSD spent handling maps (summed) and the pgs the OSDs
placed through CRUSH while handling them.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {"mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
        "osd_heartbeat_grace": 8.0, "mon_osd_min_down_reporters": 2,
        "mon_osd_down_out_interval": 1e6, "objecter_op_timeout": 120.0}
# phase 9's shape, and phase 10's pools
OSDS, K, M, PG_NUM = 13, 8, 3, 64
OBJECTS, OBJECT_BYTES = 16, 256 << 10
DOORS_PG_NUM, META_PG_NUM = 32, 16
SEED = 20261016
BASE, HOT, META = "doors", "doors-hot", "cephfs_metadata"
TIER_SETTINGS = {"target_max_objects": "8", "hit_set_count": "2",
                 "hit_set_period": "10.0"}


class MapMeter:
    """Seconds each OSD spends handling maps, and the pgs it places
    through CRUSH meanwhile (OSDMap.pg_to_raw_osds on that thread), by
    the OSD and the epoch of the map."""

    def __init__(self, cluster, osdmap_cls):
        self.lock = threading.Lock()
        self.seconds = 0.0
        self.placed: dict[tuple, set] = {}    # (osd, epoch) -> pgids
        self.handled: dict[int, int] = {}     # osd -> newest map handled
        self._local = threading.local()
        for osd in cluster.osds.values():
            self.watch(osd)
        real = osdmap_cls.pg_to_raw_osds
        meter = self

        def raw(self_map, pgid):
            key = getattr(meter._local, "key", None)
            if key is not None:
                with meter.lock:
                    meter.placed[key].add(pgid)
            return real(self_map, pgid)

        osdmap_cls.pg_to_raw_osds = raw
        self._undo = lambda: setattr(osdmap_cls, "pg_to_raw_osds", real)

    def watch(self, osd) -> None:
        real = osd.monc.on_osdmap

        def on_map(osdmap):
            key = (osd.whoami, osdmap.epoch)
            with self.lock:
                self.placed.setdefault(key, set())
            self._local.key = key
            t0 = time.perf_counter()
            try:
                real(osdmap)
            finally:
                self._local.key = None
                with self.lock:
                    self.seconds += time.perf_counter() - t0
                    self.handled[osd.whoami] = max(
                        self.handled.get(osd.whoami, 0), osdmap.epoch)

        osd.monc.on_osdmap = on_map

    def snapshot(self) -> tuple:
        with self.lock:
            return self.seconds, sum(map(len, self.placed.values()))

    def close(self) -> None:
        self._undo()


def mon_counts(cluster) -> dict:
    mons = cluster.mons
    return {"epoch": max(m.osdmon.osdmap.epoch for m in mons),
            "commits": max(m.paxos.last_committed for m in mons),
            "begins": sum(m.paxos.perf.value("begin") for m in mons),
            "elections": sum(m.perf.value("elections_won")
                             for m in mons)}


def marked_down(cluster, since: int) -> list[int]:
    """The OSDs the leader's maps after epoch `since` marked down."""
    from ceph_tpu_torch.utils import denc
    incs = cluster.leader().osdmon.get_incrementals(since)
    return sorted({o for b in incs for o in denc.loads(b).new_down})


def age(cluster, admin, rng, *, osds: int = OSDS, k: int = K, m: int = M,
        pg_num: int = PG_NUM, objects: int = OBJECTS,
        object_bytes: int = OBJECT_BYTES) -> dict:
    """Phase 9, cut: pool, writes, an OSD killed, marked out, clean."""
    t0 = time.perf_counter()
    admin.create_ec_pool("ecpool", f"k{k}m{m}", {
        "plugin": "tpu", "technique": "reed_sol_van", "k": str(k),
        "m": str(m), "host_cutover": str(1 << 16)}, pg_num=pg_num)
    cluster.wait_for_clean(600.0)
    ios = [cluster.client(f"client.load{t}").open_ioctx("ecpool")
           for t in range(4)]
    payloads = [rng.integers(0, 256, object_bytes, dtype=np.uint8).tobytes()
                for _ in range(objects)]
    threads = [threading.Thread(target=lambda t=t: [
        ios[t].write_full(f"obj{i}", payloads[i])
        for i in range(t, objects, len(ios))]) for t in range(len(ios))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    victim = int(rng.integers(osds))
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    cluster.wait_for_osd_down(victim, 120.0)
    cluster.mark_osd_out(victim)
    cluster.wait_for_clean(600.0)
    for i in range(0, objects, max(1, objects // 4)):
        assert bytes(ios[0].read(f"obj{i}")) == payloads[i], i
    return {"victim": victim, "s": time.perf_counter() - t0}


def setup_steps(cluster, admin, meter: MapMeter, *,
                pg_num: int = DOORS_PG_NUM, meta_pg_num: int = META_PG_NUM,
                k: int = K, m: int = M) -> dict:
    """Phase 10's setup steps, each with its counts."""
    if REPO not in sys.path:
        sys.path.append(REPO)
    from chip_smoke import mon_command_ok
    retries = {"n": 0}

    def pools():
        admin.create_ec_pool(BASE, f"k{k}m{m}-doors", {
            "plugin": "tpu", "technique": "reed_sol_van", "k": str(k),
            "m": str(m), "host_cutover": "1"}, pg_num=pg_num)
        admin.create_pool(HOT, pg_num=pg_num)
        admin.create_pool(META, pg_num=meta_pg_num)
        cluster.wait_for_clean(600.0)

    def tier():
        for cmd in [{"prefix": "osd tier add", "pool": BASE,
                     "tierpool": HOT},
                    {"prefix": "osd tier cache-mode", "pool": HOT,
                     "mode": "writeback"},
                    {"prefix": "osd tier set-overlay", "pool": BASE,
                     "overlaypool": HOT}] + [
                    {"prefix": "osd pool set", "pool": HOT, "var": var,
                     "val": val} for var, val in TIER_SETTINGS.items()]:
            retries["n"] += mon_command_ok(cluster, admin, cmd)

    def daemons():
        cluster.start_mds("a", metadata_pool=META, data_pool=BASE)
        cluster.start_rgw(access_key="AKIASETUPSTEPS",
                          secret_key="setup-steps", data_pool=BASE)

    out = {}
    for name, fn in (("pools", pools), ("tier", tier),
                     ("daemons", daemons)):
        retries["n"] = 0
        before, (map_s, placed) = mon_counts(cluster), meter.snapshot()
        t0 = time.perf_counter()
        fn()
        s = time.perf_counter() - t0
        after, (map_s2, placed2) = mon_counts(cluster), meter.snapshot()
        out[name] = {
            "epochs": after["epoch"] - before["epoch"],
            "paxos_commits": after["commits"] - before["commits"],
            "paxos_begins": after["begins"] - before["begins"],
            "elections": after["elections"] - before["elections"],
            "mon_retries": retries["n"],
            "marked_down": marked_down(cluster, before["epoch"]), "s": s,
            "osd_map_s": map_s2 - map_s, "crush_pgs": placed2 - placed}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import ceph_tpu_torch
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.utils.config import Config
    from ceph_tpu_torch.vstart import MiniCluster
    ceph_tpu_torch.set_device("cpu")
    cluster = MiniCluster(num_mons=3, num_osds=OSDS,
                          conf=Config(dict(CONF)))
    cluster.start(timeout=120.0)
    meter = MapMeter(cluster, OSDMap)
    try:
        admin = cluster.client("client.setup")
        out = {"root": os.path.abspath(args.root),
               "age": age(cluster, admin, np.random.default_rng(SEED))}
        out["steps"] = setup_steps(cluster, admin, meter)
    finally:
        meter.close()
        cluster.stop()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
