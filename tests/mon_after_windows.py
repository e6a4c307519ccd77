"""How late does the leader mon answer a fresh client after a cluster's
write, scrub and recovery windows?  Runs a cut of chip_smoke.py's phase
9 on a MiniCluster of either package, on the CPU:

    JAX_PLATFORMS=cpu python tests/mon_after_windows.py --package ceph_tpu_torch
    JAX_PLATFORMS=cpu python tests/mon_after_windows.py --package ceph_tpu

3 mons and `--osds` OSDs (default 8: two spares), a `--k`/`--m` pool
(default k=4 m=2, pg_num `--pg-num`, default 16); window 1 writes
`--objects` objects of `--object-bytes` from 4 clients and reads them
back, window 2 deep-scrubs every PG, window 3 kills an OSD, marks it down
and out and waits for clean; then every object is read back.  Before the
windows and after each stage a fresh client's first `health` command is
timed (client creation included), and at the end a command from each
long-lived client.  A stage that fails ends the windows: its error is
reported and the mon is still timed.  Prints one JSON object; exits 1
if a stage failed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def note(what: str) -> None:
    print(f"{time.strftime('%H:%M:%S')} mon_after_windows: {what}",
          file=sys.stderr, flush=True)


def first_command(cluster, name: str) -> dict:
    """Seconds from creating client `name` to its first answered
    `health`, and the mon that answered."""
    t0 = time.perf_counter()
    rados = cluster.client(name)
    rv, _out, _ = rados.mon_command({"prefix": "health"})
    return {"s": time.perf_counter() - t0, "rv": rv,
            "mon": str(rados.monc._cur_mon),
            "leader": cluster.leader().name}


def command_s(rados) -> float:
    t0 = time.perf_counter()
    rados.mon_command({"prefix": "health"})
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="ceph_tpu_torch",
                    choices=("ceph_tpu_torch", "ceph_tpu"))
    ap.add_argument("--objects", type=int, default=48)
    ap.add_argument("--object-bytes", type=int, default=1 << 20)
    ap.add_argument("--osds", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--pg-num", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.package == "ceph_tpu_torch":
        import ceph_tpu_torch
        ceph_tpu_torch.set_device("cpu")
    vstart = importlib.import_module(f"{args.package}.vstart")
    config = importlib.import_module(f"{args.package}.utils.config")
    rng = np.random.default_rng(args.seed)
    conf = config.Config({
        "mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
        "osd_heartbeat_grace": 8.0, "mon_osd_min_down_reporters": 2,
        "mon_osd_down_out_interval": 1e6, "objecter_op_timeout": 120.0})
    out = dict(vars(args), first_command={}, stage_s={}, error=None)
    cluster = vstart.MiniCluster(num_mons=3, num_osds=args.osds, conf=conf)
    cluster.start(timeout=120.0)
    clients, ios, payloads = [], [], []

    def run(fn):
        with ThreadPoolExecutor(len(ios)) as pool:
            return list(pool.map(lambda i: fn(ios[i % len(ios)], i),
                                 range(args.objects)))

    def pool_clean():
        admin = cluster.client()
        admin.create_ec_pool(
            "ecpool", f"k{args.k}m{args.m}",
            {"plugin": "tpu", "k": str(args.k), "m": str(args.m),
             "technique": "reed_sol_van"}, pg_num=args.pg_num)
        cluster.wait_for_clean(300.0)
        clients.extend(cluster.client(f"client.load{t}") for t in range(4))
        ios.extend(c.open_ioctx("ecpool") for c in clients)

    def writes():
        payloads.extend(rng.integers(0, 256, args.object_bytes,
                                     dtype=np.uint8).tobytes()
                        for _ in range(args.objects))
        run(lambda io, i: io.write_full(f"obj{i}", payloads[i]))
        back = run(lambda io, i: io.read(f"obj{i}"))
        assert all(bytes(b) == p for b, p in zip(back, payloads))

    def scrub():
        osdmap = cluster.leader().osdmon.osdmap
        for pgid in [p for p in osdmap.all_pgs()
                     if p.pool == ios[0].pool_id]:
            _up, acting = osdmap.pg_to_up_acting_osds(pgid)
            primary = next(o for o in acting if o >= 0)
            res = cluster.osds[primary].get_pg(pgid).scrub(deep=True)
            assert not res["inconsistent"], res

    def recovery():
        victim = out["victim"] = int(rng.integers(args.osds))
        cluster.kill_osd(victim)
        cluster.mark_osd_down(victim)
        cluster.wait_for_osd_down(victim, 60.0)
        cluster.mark_osd_out(victim)
        cluster.wait_for_clean(300.0)

    def reads():
        back = run(lambda io, i: io.read(f"obj{i}"))
        assert all(bytes(b) == p for b, p in zip(back, payloads))

    try:
        out["first_command"]["started"] = first_command(cluster,
                                                         "client.probe")
        for n, stage in enumerate((pool_clean, writes, scrub, recovery,
                                   reads), 1):
            t0 = time.perf_counter()
            try:
                stage()
            except Exception as e:   # the package's fault, reported
                out["error"] = f"{stage.__name__}: {e!r}"
            out["stage_s"][stage.__name__] = time.perf_counter() - t0
            note(f"{stage.__name__} {'failed' if out['error'] else 'done'}")
            out["first_command"][stage.__name__] = first_command(
                cluster, f"client.probe{n}")
            if out["error"]:
                break
        out["old_clients_s"] = [command_s(c) for c in clients]
    finally:
        cluster.stop()
    print(json.dumps(out))
    return 1 if out["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
