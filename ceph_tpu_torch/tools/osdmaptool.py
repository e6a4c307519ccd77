"""osdmaptool analog: inspect an OSDMap dump + pg distribution tests.

    python -m ceph_tpu_torch.tools.ceph_cli -c ceph.conf osd getmap > map.bin
    python -m ceph_tpu_torch.tools.osdmaptool map.bin --print
    python -m ceph_tpu_torch.tools.osdmaptool map.bin --test-map-pgs \
        [--pool N]
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from ..osd.osdmap import OSDMap, PgId


def print_map(m: OSDMap, out=sys.stdout) -> None:
    print(f"epoch {m.epoch}", file=out)
    print(f"fsid {m.fsid}", file=out)
    for pid, pool in sorted(m.pools.items()):
        kind = "erasure" if pool.is_erasure else "replicated"
        print(f"pool {pid} '{pool.name}' {kind} size {pool.size} "
              f"min_size {pool.min_size} pg_num {pool.pg_num} "
              f"snap_seq {pool.snap_seq}", file=out)
    for osd_id, info in sorted(m.osds.items()):
        state = ("up" if info.up else "down",
                 "in" if info.in_cluster else "out")
        print(f"osd.{osd_id} {' '.join(state)} weight {info.weight} "
              f"{info.addr}", file=out)


def test_map_pgs(m: OSDMap, pool_id: int | None,
                 out=sys.stdout) -> dict:
    """pg -> osd distribution statistics (osdmaptool --test-map-pgs)."""
    util: Counter = Counter()
    primaries: Counter = Counter()
    total = 0
    for pid, pool in sorted(m.pools.items()):
        if pool_id is not None and pid != pool_id:
            continue
        for seed in range(pool.pg_num):
            pgid = PgId(pid, seed)
            up, acting = m.pg_to_up_acting_osds(pgid)
            live = [o for o in acting if o >= 0]
            total += 1
            for o in live:
                util[o] += 1
            if live:
                primaries[live[0]] += 1
    if total == 0:
        print("no pgs", file=out)
        return {"total": 0}
    counts = [util.get(o, 0) for o in sorted(m.osds)]
    avg = sum(counts) / max(len(counts), 1)
    print(f"examined {total} pgs", file=out)
    for o in sorted(m.osds):
        print(f"osd.{o}\tpgs {util.get(o, 0)}\tprimary "
              f"{primaries.get(o, 0)}", file=out)
    print(f"avg {avg:.1f} min {min(counts)} max {max(counts)}",
          file=out)
    return {"total": total, "util": dict(util),
            "primaries": dict(primaries), "avg": avg}


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="osdmaptool")
    parser.add_argument("mapfile")
    parser.add_argument("--print", dest="do_print", action="store_true")
    parser.add_argument("--test-map-pgs", action="store_true")
    parser.add_argument("--pool", type=int)
    args = parser.parse_args(argv)
    with open(args.mapfile, "rb") as f:
        m = OSDMap.decode(f.read())
    if args.do_print:
        print_map(m, out=out)
    if args.test_map_pgs:
        test_map_pgs(m, args.pool, out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
