"""monmaptool analog (tools/monmaptool.cc): create/print/edit monmaps
offline — the bootstrap artifact a new monitor is seeded with.

    python -m ceph_tpu_torch.tools.monmaptool --create --fsid <id> \
        --add a 127.0.0.1:6789 --add b 127.0.0.1:6790 -o monmap.bin
    python -m ceph_tpu_torch.tools.monmaptool -i monmap.bin --print
    python -m ceph_tpu_torch.tools.monmaptool -i monmap.bin --rm b \
        --add c 127.0.0.1:6791 -o monmap2.bin
"""

from __future__ import annotations

import argparse
import sys

from ..mon.monmap import MonMap


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"bad address {s!r} (want host:port)")
    return (host, int(port))


def print_map(mm: MonMap, out=sys.stdout) -> None:
    print(f"epoch {mm.epoch}", file=out)
    print(f"fsid {mm.fsid}", file=out)
    for name in mm.ranks():
        host, port = mm.addr_of(name)
        print(f"{mm.rank_of(name)}: {host}:{port} mon.{name}",
              file=out)


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(prog="monmaptool")
    p.add_argument("-i", "--input")
    p.add_argument("-o", "--output")
    p.add_argument("--create", action="store_true")
    p.add_argument("--fsid", default="")
    p.add_argument("--add", nargs=2, action="append", default=[],
                   metavar=("NAME", "ADDR"))
    p.add_argument("--rm", action="append", default=[],
                   metavar="NAME")
    p.add_argument("--print", dest="do_print", action="store_true")
    args = p.parse_args(argv)

    if args.create:
        mm = MonMap(fsid=args.fsid)
    elif args.input:
        with open(args.input, "rb") as f:
            mm = MonMap.decode(f.read())
    else:
        p.error("need --create or -i")
        return 2

    changed = False
    for name, addr in args.add:
        if name in mm.mons:
            print(f"mon.{name} already exists", file=out)
            return 1
        mm.add(name, _parse_addr(addr))
        changed = True
    for name in args.rm:
        if name not in mm.mons:
            print(f"mon.{name} does not exist", file=out)
            return 1
        mm.remove(name)
        changed = True
    if changed and not args.create:
        mm.epoch += 1

    if args.do_print:
        print_map(mm, out)
    if args.output:
        with open(args.output, "wb") as f:
            f.write(mm.encode())
        print(f"monmaptool: wrote monmap ({mm.size} mons) to "
              f"{args.output}", file=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
