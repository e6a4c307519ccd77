"""The `rbd` CLI (tools/rbd analog).

    python -m ceph_tpu_torch.tools.rbd_cli -c ceph.conf -p pool \
        create IMG --size 16M [--order 22]
    ... ls | info IMG | rm IMG | resize IMG --size 32M
    ... snap create IMG@SNAP | snap ls IMG | snap rm IMG@SNAP
    ... bench IMG --io-size 4096 --io-total 1M
"""

from __future__ import annotations

import argparse
import sys
import time

from . import connect_from_conf


def parse_size(text: str) -> int:
    text = text.strip().upper()
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if text.endswith(suffix):
            text, mult = text[:-1], m
            break
    return int(float(text) * mult)


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="rbd")
    parser.add_argument("-c", "--conf")
    parser.add_argument("-p", "--pool", required=True)
    parser.add_argument("--size")
    parser.add_argument("--order", type=int, default=22)
    parser.add_argument("--io-size", default="4096")
    parser.add_argument("--io-total", default="4M")
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.cmd:
        parser.error("missing command")

    from ..rbd import RBD, Image, RbdError
    r = connect_from_conf(args.conf)
    try:
        io = r.open_ioctx(args.pool)
        rbd = RBD(io)
        cmd, *rest = args.cmd
        try:
            if cmd == "create":
                if not args.size:
                    parser.error("create requires --size")
                rbd.create(rest[0], parse_size(args.size),
                           order=args.order)
                print(f"created {rest[0]}", file=out)
            elif cmd == "ls":
                for name in rbd.list():
                    print(name, file=out)
            elif cmd == "rm":
                rbd.remove(rest[0])
                print(f"removed {rest[0]}", file=out)
            elif cmd == "info":
                with Image(io, rest[0]) as img:
                    st = img.stat()
                    print(f"rbd image '{rest[0]}':", file=out)
                    print(f"\tsize {st['size']} bytes in "
                          f"{st['num_objs']} objects", file=out)
                    print(f"\torder {st['order']} "
                          f"({1 << st['order']} bytes)", file=out)
                    if st["snaps"]:
                        print(f"\tsnapshots: {', '.join(st['snaps'])}",
                              file=out)
            elif cmd == "resize":
                if not args.size:
                    parser.error("resize requires --size")
                with Image(io, rest[0]) as img:
                    img.resize(parse_size(args.size))
                print(f"resized {rest[0]}", file=out)
            elif cmd == "snap":
                sub, spec = rest[0], rest[1]
                if sub == "ls":
                    with Image(io, spec) as img:
                        for s in img.snap_list():
                            print(f"{s['id']}\t{s['name']}\t"
                                  f"{s['size']}", file=out)
                else:
                    img_name, _, snap = spec.partition("@")
                    with Image(io, img_name) as img:
                        if sub == "create":
                            img.snap_create(snap)
                            print(f"created {spec}", file=out)
                        elif sub == "rm":
                            img.snap_remove(snap)
                            print(f"removed {spec}", file=out)
                        else:
                            print(f"unknown snap subcommand {sub!r}",
                                  file=sys.stderr)
                            return 2
            elif cmd == "bench":
                io_size = parse_size(args.io_size)
                total = parse_size(args.io_total)
                with Image(io, rest[0]) as img:
                    n = max(1, min(total, img.size()) // io_size)
                    payload = b"\xA5" * io_size
                    t0 = time.time()
                    for i in range(n):
                        img.write((i * io_size) % max(
                            img.size() - io_size, 1), payload)
                    dt = max(time.time() - t0, 1e-9)
                print(f"elapsed {dt:.2f}s ops {n} "
                      f"bytes/sec {n * io_size / dt:.0f}", file=out)
            else:
                print(f"unknown command {cmd}", file=sys.stderr)
                return 2
            return 0
        except (RbdError, IndexError) as e:
            print(f"rbd: {e}", file=sys.stderr)
            return 1
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
