"""The `rados` CLI (tools/rados/rados.cc + common/obj_bencher.cc).

    python -m ceph_tpu_torch.tools.rados_cli -c ceph.conf lspools
    ... -p mypool put obj ./file     | get obj ./file | rm obj
    ... -p mypool ls | stat obj | df
    ... -p mypool bench 10 write [-b 65536] [-t 8]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

from . import connect_from_conf


def cmd_bench(io, seconds: int, mode: str, block: int,
              threads: int, out=sys.stdout) -> dict:
    """obj_bencher analog: sustained write (then read) throughput."""
    existing: list[str] = []
    if mode != "write":
        # read mode targets objects a prior write bench left behind
        existing = [n for n in io.list_objects()
                    if n.startswith("bench_")]
        if not existing:
            print("error: no bench_* objects; run a write bench first",
                  file=sys.stderr)
            return {"ops": 0, "errors": 0, "failed": True}
    stop = time.time() + seconds
    counts = [0] * threads
    errors = [0] * threads
    payload = bytes(range(256)) * (block // 256 + 1)
    payload = payload[:block]

    def worker(t: int) -> None:
        i = 0
        while time.time() < stop:
            try:
                if mode == "write":
                    io.write_full(f"bench_{t}_{i}", payload)
                else:
                    io.read(existing[(t + i) % len(existing)])
                counts[t] += 1
            except Exception:
                errors[t] += 1
                time.sleep(0.01)     # no tight error spin
            i += 1

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dur = max(time.time() - t0, 1e-9)
    ops = sum(counts)
    res = {"ops": ops, "seconds": round(dur, 2),
           "ops_per_sec": round(ops / dur, 2),
           "bytes_per_sec": round(ops * block / dur, 2),
           "mb_per_sec": round(ops * block / dur / 1e6, 3),
           "errors": sum(errors)}
    print(f"Total {mode}s made: {ops}", file=out)
    print(f"Bandwidth (MB/sec): {res['mb_per_sec']}", file=out)
    print(f"Average IOPS: {res['ops_per_sec']}", file=out)
    return res


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="rados")
    parser.add_argument("-c", "--conf")
    parser.add_argument("-p", "--pool")
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.cmd:
        parser.error("missing command")
    r = connect_from_conf(args.conf)
    try:
        cmd, *rest = args.cmd
        if cmd == "lspools":
            for name in r.list_pools():
                print(name, file=out)
            return 0
        if cmd == "mkpool":
            r.create_pool(rest[0])
            print(f"successfully created pool {rest[0]}", file=out)
            return 0
        if cmd == "rmpool":
            r.delete_pool(rest[0])
            print(f"successfully deleted pool {rest[0]}", file=out)
            return 0
        if cmd == "df":
            for name in r.list_pools():
                io = r.open_ioctx(name)
                objs = io.list_objects()
                print(f"{name}\t{len(objs)} objects", file=out)
            return 0
        if not args.pool:
            print("error: -p pool required", file=sys.stderr)
            return 2
        io = r.open_ioctx(args.pool)
        if cmd == "put":
            oid, path = rest
            with open(path, "rb") as f:
                io.write_full(oid, f.read())
        elif cmd == "get":
            oid, path = rest
            data = io.read(oid)
            with open(path, "wb") as f:
                f.write(data)
        elif cmd == "rm":
            io.remove_object(rest[0])
        elif cmd == "ls":
            for name in io.list_objects():
                print(name, file=out)
        elif cmd == "stat":
            st = io.stat(rest[0])
            print(f"{args.pool}/{rest[0]} size {st['size']}", file=out)
        elif cmd == "bench":
            seconds = int(rest[0]) if rest else 10
            mode = rest[1] if len(rest) > 1 else "write"
            block = 65536
            nthreads = 4
            if "-b" in rest:
                block = int(rest[rest.index("-b") + 1])
            if "-t" in rest:
                nthreads = int(rest[rest.index("-t") + 1])
            res = cmd_bench(io, seconds, mode, block, nthreads, out=out)
            if res.get("failed"):
                return 1
        else:
            print(f"unknown command {cmd}", file=sys.stderr)
            return 2
        return 0
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
