"""Standalone daemon entry points (ceph_mon.cc / ceph_osd.cc analogs).

    python -m ceph_tpu_torch.daemons mon --name a -c ceph.conf
    python -m ceph_tpu_torch.daemons osd --id 0 -c ceph.conf
    python -m ceph_tpu_torch.daemons mgr --name x -c ceph.conf
    python -m ceph_tpu_torch.daemons mds --name a -c ceph.conf
    python -m ceph_tpu_torch.daemons rgw --port 7480 -c ceph.conf

Every role runs its EC work on the package device: ``cuda`` (an OSD
with no card raises at start) unless a caller that imports this module
calls ``ceph_tpu_torch.set_device("cpu")`` before ``main()``.  The mds
and rgw roles do no device work of their own.

ceph.conf is the usual ini (utils/config.py parse_file) plus cluster
topology the binaries need to boot:

    [global]
    fsid = ...
    mon host = 127.0.0.1:6789,127.0.0.1:6790,127.0.0.1:6791
    objectstore = filestore
    osd data = /var/lib/ceph-tpu/osd-$id

Monitors are named a, b, c... in mon-host order (the reference derives
rank from the monmap the same way).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from .mon.monmap import MonMap
from .utils.config import Config


DEFAULT_MON_PORT = 6789


def parse_mon_host(spec: str) -> list[tuple[str, int]]:
    """host[:port] list; portless entries get the default mon port,
    [v6]:port bracket syntax supported."""
    addrs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("["):              # [v6addr]:port
            host, _, rest = part[1:].partition("]")
            port = rest.lstrip(":") or str(DEFAULT_MON_PORT)
        elif part.count(":") == 1:
            host, _, port = part.partition(":")
        else:                                  # portless, or bare v6
            host, port = part, str(DEFAULT_MON_PORT)
        try:
            addrs.append((host or "127.0.0.1", int(port)))
        except ValueError:
            raise SystemExit(f"bad mon_host entry {part!r}")
    return addrs


def load_conf(path: str | None, section: str | None = None) -> Config:
    conf = Config()
    if path:
        conf.parse_file(path, section)
    return conf


def monmap_from_conf(conf: Config) -> MonMap:
    spec = str(conf.mon_host)
    if not spec:
        raise SystemExit("conf has no mon_host")
    mm = MonMap(fsid=str(conf.fsid) or "00000000-0000-0000-0000-000000000000")
    for i, addr in enumerate(parse_mon_host(spec)):
        mm.add(chr(ord("a") + i), addr)
    return mm


def _run_forever(daemon) -> None:
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        stop.wait()
    finally:
        daemon.shutdown()


def main_mon(args) -> None:
    conf = load_conf(args.conf, f"mon.{args.name}")
    monmap = monmap_from_conf(conf)
    from .mon.monitor import Monitor
    mon = Monitor(args.name, monmap, conf=conf,
                  store_path=args.store_path or "")
    mon.start()
    print(f"mon.{args.name} up at {monmap.addr_of(args.name)}",
          flush=True)
    _run_forever(mon)


def main_osd(args) -> None:
    conf = load_conf(args.conf, f"osd.{args.id}")
    monmap = monmap_from_conf(conf)
    from .osd.daemon import OSDDaemon
    store_kind = args.store or str(conf.objectstore)
    osd = OSDDaemon(int(args.id), monmap, conf=conf,
                    store_kind=store_kind,
                    store_path=args.store_path or "")
    osd.start()
    print(f"osd.{args.id} up at {osd.msgr.addr}", flush=True)
    _run_forever(osd)


def main_mgr(args) -> None:
    conf = load_conf(args.conf, f"mgr.{args.name}")
    monmap = monmap_from_conf(conf)
    from .mgr import MgrDaemon
    mgr = MgrDaemon(args.name, monmap, conf=conf)
    mgr.start()
    print(f"mgr.{args.name} up at {mgr.msgr.addr}", flush=True)
    _run_forever(mgr)


def main_mds(args) -> None:
    conf = load_conf(args.conf, f"mds.{args.name}")
    monmap = monmap_from_conf(conf)
    from .fs.mds import MDSDaemon
    mds = MDSDaemon(args.name, monmap, conf=conf)
    mds.start()
    print(f"mds.{args.name} up at {mds.msgr.addr}", flush=True)
    _run_forever(mds)


def main_rgw(args) -> None:
    conf = load_conf(args.conf, "client.rgw")
    monmap = monmap_from_conf(conf)
    from .client import Rados
    from .rgw import RGWDaemon
    r = Rados(monmap, "client.rgw", conf=conf)
    r.connect()
    rgw = RGWDaemon(r, port=args.port, access_key=args.access_key,
                    secret_key=args.secret_key)
    rgw.start()
    print(f"rgw up at http://127.0.0.1:{rgw.port}", flush=True)
    _run_forever(rgw)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="ceph-tpu-torch-daemon")
    sub = parser.add_subparsers(dest="role", required=True)

    p_mon = sub.add_parser("mon")
    p_mon.add_argument("--name", required=True)
    p_mon.add_argument("-c", "--conf")
    p_mon.add_argument("--store-path", default="")

    p_osd = sub.add_parser("osd")
    p_osd.add_argument("--id", required=True, type=int)
    p_osd.add_argument("-c", "--conf")
    p_osd.add_argument("--store", default="")
    p_osd.add_argument("--store-path", default="")

    p_mgr = sub.add_parser("mgr")
    p_mgr.add_argument("--name", required=True)
    p_mgr.add_argument("-c", "--conf")

    p_mds = sub.add_parser("mds")
    p_mds.add_argument("--name", required=True)
    p_mds.add_argument("-c", "--conf")

    p_rgw = sub.add_parser("rgw")
    p_rgw.add_argument("--port", type=int, default=7480)
    p_rgw.add_argument("--access-key", default="")
    p_rgw.add_argument("--secret-key", default="")
    p_rgw.add_argument("-c", "--conf")

    args = parser.parse_args(argv)
    if args.role == "mon":
        main_mon(args)
    elif args.role == "mgr":
        main_mgr(args)
    elif args.role == "mds":
        main_mds(args)
    elif args.role == "rgw":
        main_rgw(args)
    else:
        main_osd(args)


if __name__ == "__main__":
    main(sys.argv[1:])
