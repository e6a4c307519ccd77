"""cephfs-shell analog (tools/cephfs/cephfs-shell): drive a CephFS
namespace from the command line — the mount surface for environments
without FUSE (the reference's client/fuse_ll.cc path is kernel-side;
this is the tool-side access everyone actually scripts against).

    python -m ceph_tpu_torch.tools.cephfs_shell -c cluster.conf ls /
    ... mkdir /a ; put local.txt /a/f ; get /a/f out.txt ; cat /a/f
    ... stat /a/f ; mv /a/f /a/g ; rm /a/g ; rmdir /a ; tree /
"""

from __future__ import annotations

import argparse
import sys

from ..fs import CephFS, FsError


def _connect(conf_path: str):
    from . import connect_from_conf
    rados = connect_from_conf(conf_path)
    return rados, CephFS(rados).mount()


def _tree(fs, path: str, out, prefix: str = "") -> None:
    for name in fs.listdir(path):
        full = f"{path.rstrip('/')}/{name}"
        try:
            st = fs.stat(full)
        except FsError:
            continue
        if st.get("type") == "dir":
            print(f"{prefix}{name}/", file=out)
            _tree(fs, full, out, prefix + "  ")
        else:
            print(f"{prefix}{name} [{st.get('size', 0)}]", file=out)


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(prog="cephfs-shell")
    p.add_argument("-c", "--conf", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, nargs in (("ls", 1), ("mkdir", 1), ("rmdir", 1),
                        ("rm", 1), ("cat", 1), ("stat", 1),
                        ("tree", 1), ("mv", 2), ("put", 2),
                        ("get", 2)):
        sp = sub.add_parser(name)
        sp.add_argument("args", nargs=nargs)
    args = p.parse_args(argv)

    rados, fs = _connect(args.conf)
    try:
        a = args.args
        if args.cmd == "ls":
            for name in fs.listdir(a[0]):
                print(name, file=out)
        elif args.cmd == "mkdir":
            fs.mkdirs(a[0])
        elif args.cmd == "rmdir":
            fs.rmdir(a[0])
        elif args.cmd == "rm":
            fs.unlink(a[0])
        elif args.cmd == "cat":
            with fs.open(a[0], "r") as f:
                out.write(f.read().decode("utf-8", "replace"))
        elif args.cmd == "stat":
            st = fs.stat(a[0])
            print(f"{a[0]}: type={st.get('type')} "
                  f"size={st.get('size', 0)} ino={st.get('ino')}",
                  file=out)
        elif args.cmd == "tree":
            _tree(fs, a[0], out)
        elif args.cmd == "mv":
            fs.rename(a[0], a[1])
        elif args.cmd == "put":
            with open(a[0], "rb") as src, fs.open(a[1], "w") as dst:
                dst.write(src.read())
        elif args.cmd == "get":
            with fs.open(a[0], "r") as src, open(a[1], "wb") as dst:
                dst.write(src.read())
        return 0
    except (FsError, OSError) as e:
        print(f"cephfs-shell: {e}", file=out)
        return 1
    finally:
        fs.unmount()
        rados.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
