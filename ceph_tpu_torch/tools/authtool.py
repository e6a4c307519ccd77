"""ceph-authtool analog (tools/ceph_authtool.cc): create/inspect/edit
keyring files — the cephx bootstrap artifact.

    python -m ceph_tpu_torch.tools.authtool --create-keyring keyring \
        --gen-key --name client.admin
    python -m ceph_tpu_torch.tools.authtool keyring --list
    python -m ceph_tpu_torch.tools.authtool keyring --gen-key --name osd.0
    python -m ceph_tpu_torch.tools.authtool keyring --print-key \
        --name client.admin
"""

from __future__ import annotations

import argparse
import base64
import os
import sys

from ..auth import KeyRing, generate_key


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(prog="ceph-authtool")
    p.add_argument("keyring", nargs="?")
    p.add_argument("--create-keyring", dest="create")
    p.add_argument("--gen-key", action="store_true")
    p.add_argument("--add-key", help="base64 key to import")
    p.add_argument("-n", "--name", default="client.admin")
    p.add_argument("--list", dest="do_list", action="store_true")
    p.add_argument("--print-key", action="store_true")
    args = p.parse_args(argv)

    path = args.create or args.keyring
    if path is None:
        p.error("need a keyring path or --create-keyring")
        return 2
    if args.create:
        ring = KeyRing()
    elif os.path.exists(path):
        ring = KeyRing.from_file(path)
    else:
        print(f"can't open {path}", file=out)
        return 1

    changed = bool(args.create)
    if args.gen_key:
        ring.add(args.name, generate_key())
        changed = True
    elif args.add_key:
        try:
            base64.b64decode(args.add_key, validate=True)
        except Exception:
            print("invalid base64 key", file=out)
            return 1
        ring.add(args.name, args.add_key)
        changed = True

    if changed:
        ring.save(path)
        print(f"creating {path}" if args.create
              else f"updated {path}", file=out)
    if args.do_list:
        for name in sorted(ring.keys):
            print(f"[{name}]\n\tkey = "
                  f"{base64.b64encode(ring.keys[name]).decode()}",
                  file=out)
    if args.print_key:
        key = ring.get(args.name)
        if key is None:
            print(f"no key for {args.name}", file=out)
            return 1
        print(base64.b64encode(key).decode(), file=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
