"""ceph-objectstore-tool analog: offline surgery on an OSD's store
(tools/ceph_objectstore_tool.cc): list collections/objects, dump an
object, export/import a whole PG, remove objects.

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path /path/osd0 \
        --op list [--pgid 1.3]
    ... --op export --pgid 1.3 --file pg.export
    ... --op import --file pg.export
    ... --op dump --pgid 1.3 --oid obj
    ... --op remove --pgid 1.3 --oid obj

The OSD must be stopped: this opens the store directly.
"""

from __future__ import annotations

import argparse
import sys

from ..store import create as store_create
from ..store.objectstore import StoreError, Transaction
from ..utils import denc


def open_store(path: str):
    store = store_create("filestore", path)
    store.mount()
    return store


def op_list(store, pgid: str | None, out=sys.stdout) -> list:
    names = []
    for cid in store.list_collections():
        if pgid and cid != f"pg_{pgid}":
            continue
        for oid in store.collection_list(cid):
            names.append((cid, oid))
            print(f"{cid}\t{oid}", file=out)
    return names


def op_export(store, pgid: str, path: str, out=sys.stdout) -> None:
    cid = f"pg_{pgid}"
    objs = []
    for oid in store.collection_list(cid):
        entry = {
            "oid": oid,
            "data": store.read(cid, oid),
            "xattrs": store.getattrs(cid, oid),
            "omap": store.omap_get(cid, oid),
        }
        objs.append(entry)
    with open(path, "wb") as f:
        f.write(denc.dumps({"pgid": pgid, "objects": objs}))
    print(f"exported {len(objs)} objects from {cid} to {path}",
          file=out)


def op_import(store, path: str, out=sys.stdout) -> None:
    with open(path, "rb") as f:
        dump = denc.loads(f.read())
    cid = f"pg_{dump['pgid']}"
    txn = Transaction()
    if not store.collection_exists(cid):
        txn.create_collection(cid)
    for entry in dump["objects"]:
        oid = entry["oid"]
        txn.try_remove(cid, oid)
        txn.touch(cid, oid)
        if entry["data"]:
            txn.write(cid, oid, 0, entry["data"])
        for k, v in entry["xattrs"].items():
            txn.setattr(cid, oid, k, v)
        if entry["omap"]:
            txn.omap_setkeys(cid, oid, entry["omap"])
    store.apply_transaction(txn)
    print(f"imported {len(dump['objects'])} objects into {cid}",
          file=out)


def op_dump(store, pgid: str, oid: str, out=sys.stdout) -> dict:
    cid = f"pg_{pgid}"
    info = {
        "size": store.stat(cid, oid)["size"],
        "xattrs": sorted(store.getattrs(cid, oid)),
        "omap_keys": sorted(store.omap_get(cid, oid)),
    }
    print(denc_pretty(info), file=out)
    return info


def denc_pretty(obj) -> str:
    import json
    return json.dumps(obj, indent=2, default=str)


def op_remove(store, pgid: str, oid: str, out=sys.stdout) -> None:
    txn = Transaction().remove(f"pg_{pgid}", oid)
    store.apply_transaction(txn)
    print(f"removed pg_{pgid}/{oid}", file=out)


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="ceph-objectstore-tool")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--op", required=True,
                        choices=["list", "export", "import", "dump",
                                 "remove"])
    parser.add_argument("--pgid")
    parser.add_argument("--oid")
    parser.add_argument("--file")
    args = parser.parse_args(argv)
    required = {"export": ("pgid", "file"), "import": ("file",),
                "dump": ("pgid", "oid"), "remove": ("pgid", "oid")}
    for field in required.get(args.op, ()):
        if getattr(args, field) is None:
            parser.error(f"--op {args.op} requires --{field}")
    store = open_store(args.data_path)
    try:
        if args.op == "list":
            op_list(store, args.pgid, out=out)
        elif args.op == "export":
            op_export(store, args.pgid, args.file, out=out)
        elif args.op == "import":
            op_import(store, args.file, out=out)
        elif args.op == "dump":
            op_dump(store, args.pgid, args.oid, out=out)
        elif args.op == "remove":
            op_remove(store, args.pgid, args.oid, out=out)
        return 0
    except StoreError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
