"""pglog-dump: offline PG log inspection for debugging peering wedges.

The log-authoritative peering plane makes every recovery decision from
the PGLog (bounds election, divergence, missing sets, the backfill
watermark) — so when a soak wedges, the question is always "what do
the two copies' logs actually say?".  This tool answers it against
stopped stores (the ceph-objectstore-tool pattern: the OSD must not be
running):

    python -m ceph_tpu_torch.tools.pglog_dump --data-path /path/osd0 \
        --pgid 1.3                     # bounds + index/missing summary
    ... --pgid 1.3 --entries           # full entry listing
    ... --pgid 1.3 --peer-path /path/osd1
        # divergence report: rewind point, each side's divergent
        # suffix, and the log-delta missing set each way

Output is JSON (one document) so the soaks can assert on it.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..osd.pglog import (BACKFILL_ATTR, LES_ATTR, PGLog,
                         decode_backfill_attr)
from ..store import create as store_create
from ..store.objectstore import StoreError


def _open_store(path: str):
    store = store_create("filestore", path)
    store.mount()
    return store


def load_pg_state(store, pgid: str) -> dict:
    """Decode one pg's persisted peering state: the PGLog blob plus
    the last_backfill watermark and last_epoch_started stamps."""
    cid = f"pg_{pgid}"
    if not store.collection_exists(cid):
        raise StoreError(2, f"no collection {cid}")
    try:
        log = PGLog.decode(store.getattr(cid, "_pgmeta", "log"))
    except StoreError:
        log = PGLog()
    last_backfill = None        # None == complete
    try:
        last_backfill = decode_backfill_attr(
            store.getattr(cid, "_pgmeta", BACKFILL_ATTR))
    except StoreError:
        pass
    les = 0
    try:
        les = int(store.getattr(cid, "_pgmeta", LES_ATTR).decode())
    except (StoreError, ValueError):
        pass
    return {"pgid": pgid, "log": log, "last_backfill": last_backfill,
            "last_epoch_started": les}


def summarize(state: dict, entries: bool = False) -> dict:
    log: PGLog = state["log"]
    out = {
        "pgid": state["pgid"],
        "last_update": list(log.head),
        "log_tail": list(log.tail),
        "last_epoch_started": state["last_epoch_started"],
        "entries": len(log.entries),
        "objects": len(log.objects),
        "deleted": len(log.deleted),
        "missing": {o: list(v) for o, v in sorted(log.missing.items())},
        "backfill_complete": state["last_backfill"] is None,
        "last_backfill": state["last_backfill"],
    }
    if entries:
        out["log"] = [
            {"ev": list(e["ev"]), "oid": e["oid"], "op": e["op"],
             "prior": (list(e["prior"])
                       if e.get("prior") is not None else None)}
            for e in log.entries]
    return out


def divergence_report(mine: dict, theirs: dict) -> dict:
    """Both directions of the peering comparison: treating each side
    as authoritative, where would the other rewind to, what is its
    divergent suffix, and what log delta (missing set) would recovery
    push — exactly what _peering_done/_divergent_reconcile compute."""
    my_log: PGLog = mine["log"]
    their_log: PGLog = theirs["log"]

    def one_way(auth: PGLog, cand: PGLog) -> dict:
        rewind_to, divergent = auth.find_divergence(cand.entries)
        delta = auth.entries_since(
            min(tuple(cand.head), tuple(auth.head))
            if auth.contains(cand.head) else rewind_to)
        missing: dict[str, list] = {}
        if delta is not None:
            for e in delta:
                if e["op"] == "delete":
                    missing.pop(e["oid"], None)
                else:
                    missing[e["oid"]] = list(e["ev"])
        return {
            "rewind_to": list(rewind_to),
            "divergent_entries": [
                {"ev": list(e["ev"]), "oid": e["oid"], "op": e["op"]}
                for e in divergent],
            "peer_contained": auth.contains(cand.head),
            "delta_missing": missing if delta is not None else None,
            "needs_backfill": delta is None,
        }

    return {
        "mine_as_auth": one_way(my_log, their_log),
        "theirs_as_auth": one_way(their_log, my_log),
        "heads": {"mine": list(my_log.head),
                  "theirs": list(their_log.head)},
    }


def main(argv=None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(prog="pglog-dump")
    parser.add_argument("--data-path", required=True,
                        help="stopped OSD store (filestore path)")
    parser.add_argument("--pgid", help="pg to dump; omit to list pgs")
    parser.add_argument("--peer-path",
                        help="second store: divergence report vs it")
    parser.add_argument("--entries", action="store_true",
                        help="include the full entry listing")
    args = parser.parse_args(argv)
    store = _open_store(args.data_path)
    peer_store = None
    try:
        if not args.pgid:
            pgs = sorted(c[3:] for c in store.list_collections()
                         if c.startswith("pg_"))
            print(json.dumps({"pgs": pgs}, indent=2), file=out)
            return 0
        doc = summarize(load_pg_state(store, args.pgid),
                        entries=args.entries)
        if args.peer_path:
            peer_store = _open_store(args.peer_path)
            doc["divergence"] = divergence_report(
                load_pg_state(store, args.pgid),
                load_pg_state(peer_store, args.pgid))
        print(json.dumps(doc, indent=2), file=out)
        return 0
    except StoreError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        store.umount()
        if peer_store is not None:
            peer_store.umount()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
