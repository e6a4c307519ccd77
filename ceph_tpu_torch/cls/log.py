"""cls_log: timestamped log objects (cls/log/cls_log.cc semantics).

RGW's metadata/data changelogs ride this: add entries stamped with a
monotonic section+timestamp key, list from a marker, trim up to a
bound.  Entries land in the omap keyed ``<stamp>_<seq>`` so listing is
a ranged read in time order.
"""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method, page_omap

SEQ_KEY = "\x00seq"


def _entry_key(stamp: float, seq: int) -> str:
    return f"{int(stamp * 1e6):017d}_{seq:012d}"


@cls_method("log", "add", WR)
def add(ctx: MethodContext) -> bytes:
    """{"entries": [{"section", "name", "data", "stamp"?}]} -> count.
    Stamps default to now; the per-object seq breaks same-tick ties."""
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    cur = ctx.omap_get([SEQ_KEY])
    seq = int(cur.get(SEQ_KEY, b"0"))
    out = {}
    for ent in req.get("entries", []):
        seq += 1
        stamp = (float(ent["stamp"]) if ent.get("stamp") is not None
                 else ctx.now())
        out[_entry_key(stamp, seq)] = denc.dumps({
            "section": str(ent.get("section", "")),
            "name": str(ent.get("name", "")),
            "stamp": stamp,
            "data": bytes(ent.get("data", b"")),
        })
    out[SEQ_KEY] = str(seq).encode()
    ctx.omap_set(out)
    return denc.dumps(len(out) - 1)


@cls_method("log", "list", RD)
def list_entries(ctx: MethodContext) -> bytes:
    """{"marker"?, "max_entries"?} -> {"entries": [...], "marker",
    "truncated"}.  Markers are opaque entry keys."""
    req = denc.loads(ctx.input) if ctx.input else {}
    return denc.dumps(page_omap(
        ctx.omap_get(None), str(req.get("marker", "")), "\x7f",
        int(req.get("max_entries", 1000))))


@cls_method("log", "trim", WR)
def trim(ctx: MethodContext) -> None:
    """{"to_marker"}: drop every entry at or before the marker."""
    req = denc.loads(ctx.input)
    to = str(req.get("to_marker", ""))
    if not to:
        raise ClsError(22, "log.trim needs to_marker")
    omap = ctx.omap_get(None)
    victims = [k for k in omap
               if not k.startswith("\x00") and k <= to]
    if victims:
        ctx.omap_rm(victims)
