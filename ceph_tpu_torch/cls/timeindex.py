"""cls_timeindex: time-keyed index objects (cls/timeindex/
cls_timeindex.cc semantics): entries keyed by (stamp, name) for
ranged time-window queries — RGW's sync-status and usage indexes
lean on it.
"""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method, page_omap


def _key(stamp: float, name: str) -> str:
    return f"{int(stamp * 1e6):017d}~{name}"


@cls_method("timeindex", "add", WR)
def add(ctx: MethodContext) -> None:
    """{"entries": [{"name", "value", "stamp"?}]}."""
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    out = {}
    for ent in req.get("entries", []):
        stamp = (float(ent["stamp"]) if ent.get("stamp") is not None
                 else ctx.now())
        out[_key(stamp, str(ent.get("name", "")))] = denc.dumps({
            "stamp": stamp,
            "name": str(ent.get("name", "")),
            "value": bytes(ent.get("value", b"")),
        })
    if out:
        ctx.omap_set(out)


@cls_method("timeindex", "list", RD)
def list_entries(ctx: MethodContext) -> bytes:
    """{"from"?, "to"?, "marker"?, "max_entries"?} -> page of entries
    within the [from, to) stamp window."""
    req = denc.loads(ctx.input) if ctx.input else {}
    lo = _key(float(req.get("from", 0.0)), "")
    hi = _key(float(req["to"]), "") if "to" in req else "\x7f"
    marker = str(req.get("marker", "")) or lo
    return denc.dumps(page_omap(
        ctx.omap_get(None), marker, hi,
        int(req.get("max_entries", 1000))))


@cls_method("timeindex", "trim", WR)
def trim(ctx: MethodContext) -> None:
    """{"from"?, "to"}: drop entries with stamp in [from, to)."""
    req = denc.loads(ctx.input)
    if "to" not in req:
        raise ClsError(22, "timeindex.trim needs to")
    lo = _key(float(req.get("from", 0.0)), "")
    hi = _key(float(req["to"]), "")
    omap = ctx.omap_get(None)
    victims = [k for k in omap
               if not k.startswith("\x00") and lo <= k < hi]
    if victims:
        ctx.omap_rm(victims)
