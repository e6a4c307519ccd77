"""cls_lock: advisory object locks (cls/lock/cls_lock.cc semantics).

Locks live in an omap-backed table on the object: name -> {type,
holders: {(entity, cookie): tag}}.  Exclusive locks admit one holder;
shared locks admit many.  librbd's exclusive-lock feature is built on
exactly this class in the reference.
"""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method

LOCK_KEY = "lock.state"
EXCLUSIVE = "exclusive"
SHARED = "shared"


def _load(ctx: MethodContext) -> dict:
    blob = ctx.omap_get([LOCK_KEY]).get(LOCK_KEY)
    return denc.loads(blob) if blob else {}


def _save(ctx: MethodContext, locks: dict) -> None:
    ctx.omap_set({LOCK_KEY: denc.dumps(locks)})


@cls_method("lock", "lock", WR)
def lock(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)
    name, ltype = req["name"], req.get("type", EXCLUSIVE)
    holder = (req["entity"], req.get("cookie", ""))
    locks = _load(ctx)
    cur = locks.get(name)
    if cur is not None:
        holders = {tuple(h) for h in cur["holders"]}
        if holder in holders:
            raise ClsError(17, "already held by you")       # EEXIST
        if cur["type"] == EXCLUSIVE or ltype == EXCLUSIVE:
            raise ClsError(16, f"lock {name} held")         # EBUSY
        holders.add(holder)
        cur["holders"] = sorted(list(h) for h in holders)
    else:
        locks[name] = {"type": ltype, "holders": [list(holder)],
                       "tag": req.get("tag", "")}
    if not ctx.exists():
        ctx.create()
    _save(ctx, locks)


def _remove_holder(ctx: MethodContext, errmsg: str) -> None:
    req = denc.loads(ctx.input)
    name = req["name"]
    holder = [req["entity"], req.get("cookie", "")]
    locks = _load(ctx)
    cur = locks.get(name)
    if cur is None or holder not in cur["holders"]:
        raise ClsError(2, errmsg.format(name=name, holder=holder))
    cur["holders"].remove(holder)
    if not cur["holders"]:
        del locks[name]
    _save(ctx, locks)


@cls_method("lock", "unlock", WR)
def unlock(ctx: MethodContext) -> None:
    _remove_holder(ctx, "lock {name} not held by {holder}")


@cls_method("lock", "break_lock", WR)
def break_lock(ctx: MethodContext) -> None:
    """Forcibly evict ANOTHER client's holder (admin/failover path —
    same mechanics as unlock; the caller names the victim)."""
    _remove_holder(ctx, "lock {name}: no such holder {holder}")


@cls_method("lock", "get_info", RD)
def get_info(ctx: MethodContext) -> bytes:
    req = denc.loads(ctx.input) if ctx.input else {}
    locks = _load(ctx)
    name = req.get("name")
    return denc.dumps(locks.get(name) if name else locks)
