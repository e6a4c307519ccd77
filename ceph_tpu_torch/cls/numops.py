"""cls_numops: atomic arithmetic on omap values (cls/numops/
cls_numops.cc semantics): read-modify-write of a numeric cell happens
in ONE in-OSD op, so concurrent adders never lose updates.
"""

from __future__ import annotations

from ..utils import denc
from . import WR, ClsError, MethodContext, cls_method


def _apply(ctx: MethodContext, key: str, fn) -> bytes:
    if not ctx.exists():
        ctx.create()
    raw = ctx.omap_get([key]).get(key)
    try:
        cur = float(raw) if raw is not None else 0.0
    except ValueError:
        raise ClsError(22, f"non-numeric value at {key!r}")
    new = fn(cur)
    rep = repr(int(new)) if float(new).is_integer() else repr(new)
    ctx.omap_set({key: rep.encode()})
    return denc.dumps(float(new))


@cls_method("numops", "add", WR)
def add(ctx: MethodContext) -> bytes:
    """{"key", "value"} -> new value (missing cell counts as 0)."""
    req = denc.loads(ctx.input)
    return _apply(ctx, str(req["key"]),
                  lambda cur: cur + float(req.get("value", 0)))


@cls_method("numops", "sub", WR)
def sub(ctx: MethodContext) -> bytes:
    req = denc.loads(ctx.input)
    return _apply(ctx, str(req["key"]),
                  lambda cur: cur - float(req.get("value", 0)))


@cls_method("numops", "mul", WR)
def mul(ctx: MethodContext) -> bytes:
    req = denc.loads(ctx.input)
    return _apply(ctx, str(req["key"]),
                  lambda cur: cur * float(req.get("value", 1)))
