"""cls_version: object version cells with conditional checks
(cls/version/cls_version.cc semantics).

RGW leans on this for metadata-cache coherence: every mutation bumps
(ver, tag); readers compare.  Conditions mirror the reference's
VER_COND_* set; a failed condition is ECANCELED so callers can retry
their read-modify-write.
"""

from __future__ import annotations

import uuid

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method

XATTR = "obj_version"

EQ, GT, GE, LT, LE, TAG_EQ, TAG_NE = (
    "eq", "gt", "ge", "lt", "le", "tag_eq", "tag_ne")


def _read_ver(ctx: MethodContext) -> dict:
    blob = ctx.getxattr(XATTR)
    if blob is None:
        return {"ver": 0, "tag": ""}
    return denc.loads(blob)


def _check(cur: dict, conds: list) -> None:
    for cond in conds:
        op, ver, tag = cond.get("op"), cond.get("ver", 0), \
            cond.get("tag", "")
        ok = {
            EQ: cur["ver"] == ver,
            GT: cur["ver"] > ver,
            GE: cur["ver"] >= ver,
            LT: cur["ver"] < ver,
            LE: cur["ver"] <= ver,
            TAG_EQ: cur["tag"] == tag,
            TAG_NE: cur["tag"] != tag,
        }.get(op)
        if ok is None:
            raise ClsError(22, f"bad version cond {op!r}")
        if not ok:
            raise ClsError(125, f"version cond {op} failed "
                                f"(cur v{cur['ver']} tag "
                                f"{cur['tag']!r})")     # ECANCELED


@cls_method("version", "set", WR)
def set_ver(ctx: MethodContext) -> None:
    """{"ver": int, "tag": str} — pin an explicit version."""
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    ctx.setxattr(XATTR, denc.dumps(
        {"ver": int(req.get("ver", 0)),
         "tag": str(req.get("tag", ""))}))


@cls_method("version", "inc", WR)
def inc(ctx: MethodContext) -> bytes:
    """{"conds": [...]} — bump ver (mint a tag on first touch) after
    the conditions hold.  Returns the new version."""
    req = denc.loads(ctx.input) if ctx.input else {}
    cur = _read_ver(ctx)
    _check(cur, req.get("conds", []))
    if not ctx.exists():
        ctx.create()
    new = {"ver": cur["ver"] + 1,
           "tag": cur["tag"] or uuid.uuid4().hex[:16]}
    ctx.setxattr(XATTR, denc.dumps(new))
    return denc.dumps(new)


@cls_method("version", "read", RD)
def read(ctx: MethodContext) -> bytes:
    return denc.dumps(_read_ver(ctx))


@cls_method("version", "check", RD)
def check(ctx: MethodContext) -> None:
    """{"conds": [...]} — pure conditional gate (readers pair it with
    a read op in one exec)."""
    req = denc.loads(ctx.input)
    _check(_read_ver(ctx), req.get("conds", []))
