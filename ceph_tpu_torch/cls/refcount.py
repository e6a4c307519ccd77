"""cls_refcount: shared-object reference counting (cls/refcount/
cls_refcount.cc semantics).

RGW-style dedup: several logical objects point at one RADOS object,
each holding a distinct TAG.  `get` adds a tag, `put` drops one and
REMOVES the object when the last tag goes; `set` replaces the whole
tag set (migration/repair).  An untagged object (never ref-counted)
defaults to one implicit reference, matching the reference's
implicit_ref behavior: a bare `put` on it removes it.
"""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method

XATTR = "refcount"


def _read_refs(ctx: MethodContext) -> list[str] | None:
    blob = ctx.getxattr(XATTR)
    if blob is None:
        return None
    refs = denc.loads(blob)
    if not isinstance(refs, list):
        raise ClsError(5, "corrupt refcount xattr")
    return refs


@cls_method("refcount", "get", WR)
def get(ctx: MethodContext) -> None:
    """{"tag": str} — add a reference."""
    req = denc.loads(ctx.input)
    tag = str(req.get("tag", ""))
    if not tag:
        raise ClsError(22, "refcount.get needs a tag")
    if not ctx.exists():
        raise ClsError(2, "no such object")
    refs = _read_refs(ctx) or []
    if tag not in refs:
        refs.append(tag)
    ctx.setxattr(XATTR, denc.dumps(refs))


@cls_method("refcount", "put", WR)
def put(ctx: MethodContext) -> bytes:
    """{"tag": str} — drop a reference; removes the object when the
    last one goes.  Returns the remaining count."""
    req = denc.loads(ctx.input)
    tag = str(req.get("tag", ""))
    if not ctx.exists():
        raise ClsError(2, "no such object")
    refs = _read_refs(ctx)
    if refs is None:
        # implicit single reference (cls_refcount implicit_ref): any
        # put on a never-tagged object releases it
        ctx.remove()
        return denc.dumps(0)
    if tag in refs:
        refs.remove(tag)
    elif req.get("strict"):
        raise ClsError(2, f"no such tag {tag!r}")
    if refs:
        ctx.setxattr(XATTR, denc.dumps(refs))
    else:
        ctx.remove()
    return denc.dumps(len(refs))


@cls_method("refcount", "set", WR)
def set_refs(ctx: MethodContext) -> None:
    """{"refs": [tags]} — replace the tag set outright."""
    req = denc.loads(ctx.input)
    refs = [str(t) for t in req.get("refs", [])]
    if not ctx.exists():
        raise ClsError(2, "no such object")
    if not refs:
        ctx.remove()
        return
    ctx.setxattr(XATTR, denc.dumps(refs))


@cls_method("refcount", "read", RD)
def read(ctx: MethodContext) -> bytes:
    """-> [tags] (empty list = implicit single ref)."""
    if not ctx.exists():
        raise ClsError(2, "no such object")
    return denc.dumps(_read_refs(ctx) or [])
