"""cls_kvstore: a flat distributed KV service over object omaps — the
key_value_store/kv_flat_btree_async.cc analog at its useful core:
server-side conditional updates so concurrent clients serialize in-OSD
instead of read-modify-writing racily."""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method


@cls_method("kvstore", "put", WR)
def put(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)      # {"kv": {k: v}, "if_absent": bool}
    if not ctx.exists():
        ctx.create()
    if req.get("if_absent"):
        cur = ctx.omap_get(list(req["kv"]))
        dup = [k for k in req["kv"] if k in cur]
        if dup:
            raise ClsError(17, f"keys exist: {dup}")
    ctx.omap_set({k: bytes(v) for k, v in req["kv"].items()})


@cls_method("kvstore", "get", RD)
def get(ctx: MethodContext) -> bytes:
    keys = denc.loads(ctx.input)
    return denc.dumps(ctx.omap_get(keys if keys else None))


@cls_method("kvstore", "rm", WR)
def rm(ctx: MethodContext) -> None:
    keys = denc.loads(ctx.input)
    cur = ctx.omap_get(keys)
    missing = [k for k in keys if k not in cur]
    if missing:
        raise ClsError(2, f"no such keys: {missing}")
    ctx.omap_rm(keys)


@cls_method("kvstore", "cas", WR)
def cas(ctx: MethodContext) -> None:
    """Compare-and-swap one key (the btree-split building block)."""
    req = denc.loads(ctx.input)      # {"key", "expect": bytes|None, "value"}
    cur = ctx.omap_get([req["key"]]).get(req["key"])
    expect = req.get("expect")
    if cur != (bytes(expect) if expect is not None else None):
        raise ClsError(125, "compare failed")         # ECANCELED
    if not ctx.exists():
        ctx.create()
    ctx.omap_set({req["key"]: bytes(req["value"])})


# -- flat-btree primitives (kv_flat_btree_async.cc's in-OSD helpers) -----
#
# The distributed B-tree (client/kv_btree.py) serializes its structural
# races inside the OSD: every leaf mutation is guarded by the leaf's
# version cell, and index transitions are single-round-trip
# check-and-apply ops, so a concurrent split/merge can never interleave
# half-applied with a write (the reference's assert_version +
# prefix-marked index updates, kv_flat_btree_async.cc:585).


def _check_guards(cur: dict, guards: dict, what: str) -> None:
    """Every guard cell must hold its expected value (None = absent),
    else ECANCELED — the structure changed under the caller."""
    for gk, expect in guards.items():
        have = cur.get(gk)
        want = bytes(expect) if expect is not None else None
        if have != want:
            raise ClsError(125, f"{what} {gk!r} mismatch")


@cls_method("kvstore", "put_guarded", WR)
def put_guarded(ctx: MethodContext) -> bytes:
    """{"kv", "guard": {key: expect|None}} -> entry count after write.

    ECANCELED when any guard cell differs — the leaf was split/merged/
    killed under us and the caller must re-walk the index.
    """
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    # one full read serves guards AND the size answer (omap_get reads
    # the store, not this txn, so the count must be computed from the
    # pre-image + this write's keys)
    cur = ctx.omap_get(None)
    _check_guards(cur, req.get("guard", {}), "guard")
    ctx.omap_set({k: bytes(v) for k, v in req["kv"].items()})
    keys = set(cur) | set(req["kv"])
    return denc.dumps(sum(1 for k in keys if not k.startswith("\x00")))


@cls_method("kvstore", "rm_guarded", WR)
def rm_guarded(ctx: MethodContext) -> bytes:
    """{"keys", "guard": {...}} -> entry count after removal.  ENOENT
    when a key is absent; ECANCELED on guard mismatch."""
    req = denc.loads(ctx.input)
    cur = ctx.omap_get(None)
    _check_guards(cur, req.get("guard", {}), "guard")
    missing = [k for k in req["keys"] if k not in cur]
    if missing:
        raise ClsError(2, f"no such keys: {missing}")
    ctx.omap_rm(req["keys"])
    keys = set(cur) - set(req["keys"])
    return denc.dumps(sum(1 for k in keys if not k.startswith("\x00")))


@cls_method("kvstore", "update_index", WR)
def update_index(ctx: MethodContext) -> None:
    """Atomic index transition: {"expect": {key: blob|None},
    "set": {key: blob}, "rm": [keys]}.  All expectations must hold or
    nothing applies (the split/merge commit point)."""
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    cur = ctx.omap_get(list(req.get("expect", {})))
    _check_guards(cur, req.get("expect", {}), "index expect")
    if req.get("rm"):
        present = ctx.omap_get(req["rm"])
        ctx.omap_rm([k for k in req["rm"] if k in present])
    if req.get("set"):
        ctx.omap_set({k: bytes(v) for k, v in req["set"].items()})


@cls_method("kvstore", "append_log", WR)
def append_log(ctx: MethodContext) -> bytes:
    """{"entry": bytes} -> seq.  Atomic sequenced append (the cls_rgw
    bilog/cls_log pattern): seq allocation and the entry write happen
    in ONE in-OSD op, so concurrent writers can neither collide on a
    seq nor clobber each other's entries."""
    req = denc.loads(ctx.input)
    if not ctx.exists():
        ctx.create()
    cur = ctx.omap_get(["\x00seq"])
    seq = int(cur.get("\x00seq", b"0")) + 1
    ctx.omap_set({"\x00seq": str(seq).encode(),
                  f"{seq:020d}": bytes(req["entry"])})
    return denc.dumps(seq)
