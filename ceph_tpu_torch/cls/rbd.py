"""cls_rbd: image header + directory methods (cls/rbd/cls_rbd.cc).

Image metadata lives in the header object's omap: size, order (object
size = 2^order), snapshot table (name -> pool snap id), and arbitrary
image-meta keys.  The rbd_directory object maps image names for `rbd
ls`.  All mutation happens in-OSD so concurrent clients serialize on
the object like the reference.
"""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method

HDR_KEY = "rbd.header"


def _load_hdr(ctx: MethodContext) -> dict:
    blob = ctx.omap_get([HDR_KEY]).get(HDR_KEY)
    if not blob:
        raise ClsError(2, "no rbd header")
    return denc.loads(blob)


def _save_hdr(ctx: MethodContext, hdr: dict) -> None:
    ctx.omap_set({HDR_KEY: denc.dumps(hdr)})


@cls_method("rbd", "create", WR)
def create(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)
    if ctx.omap_get([HDR_KEY]).get(HDR_KEY):
        raise ClsError(17, "image exists")            # EEXIST
    order = int(req.get("order", 22))
    if not 12 <= order <= 26:
        raise ClsError(22, f"bad order {order}")
    ctx.create()
    _save_hdr(ctx, {"size": int(req["size"]), "order": order,
                    "snaps": {}, "meta": {}})


@cls_method("rbd", "get_info", RD)
def get_info(ctx: MethodContext) -> bytes:
    return denc.dumps(_load_hdr(ctx))


@cls_method("rbd", "set_size", WR)
def set_size(ctx: MethodContext) -> None:
    hdr = _load_hdr(ctx)
    hdr["size"] = int(denc.loads(ctx.input))
    _save_hdr(ctx, hdr)


@cls_method("rbd", "snap_add", WR)
def snap_add(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)     # {"name":..., "snapid":...}
    hdr = _load_hdr(ctx)
    if req["name"] in hdr["snaps"]:
        raise ClsError(17, f"snap {req['name']} exists")
    hdr["snaps"][req["name"]] = {"id": int(req["snapid"]),
                                 "size": hdr["size"]}
    _save_hdr(ctx, hdr)


@cls_method("rbd", "snap_remove", WR)
def snap_remove(ctx: MethodContext) -> bytes:
    name = denc.loads(ctx.input)
    hdr = _load_hdr(ctx)
    snap = hdr["snaps"].pop(name, None)
    if snap is None:
        raise ClsError(2, f"no snap {name}")
    _save_hdr(ctx, hdr)
    return denc.dumps(snap["id"])


@cls_method("rbd", "metadata_set", WR)
def metadata_set(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)
    hdr = _load_hdr(ctx)
    hdr["meta"][req["key"]] = req["value"]
    _save_hdr(ctx, hdr)


@cls_method("rbd", "metadata_get", RD)
def metadata_get(ctx: MethodContext) -> bytes:
    key = denc.loads(ctx.input)
    hdr = _load_hdr(ctx)
    if key not in hdr["meta"]:
        raise ClsError(2, f"no metadata {key}")
    return denc.dumps(hdr["meta"][key])


# -- rbd_directory ----------------------------------------------------------

@cls_method("rbd", "dir_add", WR)
def dir_add(ctx: MethodContext) -> None:
    name = denc.loads(ctx.input)
    if ctx.omap_get([f"name.{name}"]).get(f"name.{name}"):
        raise ClsError(17, f"image {name} exists")
    if not ctx.exists():
        ctx.create()
    ctx.omap_set({f"name.{name}": b"1"})


@cls_method("rbd", "dir_remove", WR)
def dir_remove(ctx: MethodContext) -> None:
    name = denc.loads(ctx.input)
    if not ctx.omap_get([f"name.{name}"]).get(f"name.{name}"):
        raise ClsError(2, f"no image {name}")
    ctx.omap_rm([f"name.{name}"])


@cls_method("rbd", "dir_list", RD)
def dir_list(ctx: MethodContext) -> bytes:
    names = sorted(k[len("name."):] for k in ctx.omap_get()
                   if k.startswith("name."))
    return denc.dumps(names)


# -- layering: parent spec, snap protection, children index -----------------
# (cls/rbd/cls_rbd.cc set_parent/remove_parent/get_protection_status/
#  set_protection_status + child_attach semantics, reduced)

@cls_method("rbd", "set_parent", WR)
def set_parent(ctx: MethodContext) -> None:
    spec = denc.loads(ctx.input)   # {"pool","image","snap","snap_id",
    hdr = _load_hdr(ctx)           #  "overlap"}
    if hdr.get("parent"):
        raise ClsError(17, "parent already set")
    hdr["parent"] = dict(spec)
    _save_hdr(ctx, hdr)


@cls_method("rbd", "remove_parent", WR)
def remove_parent(ctx: MethodContext) -> None:
    hdr = _load_hdr(ctx)
    if not hdr.get("parent"):
        raise ClsError(2, "no parent")
    hdr["parent"] = None
    _save_hdr(ctx, hdr)


@cls_method("rbd", "snap_protect", WR)
def snap_protect(ctx: MethodContext) -> None:
    name = denc.loads(ctx.input)
    hdr = _load_hdr(ctx)
    if name not in hdr["snaps"]:
        raise ClsError(2, f"no snap {name}")
    hdr["snaps"][name]["protected"] = True
    _save_hdr(ctx, hdr)


@cls_method("rbd", "snap_unprotect", WR)
def snap_unprotect(ctx: MethodContext) -> None:
    name = denc.loads(ctx.input)
    hdr = _load_hdr(ctx)
    if name not in hdr["snaps"]:
        raise ClsError(2, f"no snap {name}")
    hdr["snaps"][name]["protected"] = False
    _save_hdr(ctx, hdr)


# rbd_children object: (parent image, snap) -> child specs, kept in the
# PARENT pool so unprotect can refuse while clones exist

def _child_key(req: dict) -> str:
    return f"child.{req['image']}.{req['snap']}"


@cls_method("rbd", "child_add", WR)
def child_add(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)    # {"image","snap","child_pool",
    if not ctx.exists():           #  "child_image"}
        ctx.create()
    key = _child_key(req)
    kids = denc.loads(ctx.omap_get([key]).get(key) or denc.dumps([]))
    ref = [req["child_pool"], req["child_image"]]
    if ref not in kids:
        kids.append(ref)
    ctx.omap_set({key: denc.dumps(kids)})


@cls_method("rbd", "child_remove", WR)
def child_remove(ctx: MethodContext) -> None:
    req = denc.loads(ctx.input)
    key = _child_key(req)
    kids = denc.loads(ctx.omap_get([key]).get(key) or denc.dumps([]))
    ref = [req["child_pool"], req["child_image"]]
    if ref in kids:
        kids.remove(ref)
    if kids:
        ctx.omap_set({key: denc.dumps(kids)})
    else:
        ctx.omap_rm([key])


@cls_method("rbd", "children_list", RD)
def children_list(ctx: MethodContext) -> bytes:
    req = denc.loads(ctx.input)
    key = _child_key(req)
    if not ctx.exists():
        return denc.dumps([])
    return denc.dumps(
        denc.loads(ctx.omap_get([key]).get(key) or denc.dumps([])))


@cls_method("rbd", "set_parent_overlap", WR)
def set_parent_overlap(ctx: MethodContext) -> None:
    """Shrink the parent overlap (librbd shrink semantics: a resize
    below the overlap permanently reduces what the parent backs)."""
    n = int(denc.loads(ctx.input))
    hdr = _load_hdr(ctx)
    if not hdr.get("parent"):
        raise ClsError(2, "no parent")
    hdr["parent"]["overlap"] = min(hdr["parent"]["overlap"], n)
    _save_hdr(ctx, hdr)
