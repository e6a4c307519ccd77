"""RBD: block images over RADOS (librbd analog).

The reference's librbd (librbd/ImageCtx.cc, AioImageRequest,
operation/*) reduced to its load-bearing shape:

  * header object rbd_header.<name>: size/order/snap table via cls_rbd
    (all metadata mutation is in-OSD, so clients serialize);
  * data objects rbd_data.<name>.<object_no>, object size 2^order,
    addressed with the striper extent math (sc=1, su=object_size —
    the standard rbd layout);
  * image snapshots = pool self-managed snaps recorded in the header;
    an image opened at a snapshot is read-only and reads resolve
    through the clone machinery;
  * exclusive lock via cls_lock on the header (ExclusiveLock model);
  * header watch: writers notify after size/snapshot changes and other
    openers refresh (ImageWatcher model);
  * layering (librbd/CopyupRequest.cc, cls_rbd parent/children): a
    clone's header carries a parent spec; reads of absent child
    objects fall through to the parent snapshot below the overlap,
    partial writes COPY UP the parent block first, `flatten` copies
    every parent-backed object then detaches;
  * image journaling (librbd/Journal.cc): when enabled, every mutating
    op appends an event to a per-image Journaler BEFORE applying, so
    a player (`replay_journal`) can reproduce the image elsewhere —
    the rbd-mirror data path.
"""

from __future__ import annotations

import itertools
import threading

from ..client.rados import RadosError
from ..client.striper import Extent, Layout, file_to_extents
from ..utils import denc

LOCK_NAME = "rbd_lock"


class RbdError(RadosError):
    pass


def header_oid(name: str) -> str:
    return f"rbd_header.{name}"


def data_oid(name: str, object_no: int) -> str:
    return f"rbd_data.{name}.{object_no:016x}"


DIRECTORY = "rbd_directory"
CHILDREN = "rbd_children"


def journal_prefix(name: str) -> str:
    return f"rbd_journal.{name}"


class RBD:
    """Pool-level image admin (librbd::RBD)."""

    def __init__(self, ioctx):
        self.io = ioctx

    def create(self, name: str, size: int, order: int = 22,
               journaling: bool = False) -> None:
        self.io.execute(DIRECTORY, "rbd", "dir_add", denc.dumps(name))
        try:
            self.io.execute(header_oid(name), "rbd", "create",
                            denc.dumps({"size": size, "order": order}))
            if journaling:
                self.io.execute(header_oid(name), "rbd", "metadata_set",
                                denc.dumps({"key": "journaling",
                                            "value": b"1"}))
        except RadosError:
            try:
                self.io.execute(DIRECTORY, "rbd", "dir_remove",
                                denc.dumps(name))
            except RadosError:
                pass
            raise

    def clone(self, parent_name: str, parent_snap: str,
              child_name: str, child_ioctx=None,
              journaling: bool = False) -> None:
        """Layered clone of a PROTECTED parent snapshot
        (librbd::clone + cls_rbd child_attach)."""
        child_io = child_ioctx or self.io
        with Image(self.io, parent_name, snapshot=parent_snap) as p:
            snap = p.hdr["snaps"][parent_snap]
            if not snap.get("protected"):
                raise RbdError(22, "parent snapshot is not protected")
            size, order = snap["size"], p.hdr["order"]
        RBD(child_io).create(child_name, size, order=order,
                             journaling=journaling)
        child_io.execute(
            header_oid(child_name), "rbd", "set_parent",
            denc.dumps({"pool": self.io.pool_name, "image": parent_name,
                        "snap": parent_snap, "snap_id": snap["id"],
                        "overlap": size}))
        self.io.execute(
            CHILDREN, "rbd", "child_add",
            denc.dumps({"image": parent_name, "snap": parent_snap,
                        "child_pool": child_io.pool_name,
                        "child_image": child_name}))

    def children(self, parent_name: str, parent_snap: str) -> list:
        return denc.loads(self.io.execute(
            CHILDREN, "rbd", "children_list",
            denc.dumps({"image": parent_name, "snap": parent_snap})))

    def list(self) -> list[str]:
        try:
            return denc.loads(self.io.execute(DIRECTORY, "rbd",
                                              "dir_list"))
        except RadosError as e:
            if e.errno == 2:
                return []
            raise

    def remove(self, name: str) -> None:
        img = Image(self.io, name)
        try:
            if img.hdr["snaps"]:
                raise RbdError(39, "image has snapshots")   # ENOTEMPTY
            parent = img.hdr.get("parent")
            if parent:
                # detach from the parent's children index
                pio = self.io.rados.open_ioctx(parent["pool"])
                try:
                    pio.execute(
                        CHILDREN, "rbd", "child_remove",
                        denc.dumps({"image": parent["image"],
                                    "snap": parent["snap"],
                                    "child_pool": self.io.pool_name,
                                    "child_image": name}))
                except RadosError:
                    pass
            objects = (img.size() + img.object_size - 1) \
                // img.object_size
            comps = [self.io.aio_remove(data_oid(name, i))
                     for i in range(objects)]
            for c in comps:
                c.wait_for_complete()
            for c in comps:
                try:
                    c.result()      # tolerate only "never written"
                except RadosError as e:
                    if e.errno != 2:
                        raise
            if img.journaling:
                # drop the image journal with the image — a same-name
                # successor must not inherit dead events
                from ..journal import Journaler
                try:
                    Journaler(self.io, journal_prefix(name)).remove()
                except RadosError:
                    pass
            self.io.remove_object(header_oid(name))
        finally:
            img.close()
        self.io.execute(DIRECTORY, "rbd", "dir_remove",
                        denc.dumps(name))


def replay_journal(src_ioctx, image_name: str, dst_image: "Image",
                   client_id: str = "mirror") -> int:
    """rbd-mirror's data path: replay a source image's journal onto a
    destination image, resuming from this client's commit position
    (journal/Journaler + librbd Journal replay).  Returns the number
    of events applied; calling again applies only NEW events."""
    from ..journal import Journaler
    j = Journaler(src_ioctx, journal_prefix(image_name),
                  client_id=client_id)
    j.open()
    j.register_client(client_id)
    start = j._commit_positions().get(client_id, 0)
    applied = 0
    pos = start
    for pos, blob in j.replay(start):
        ev = denc.loads(blob)
        op = ev["op"]
        try:
            if op == "write":
                if ev["off"] + len(ev["data"]) > dst_image.size():
                    dst_image.resize(ev["off"] + len(ev["data"]))
                dst_image.write(ev["off"], ev["data"])
            elif op == "discard":
                # a discard past the twin's current extent must grow it
                # first (the twin may start at size 0) or replay wedges
                # on RbdError(22) forever
                if ev["off"] + ev["len"] > dst_image.size():
                    dst_image.resize(ev["off"] + ev["len"])
                dst_image.discard(ev["off"], ev["len"])
            elif op == "resize":
                dst_image.resize(ev["size"])
            elif op == "snap_create":
                dst_image.snap_create(ev["name"])
            elif op == "snap_remove":
                dst_image.snap_remove(ev["name"])
        except RadosError as e:
            # an already-applied snap event (replay overlap after a
            # partial commit) must not wedge the mirror forever
            if op.startswith("snap") and e.errno in (2, 17):
                pass
            else:
                raise
        applied += 1
    if applied:
        j.commit(pos + 1)
    return applied


class Image:
    """An open image handle (librbd::Image)."""

    _lock_cookie = itertools.count(1)

    def __init__(self, ioctx, name: str, snapshot: str | None = None,
                 exclusive: bool = False, cache: bool = False,
                 cache_size: int = 32 << 20,
                 _mirror_replay: bool = False):
        # rbd-mirror's replay handle: writes through a demoted
        # (non-primary) image are allowed and are never re-journaled —
        # replaying a peer's events into our journal would bounce them
        # back and forth between the clusters forever
        self._mirror_replay = _mirror_replay
        # a private ioctx: the image's snap context must not leak into
        # the caller's other I/O
        self.io = ioctx.rados.open_ioctx(ioctx.pool_name)
        self.name = name
        self.snap_name = snapshot
        self._refresh_lock = threading.Lock()
        self._watch_cookie = None
        self._lock_held = False
        self._cookie = f"img-{next(Image._lock_cookie)}"
        self._parent: "Image | None" = None
        self._copyup_io = None     # snapc-free ioctx (copyup writes)
        self._journal = None
        # ObjectCacher (osdc/ObjectCacher.cc role): write-back data
        # cache, safe under the single-writer contract the reference's
        # librbd enforces with the exclusive lock.  Opt-in.
        self._cache = None
        if cache and snapshot is None:
            from ..client.object_cacher import ObjectCacher
            self._cache = ObjectCacher(
                max_size=cache_size, max_dirty=cache_size // 2,
                writer=lambda oid, off, data:
                    self.io.write(oid, data, offset=off))
        self.refresh()
        if snapshot is not None:
            if snapshot not in self.hdr["snaps"]:
                raise RbdError(2, f"no snapshot {snapshot}")
            self.snap_id = self.hdr["snaps"][snapshot]["id"]
        else:
            self.snap_id = None
            if exclusive:
                self._acquire_lock()
            # watch the header: other writers notify on metadata change
            try:
                self._watch_cookie = self.io.watch(
                    header_oid(name), self._on_notify)
            except RadosError:
                # a failed open must not strand the exclusive lock
                self.close()
                raise

    # -- metadata ----------------------------------------------------------

    def refresh(self) -> None:
        with self._refresh_lock:
            try:
                self.hdr = denc.loads(self.io.execute(
                    header_oid(self.name), "rbd", "get_info"))
            except RadosError as e:
                raise RbdError(e.errno,
                               f"no such image {self.name}") from e
            self.object_size = 1 << self.hdr["order"]
            self.layout = Layout(stripe_unit=self.object_size,
                                 stripe_count=1,
                                 object_size=self.object_size)
            self.parent_spec = self.hdr.get("parent")
            # writes carry the image's snap context so data objects COW
            snaps = sorted((s["id"] for s in self.hdr["snaps"].values()),
                           reverse=True)
            self.io.set_snap_context(snaps[0] if snaps else 0, snaps)

    # -- layering (clone/copyup) -------------------------------------------

    def _parent_image(self) -> "Image | None":
        if self._parent is None and self.parent_spec:
            pio = self.io.rados.open_ioctx(self.parent_spec["pool"])
            self._parent = Image(pio, self.parent_spec["image"],
                                 snapshot=self.parent_spec["snap"])
        return self._parent

    def _read_parent_range(self, offset: int, length: int) -> bytes:
        """Bytes the parent shows through an absent child object,
        clamped to the overlap."""
        overlap = self.parent_spec["overlap"]
        n = min(length, overlap - offset)
        if n <= 0:
            return b""
        return self._parent_image().read(offset, n)

    def _copyup_if_needed(self, object_no: int) -> None:
        """First write to a parent-backed, still-absent child object
        copies the parent block up (CopyupRequest.cc) so partial
        writes land on the inherited bytes."""
        if not self.parent_spec:
            return
        base = object_no * self.object_size
        overlap = self.parent_spec["overlap"]
        if base >= overlap:
            return
        oid = data_oid(self.name, object_no)
        try:
            self.io.stat(oid)
            return                 # child object exists: no copyup
        except RadosError as e:
            if e.errno != 2:
                raise
        n = min(self.object_size, overlap - base)
        # copyup writes BENEATH the image's snapshots (no snap
        # context): a snapshot taken on the clone before this object
        # materialized must still see the inherited parent bytes
        # (CopyupRequest writes with an empty snapc for the same
        # reason)
        if self._copyup_io is None:
            self._copyup_io = self.io.rados.open_ioctx(
                self.io.pool_name)
        self._copyup_io.write_full(
            oid, self._parent_image().read(base, n))

    def flatten(self) -> None:
        """Copy every parent-backed object into the child, then
        detach (librbd/operation/FlattenRequest)."""
        self._check_rw()
        if not self.parent_spec:
            raise RbdError(22, "image has no parent")
        if self._cache is not None:
            self._cache.flush()    # copyup probes the backing objects
        spec = self.parent_spec
        covered = min(spec["overlap"], self.size())
        objects = (covered + self.object_size - 1) // self.object_size
        for i in range(objects):
            self._copyup_if_needed(i)
        self.io.execute(header_oid(self.name), "rbd", "remove_parent",
                        b"")
        pio = self.io.rados.open_ioctx(spec["pool"])
        try:
            pio.execute(
                CHILDREN, "rbd", "child_remove",
                denc.dumps({"image": spec["image"], "snap": spec["snap"],
                            "child_pool": self.io.pool_name,
                            "child_image": self.name}))
        except RadosError:
            pass
        if self._parent is not None:
            self._parent.close()
            self._parent = None
        self.refresh()
        self._notify_peers()

    # -- image journaling (librbd/Journal.cc reduced) ----------------------

    @property
    def journaling(self) -> bool:
        return self.hdr.get("meta", {}).get("journaling") == b"1"

    def journaling_enable(self) -> None:
        self._check_rw()
        self.io.execute(header_oid(self.name), "rbd", "metadata_set",
                        denc.dumps({"key": "journaling", "value": b"1"}))
        self.refresh()
        self._notify_peers()

    # -- mirror primary state (ImageReplayer promote/demote) ---------------

    @property
    def is_primary(self) -> bool:
        """Absent flag = primary (only mirroring sets it)."""
        return self.hdr.get("meta", {}).get("primary") != b"0"

    def mirror_demote(self) -> None:
        """Stop accepting writes: the peer will be promoted.  The
        journal keeps its history so the (reversed) replayer can
        drain anything the peer has not consumed yet."""
        self.io.execute(header_oid(self.name), "rbd", "metadata_set",
                        denc.dumps({"key": "primary", "value": b"0"}))
        self.refresh()
        self._notify_peers()

    def mirror_promote(self) -> None:
        """Become the writable primary: mark primary and enable
        journaling so OUR writes replicate back to the demoted twin
        (two-way failover)."""
        self.io.execute(header_oid(self.name), "rbd", "metadata_set",
                        denc.dumps({"key": "primary", "value": b"1"}))
        self.io.execute(header_oid(self.name), "rbd", "metadata_set",
                        denc.dumps({"key": "journaling", "value": b"1"}))
        self.refresh()
        self._notify_peers()

    def _journal_event(self, ev: dict) -> None:
        """Write-ahead: the event lands in the journal BEFORE the data
        path applies it, so a player can always reproduce the image."""
        if not self.journaling or self.snap_name is not None or \
                self._mirror_replay:
            return
        from ..journal import Journaler
        if self._journal is None:
            j = Journaler(self.io, journal_prefix(self.name),
                          client_id="master")
            try:
                j.open()
            except RadosError:
                try:
                    j.create()
                except RadosError as e:
                    if e.errno != 17:     # a concurrent creator won
                        raise
                j.open()
            self._journal = j
        self._journal.append(denc.dumps(ev))

    def _on_notify(self, notify_id, payload) -> bytes:
        self.refresh()
        return b""

    def _notify_peers(self) -> None:
        try:
            self.io.notify(header_oid(self.name), b"refresh",
                           timeout=3.0)
        except RadosError:
            pass

    def size(self) -> int:
        if self.snap_name is not None:
            return self.hdr["snaps"][self.snap_name]["size"]
        return self.hdr["size"]

    def stat(self) -> dict:
        return {"size": self.size(), "order": self.hdr["order"],
                "num_objs": (self.size() + self.object_size - 1)
                // self.object_size,
                "snaps": sorted(self.hdr["snaps"])}

    # -- exclusive lock (cls_lock on the header) ---------------------------

    def _acquire_lock(self) -> None:
        try:
            self.io.execute(header_oid(self.name), "lock", "lock",
                            denc.dumps({"name": LOCK_NAME,
                                        "type": "exclusive",
                                        "entity": self.io.rados.msgr.name,
                                        "cookie": self._cookie}))
            self._lock_held = True
        except RadosError as e:
            raise RbdError(e.errno, "image is locked") from e

    def break_lock(self, entity: str, cookie: str) -> None:
        self.io.execute(header_oid(self.name), "lock", "break_lock",
                        denc.dumps({"name": LOCK_NAME, "entity": entity,
                                    "cookie": cookie}))

    def lock_info(self) -> dict | None:
        blob = self.io.execute(header_oid(self.name), "lock",
                               "get_info",
                               denc.dumps({"name": LOCK_NAME}))
        return denc.loads(blob)

    # -- data path ---------------------------------------------------------

    def _check_rw(self) -> None:
        if self.snap_name is not None:
            raise RbdError(30, "image open at a snapshot is read-only")
        if not self._mirror_replay and self.journaling and \
            self.hdr.get("meta", {}).get("primary") == b"0":
            # demoted mirror image: only the replayer may write
            # (ImageReplayer promote/demote, tools/rbd_mirror)
            raise RbdError(30, "image is not primary")

    def _check_bounds(self, offset: int, length: int) -> None:
        if offset < 0 or length < 0 or offset + length > self.size():
            raise RbdError(22, f"[{offset},{offset + length}) outside "
                           f"image of size {self.size()}")

    def write(self, offset: int, data: bytes) -> int:
        self._check_rw()
        data = bytes(data)
        self._check_bounds(offset, len(data))
        self._journal_event({"op": "write", "off": offset,
                             "data": data})
        extents = file_to_extents(self.layout, offset, len(data))
        if self._cache is not None:
            for ext in extents:
                if ext.length < self.object_size:
                    self._copyup_if_needed(ext.object_no)
                chunk = data[ext.logical_offset - offset:
                             ext.logical_offset - offset + ext.length]
                self._cache.write(data_oid(self.name, ext.object_no),
                                  ext.offset, chunk)
            return len(data)
        comps = []
        for ext in extents:
            if ext.length < self.object_size:
                # partial write into a parent-backed object: copy the
                # parent block up first (a full-object write defines
                # every byte, no copyup needed)
                self._copyup_if_needed(ext.object_no)
            chunk = data[ext.logical_offset - offset:
                         ext.logical_offset - offset + ext.length]
            comps.append(self.io.aio_write(
                data_oid(self.name, ext.object_no), chunk,
                offset=ext.offset))
        for c in comps:
            c.wait_for_complete()
        for c in comps:
            c.result()
        return len(data)

    def _fetch_extent(self, oid: str, off: int, length: int,
                      logical_off: int) -> bytes:
        """One extent's bytes from the backing objects, with the clone
        parent fallback — the cache-miss path."""
        try:
            piece = self.io.read(oid, length=length, offset=off)
        except RadosError as e:
            if e.errno != 2:
                raise
            piece = b""
        if not piece and self.parent_spec:
            piece = self._read_parent_range(logical_off, length)
        return piece

    def read(self, offset: int, length: int) -> bytes:
        self._check_bounds(offset, length)
        if self._cache is not None:
            buf = bytearray(length)
            misses = []
            for ext in file_to_extents(self.layout, offset, length):
                oid = data_oid(self.name, ext.object_no)
                piece = self._cache.try_read(oid, ext.offset,
                                             ext.length)
                if piece is None:
                    misses.append((ext, oid))
                    continue
                lo = ext.logical_offset - offset
                buf[lo: lo + len(piece)] = piece
            # cold extents fetch in PARALLEL like the uncached path
            comps = [(ext, oid, self.io.aio_read(
                oid, length=ext.length, offset=ext.offset))
                for ext, oid in misses]
            for ext, oid, c in comps:
                c.wait_for_complete()
                try:
                    piece = c.result()
                except RadosError as e:
                    if e.errno != 2:
                        raise
                    piece = b""
                if not piece and self.parent_spec:
                    piece = self._read_parent_range(ext.logical_offset,
                                                    ext.length)
                piece = self._cache.insert_clean(oid, ext.offset,
                                                 piece, ext.length)
                lo = ext.logical_offset - offset
                buf[lo: lo + len(piece)] = piece
            return bytes(buf)
        extents = file_to_extents(self.layout, offset, length)
        comps: list[tuple[Extent, object]] = []
        for ext in extents:
            oid = data_oid(self.name, ext.object_no)
            if self.snap_id is not None:
                c = self.io.rados.aio_submit(
                    self.io.snap_read, oid, self.snap_id, ext.length,
                    ext.offset)
            else:
                c = self.io.aio_read(oid, length=ext.length,
                                     offset=ext.offset)
            comps.append((ext, c))
        buf = bytearray(length)
        for ext, c in comps:
            c.wait_for_complete()
            try:
                piece = c.result()
            except RadosError as e:
                if e.errno != 2:
                    raise     # only ENOENT means "unwritten, zeros"
                piece = b""
            lo = ext.logical_offset - offset
            if not piece and self.parent_spec:
                # absent child object: the parent shows through below
                # the overlap (librbd clone read path)
                piece = self._read_parent_range(ext.logical_offset,
                                                ext.length)
            buf[lo: lo + len(piece)] = piece
        return bytes(buf)

    def discard(self, offset: int, length: int) -> None:
        """Whole-object discards remove; partial ones zero.  Under a
        clone, objects the parent backs are zero-FILLED instead of
        removed — removal would re-expose the parent's bytes."""
        self._check_rw()
        self._check_bounds(offset, length)
        self._journal_event({"op": "discard", "off": offset,
                             "len": length})
        if self._cache is not None:
            # dirty bytes OUTSIDE the discarded range must survive:
            # flush everything, then drop the affected objects
            self._cache.flush()
            for ext in file_to_extents(self.layout, offset, length):
                self._cache.discard(data_oid(self.name, ext.object_no))
        overlap = self.parent_spec["overlap"] if self.parent_spec else 0
        for ext in file_to_extents(self.layout, offset, length):
            oid = data_oid(self.name, ext.object_no)
            base = ext.object_no * self.object_size
            try:
                if ext.length == self.object_size and base >= overlap:
                    self.io.remove_object(oid)
                else:
                    if ext.length < self.object_size:
                        self._copyup_if_needed(ext.object_no)
                    self.io.write(oid, b"\x00" * ext.length,
                                  offset=ext.offset)
            except RadosError:
                pass

    def resize(self, new_size: int) -> None:
        self._check_rw()
        old = self.size()
        if self._cache is not None:
            self._cache.flush()
            if new_size < old:
                self._cache.invalidate_all()
        self._journal_event({"op": "resize", "size": int(new_size)})
        self.io.execute(header_oid(self.name), "rbd", "set_size",
                        denc.dumps(int(new_size)))
        if self.parent_spec and new_size < self.parent_spec["overlap"]:
            # shrinking permanently reduces what the parent backs —
            # regrowing must expose zeros, not parent bytes
            self.io.execute(header_oid(self.name), "rbd",
                            "set_parent_overlap",
                            denc.dumps(int(new_size)))
        if new_size < old:
            # drop whole objects beyond the new end and truncate the
            # boundary object — regrowing must expose zeros, not the
            # pre-shrink bytes (librbd shrink semantics)
            first_dead = (new_size + self.object_size - 1) \
                // self.object_size
            last = (old + self.object_size - 1) // self.object_size
            for i in range(first_dead, last):
                try:
                    self.io.remove_object(data_oid(self.name, i))
                except RadosError:
                    pass
            tail = new_size % self.object_size
            if tail:
                try:
                    self.io.truncate(
                        data_oid(self.name, new_size // self.object_size),
                        tail)
                except RadosError:
                    pass
        self.refresh()
        self._notify_peers()

    # -- snapshots ---------------------------------------------------------

    def snap_create(self, snap_name: str) -> None:
        self._check_rw()
        if self._cache is not None:
            # buffered writes logically precede the snapshot: they
            # must land (under the pre-snap snapc) before it exists
            self._cache.flush()
        self.refresh()
        if snap_name in self.hdr["snaps"]:
            # validate BEFORE journaling: a failed op must not leave a
            # poison event that wedges every future mirror replay
            raise RbdError(17, f"snap {snap_name} exists")
        self._journal_event({"op": "snap_create", "name": snap_name})
        snapid = self.io.create_selfmanaged_snap()
        self.io.execute(header_oid(self.name), "rbd", "snap_add",
                        denc.dumps({"name": snap_name,
                                    "snapid": snapid}))
        self.refresh()
        self._notify_peers()

    def snap_remove(self, snap_name: str) -> None:
        self._check_rw()
        self.refresh()
        snap = self.hdr["snaps"].get(snap_name)
        if snap is None:
            raise RbdError(2, f"no snap {snap_name}")
        if snap.get("protected"):
            raise RbdError(16, f"snap {snap_name} is protected")  # EBUSY
        self._journal_event({"op": "snap_remove", "name": snap_name})
        blob = self.io.execute(header_oid(self.name), "rbd",
                               "snap_remove", denc.dumps(snap_name))
        snapid = denc.loads(blob)
        self.io.remove_selfmanaged_snap(snapid)
        self.refresh()
        self._notify_peers()

    def snap_protect(self, snap_name: str) -> None:
        """Required before cloning (cls_rbd set_protection_status)."""
        self._check_rw()
        self.io.execute(header_oid(self.name), "rbd", "snap_protect",
                        denc.dumps(snap_name))
        self.refresh()
        self._notify_peers()

    def snap_unprotect(self, snap_name: str) -> None:
        self._check_rw()
        kids = denc.loads(self.io.execute(
            CHILDREN, "rbd", "children_list",
            denc.dumps({"image": self.name, "snap": snap_name})))
        if kids:
            raise RbdError(16, f"snap has {len(kids)} clone(s)")
        self.io.execute(header_oid(self.name), "rbd", "snap_unprotect",
                        denc.dumps(snap_name))
        self.refresh()
        self._notify_peers()

    def snap_list(self) -> list[dict]:
        return [{"name": n, "id": s["id"], "size": s["size"]}
                for n, s in sorted(self.hdr["snaps"].items())]

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._cache is not None:
            try:
                self._cache.flush()
            finally:
                self._cache.invalidate_all()
        if self._parent is not None:
            self._parent.close()
            self._parent = None
        if self._watch_cookie is not None:
            try:
                self.io.unwatch(header_oid(self.name),
                                self._watch_cookie)
            except RadosError:
                pass
            self._watch_cookie = None
        if self._lock_held:
            try:
                self.io.execute(
                    header_oid(self.name), "lock", "unlock",
                    denc.dumps({"name": LOCK_NAME,
                                "entity": self.io.rados.msgr.name,
                                "cookie": self._cookie}))
            except RadosError:
                pass
            self._lock_held = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
