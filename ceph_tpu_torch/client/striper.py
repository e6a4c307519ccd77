"""Striping: logical byte ranges RAID-0'd across objects.

The osdc/Striper.cc extent math + a libradosstriper-style API
(libradosstriper/RadosStriperImpl.cc): a logical "striped object" maps
onto `stripe_count` parallel object columns in stripe_unit blocks,
rolling to a new object set every `object_size` bytes per column.
Layout parameters mirror ceph_file_layout (su/sc/object_size); the
logical size lives in an xattr on the first object, as the reference
striper does.
"""

from __future__ import annotations

from dataclasses import dataclass

SIZE_XATTR = "striper.size"


@dataclass(frozen=True)
class Layout:
    """ceph_file_layout analog."""
    stripe_unit: int = 1 << 22        # 4 MiB
    stripe_count: int = 1
    object_size: int = 1 << 22

    def __post_init__(self):
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")
        if self.stripe_count < 1:
            raise ValueError("stripe_count >= 1")


@dataclass(frozen=True)
class Extent:
    """One contiguous piece of one backing object."""
    object_no: int
    offset: int          # within the object
    length: int
    logical_offset: int  # where this piece sits in the logical stream


def file_to_extents(layout: Layout, offset: int,
                    length: int) -> list[Extent]:
    """Striper::file_to_extents: logical [offset, offset+length) ->
    per-object extents."""
    out: list[Extent] = []
    su = layout.stripe_unit
    sc = layout.stripe_count
    stripes_per_object = layout.object_size // su
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su                   # stripe block index
        stripeno = blockno // sc              # full stripe row
        stripepos = blockno % sc              # column
        objectsetno = stripeno // stripes_per_object
        objectno = objectsetno * sc + stripepos
        block_start = (stripeno % stripes_per_object) * su
        block_off = pos % su
        x_off = block_start + block_off
        x_len = min(end - pos, su - block_off)
        out.append(Extent(objectno, x_off, x_len, pos))
        pos += x_len
    return out


def object_name(soid: str, object_no: int) -> str:
    return f"{soid}.{object_no:016x}"


class StripedObject:
    """Striped I/O over an IoCtx (libradosstriper surface)."""

    def __init__(self, ioctx, soid: str, layout: Layout | None = None):
        self.io = ioctx
        self.soid = soid
        self.layout = layout or Layout()

    def _size_holder(self) -> str:
        return object_name(self.soid, 0)

    def size(self) -> int:
        from .rados import RadosError
        try:
            blob = self.io.get_xattr(self._size_holder(), SIZE_XATTR)
            return int(blob.decode())
        except RadosError:
            return 0

    def _set_size(self, size: int) -> None:
        self.io.set_xattr(self._size_holder(), SIZE_XATTR,
                          str(size).encode())

    def write(self, data, offset: int = 0) -> None:
        """Fan the extents out as parallel aio writes.

        The payload rides as a BufferList rope: each extent's chunk is
        a zero-copy slice of the caller's buffer (Striper::file_to_
        extents + bufferlist::substr_of in the reference) instead of a
        per-extent bytes copy of the whole span."""
        from ..utils.bufferlist import BufferList, wrap_payload
        rope = BufferList(wrap_payload(data))
        extents = file_to_extents(self.layout, offset, len(rope))
        completions = []
        for ext in extents:
            chunk = rope.slice(ext.logical_offset - offset, ext.length)
            completions.append(self.io.aio_write(
                object_name(self.soid, ext.object_no), chunk,
                offset=ext.offset))
        for c in completions:
            c.wait_for_complete()
        for c in completions:
            c.result()          # raise the first failure
        end = offset + len(data)
        if end > self.size():
            # ensure the size holder exists even when object 0 holds
            # no data (write at a far offset)
            if not any(e.object_no == 0 for e in extents):
                self.io.aio_write(object_name(self.soid, 0), b"",
                                  offset=0).wait_for_complete()
            self._set_size(end)

    def read(self, offset: int = 0, length: int = 0):
        """Striped read, reassembled ZERO-COPY.

        ``file_to_extents`` tiles [offset, offset+length) contiguously
        in logical order, so reassembly is rope concatenation: each
        extent's reply rides in as a shared segment (the old
        ``bytearray(length)`` staging buffer copied every byte once),
        with sparse holes (ENOENT / short object tails) zero-filled.
        Returns a :class:`~ceph_tpu_torch.utils.bufferlist.BufferList`
        (compares equal to bytes; ``bytes(r)`` is the audited
        flatten for consumers that need contiguity)."""
        from ..utils.bufferlist import BufferList
        size = self.size()
        if length == 0 or offset + length > size:
            length = max(0, size - offset)
        rope = BufferList()
        if length == 0:
            return rope
        extents = file_to_extents(self.layout, offset, length)
        completions = [
            (ext, self.io.aio_read(object_name(self.soid, ext.object_no),
                                   length=ext.length, offset=ext.offset))
            for ext in extents]
        from .rados import RadosError
        for ext, c in completions:
            c.wait_for_complete()
            try:
                piece = c.result()
            except RadosError as e:
                if e.errno != 2:
                    raise      # only ENOENT means "sparse, read zeros"
                piece = b""
            if len(piece) > ext.length:
                piece = memoryview(piece)[: ext.length]
            rope.append(piece)
            if len(piece) < ext.length:
                # hole: unwritten object / short tail reads as zeros
                rope.append(b"\0" * (ext.length - len(piece)))
        return rope

    def remove(self) -> None:
        """List backing objects by prefix rather than deriving them
        from the size xattr: a write that failed before updating the
        size must not leak its already-written extents."""
        import re
        from .rados import RadosError
        # exactly <soid>.<16 hex digits>: a bare prefix match would
        # also destroy 'vol.backup.*' when removing 'vol'
        pat = re.compile(re.escape(self.soid) + r"\.[0-9a-f]{16}$")
        names = [n for n in self.io.list_objects() if pat.fullmatch(n)]
        for name in set(names) | {self._size_holder()}:
            try:
                self.io.remove_object(name)
            except RadosError:
                pass

    def stat(self) -> dict:
        return {"size": self.size()}
