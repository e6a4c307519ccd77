"""rbd-mirror: continuous journal-based image replication
(tools/rbd_mirror/ reduced to its data path).

The reference daemon watches peer clusters' journaled images and
replays their journals locally (Replayer/ImageReplayer over the
journal library).  This daemon keeps that shape: per mirrored pool
pair it discovers journaled images in the SOURCE pool, creates the
matching image in the DESTINATION pool (same size/order), replays new
journal events from its per-client commit position, and trims the
source journal behind the consumed sets.

Each daemon replays one direction; failover runs two of them (A->B
and B->A).  Promote/demote (ImageReplayer handle_promoted,
tools/rbd_mirror/ImageReplayer.h:220): demoting an image makes it
read-only to clients while this daemon drains its remaining journal
into the peer; promoting the peer makes it the writable primary whose
NEW events the reverse daemon replays back onto the demoted twin.
Replay handles never re-journal (events would bounce between the
clusters forever).  Initial image sync is out of scope — the journal
IS the full history here.
"""

from __future__ import annotations

import threading

from ..client.rados import RadosError
from ..utils import denc
from ..utils.dout import DoutLogger
from . import RBD, Image, header_oid, journal_prefix, replay_journal
from ..journal import Journaler


class RbdMirror:
    """Mirror every journaled image of src pool -> dst pool."""

    def __init__(self, src_rados, dst_rados, src_pool: str,
                 dst_pool: str, interval: float = 1.0,
                 client_id: str = "mirror"):
        self.src = src_rados.open_ioctx(src_pool)
        self.dst_rados = dst_rados
        self.dst_pool = dst_pool
        self.interval = interval
        self.client_id = client_id
        self.log = DoutLogger("rbd-mirror", f"{src_pool}->{dst_pool}")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0

    # -- one replication pass ---------------------------------------------

    def run_once(self) -> dict[str, int]:
        """Replay new events for every journaled source image.
        Returns {image: events_applied}."""
        out: dict[str, int] = {}
        dst_io = self.dst_rados.open_ioctx(self.dst_pool)
        for name in RBD(self.src).list():
            try:
                hdr = denc.loads(self.src.execute(
                    header_oid(name), "rbd", "get_info"))
            except RadosError:
                continue
            if hdr.get("meta", {}).get("journaling") != b"1":
                continue
            # a demoted source still replays: that IS the drain of its
            # remaining journal after failover (no new events appear
            # on a non-primary image, so steady state is a no-op)
            try:
                applied = self._mirror_image(dst_io, name, hdr)
            except RadosError as e:
                self.log.warn("image %s: %s", name, e)
                continue
            out[name] = applied
        return out

    def _mirror_image(self, dst_io, name: str, hdr: dict) -> int:
        try:
            dst_io.execute(header_oid(name), "rbd", "get_info")
        except RadosError as e:
            if e.errno != 2:
                raise
            # first sight: create the twin at the source's current size
            # (journaling stays OFF on the secondary — replaying must
            # not re-journal)
            RBD(dst_io).create(name, hdr["size"], order=hdr["order"])
        with Image(dst_io, name, _mirror_replay=True) as dst:
            applied = replay_journal(self.src, name, dst,
                                     client_id=self.client_id)
        if applied:
            # the consumed sets are dead weight on the source
            try:
                Journaler(self.src, journal_prefix(name),
                          client_id=self.client_id).trim()
            except RadosError:
                pass
        return applied

    # -- daemon loop -------------------------------------------------------

    def start(self) -> "RbdMirror":
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.run_once()
                except Exception:
                    self.log.error("replication pass failed")
                self.cycles += 1

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rbd-mirror")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
