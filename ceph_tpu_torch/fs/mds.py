"""MDS: the CephFS metadata server (mds/MDSRank.cc, Server.cc,
MDCache.cc reduced to a single active rank).

All metadata lives IN RADOS, mirroring the reference's on-disk model:

  * each directory is one omap object ``dir.<ino>`` in the metadata
    pool; a dentry key maps to the child's full inode record (the
    reference embeds inodes in dentries the same way);
  * the inode-number allocator is an omap counter (InoTable analog);
  * file data never touches the MDS — clients stripe it into the data
    pool addressed by ino (mds/client data path split).

Metadata mutations are JOURNALED (mds/MDLog.cc model): each request
appends one event — a list of idempotent steps — to an MDLog journal
in the metadata pool (the shared Journaler library, the reference's
osdc/Journaler), applies to the dentry cache, and replies; dirty
directory omaps flush lazily on the beacon tick, after which the
journal commit position advances and old segments trim.  An MDS that
dies mid-burst replays the journal from its commit position on
restart and converges (journal replay, mds/journal.cc).

Snapshots (.snap, SnapServer/snaprealm reduced): `mkdir d/.snap/name`
allocates a self-managed snapid on the DATA pool (so client writes
carrying the updated snap context make the OSDs COW file data) and
eagerly freezes the metadata subtree under d into one snapshot object;
`d/.snap/name/...` paths resolve inside the frozen tree, with file
reads served from the data pool at that snapid.  DIVERGENCE: the
reference's snaprealms are lazy COW over the live tree; the eager
metadata freeze trades O(subtree) capture cost for the same read
semantics.

Multi-rank (mds/Migrator.h:52, mds/MDBalancer.h:39 redesigned):
ranks shard the namespace by SUBTREE, with the authoritative table in
a RADOS omap (SUBTREES_OID).  Because all metadata already lives in
shared RADOS dir omaps, migration collapses to an authority handoff:
freeze subtree -> revoke caps -> flush journal -> CAS the table —
no cache state ships, the importer faults everything in.  Clients
route by longest-prefix over the same table and re-target on ESTALE
hints.  The balancer publishes per-rank load samples to LOAD_OID and
exports the hottest top-level subtree when 2x-imbalanced.
"""

from __future__ import annotations

import itertools
import threading
import time

from ..client.rados import Rados, RadosError
from ..mon.client import MonClient
from ..mon.messages import MMDSBeacon
from ..mon.monmap import MonMap
from ..msg import Dispatcher, Policy, create_messenger
from ..utils import denc
from ..utils.clock import SystemClock
from ..utils.config import Config
from ..utils.dout import DoutLogger
from .messages import (MClientCaps, MClientCapsAck, MClientReply,
                       MClientRequest)

ROOT_INO = 1
INOTABLE = "mds_inotable"
SUBTREES_OID = "mds_subtrees"     # omap: subtree root path -> auth rank
LOAD_OID = "mds_load"             # omap: rank -> {"load": reqs/tick}
DEFAULT_LAYOUT = {"stripe_unit": 1 << 22, "stripe_count": 1,
                  "object_size": 1 << 22}


class _SimulatedCrash(Exception):
    """Test hook: dies at a chosen point inside export_dir."""


def dir_oid(ino: int) -> str:
    return f"dir.{ino:x}"


def new_inode(ino: int, typ: str, layout=None) -> dict:
    now = time.time()
    return {"ino": ino, "type": typ, "size": 0, "mtime": now,
            "ctime": now, "layout": layout or dict(DEFAULT_LAYOUT)}


class MDSDaemon(Dispatcher):
    def __init__(self, name: str, monmap: MonMap,
                 conf: Config | None = None,
                 metadata_pool: str = "cephfs_metadata",
                 data_pool: str = "cephfs_data", clock=None,
                 rank: int = 0):
        self.name = name
        self.entity = f"mds.{name}"
        self.rank = rank
        self.conf = conf or Config()
        self.clock = clock or SystemClock()
        self.log = DoutLogger("mds", self.entity)
        self.metadata_pool = metadata_pool
        self.data_pool = data_pool

        self.msgr = create_messenger(self.entity, conf=self.conf)
        self.msgr.bind(("127.0.0.1", 0))
        self.msgr.set_policy("mon", Policy.lossless_peer())
        self.msgr.set_policy("client", Policy.stateless_server())
        self.msgr.add_dispatcher_tail(self)
        self.monc = MonClient(self.msgr, monmap)

        # own RADOS client for the metadata pool (Objecter-backed)
        self._rados = Rados(monmap, f"client.{self.entity}",
                            conf=self.conf)
        self.meta = None
        self._lock = threading.RLock()   # rank-wide serialization
        self._beacon_timer = None
        self._stopped = False
        # dentry cache (MDCache reduced): dir ino -> {name: inode}.
        # Single active rank writes ALL metadata, so the cache is
        # trivially coherent; bounded by eviction below.
        self._dcache: dict[int, dict[str, dict]] = {}
        self._dcache_max = 1024
        # capabilities (Locker.cc reduced): path -> {client: caps},
        # plus client sessions (entity -> reply addr) and pending
        # revoke gathers (ack_id -> state)
        self._caps: dict[str, dict[str, str]] = {}
        self._sessions: dict[str, tuple] = {}
        self._revokes: dict[int, dict] = {}
        self._ack_id = itertools.count(1)
        # client -> consecutive revoke-ack timeouts (laggy tracking);
        # strikes are rate-limited so a slow-but-alive client whose
        # acks land just past the window is not rapid-fired to 3
        self._laggy: dict[str, int] = {}
        self._laggy_last: dict[str, float] = {}   # last strike time
        # MDLog state: journaled-but-unflushed omap deltas per dir
        # (dir ino -> {name: serialized inode | None=removed}),
        # created/removed dir objects, and the journal head position
        self.mdlog = None
        self._mdlog_head = 0
        self._pending_flush: dict[int, dict[str, bytes | None]] = {}
        self._created_dirs: set[int] = set()
        self._removed_dirs: set[int] = set()
        self._skip_flush = False         # kill(): crash simulation
        # snapshots: "ino:name" -> {"snapid": n, "oid": frozen-tree}
        self.data_io = None
        self._snaps: dict[str, dict] = {}
        self._frozen_cache: dict[str, dict] = {}
        # multi-rank state (Migrator/MDBalancer reduced): the subtree
        # table maps subtree-root paths to their authoritative rank;
        # the RADOS omap SUBTREES_OID is the source of truth and this
        # is a cache refreshed on beacon ticks and authority misses
        self._subtrees: dict[str, int] = {"/": 0}
        self._frozen_subtrees: set[str] = set()   # exports in flight
        self._req_count = 0                # load since last beacon
        self._dir_hits: dict[str, int] = {}   # top-level dir -> hits

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.msgr.start()
        if self.msgr.auth_mode == "cephx":
            self.monc.enable_service_auth(
                [self.msgr], own_service="mds",
                ticket_services=[], clock=self.clock)
        self._rados.connect()
        try:
            self._rados.create_pool(self.metadata_pool)
        except RadosError:
            pass
        try:
            self._rados.create_pool(self.data_pool)
        except RadosError:
            pass
        self.meta = self._rados.open_ioctx(self.metadata_pool)
        self.data_io = self._rados.open_ioctx(self.data_pool)
        self._ensure_root()
        self._load_snaps()
        self._mdlog_open()
        self.monc.subscribe({"monmap": 0})   # membership changes
        self._beacon()

    def shutdown(self) -> None:
        self._stopped = True
        self.monc.shutdown()
        if self._beacon_timer:
            self._beacon_timer.cancel()
        if not self._skip_flush:
            try:
                with self._lock:
                    self._flush_mdlog()
            except Exception:
                pass
        self._rados.shutdown()
        self.msgr.shutdown()

    def kill(self) -> None:
        """kill -9 analog: die with journaled-but-unflushed events
        still in the MDLog — the restart replay test's entry point."""
        self._skip_flush = True
        self.shutdown()

    def _beacon(self) -> None:
        if self._stopped:
            return
        self.monc.send(MMDSBeacon(name=self.name, addr=self.msgr.addr,
                                  rank=self.rank))
        try:
            self._beacon_multirank()
        except Exception:
            pass    # metadata pool may not exist yet
        try:
            with self._lock:
                self._flush_mdlog()
        except Exception:
            self.log.warn("mdlog flush failed; retrying next beacon")
        self._beacon_timer = self.clock.timer(
            float(self.conf.mon_tick_interval) * 2, self._beacon)

    # -- MDLog (mds/MDLog.cc + journal replay, reduced) --------------------

    def _mdlog_open(self) -> None:
        from ..journal import Journaler
        j = Journaler(self.meta, "mdlog", client_id="mds")
        try:
            j.open()
        except RadosError:
            j.create()
            j.open()
        j.register_client("mds")
        self.mdlog = j
        start = j._commit_positions().get("mds", 0)
        self._mdlog_head = start
        replayed = 0
        for pos, blob in j.replay(start):
            try:
                self._apply_steps(denc.loads(blob))
            except Exception as e:
                self.log.error("mdlog replay failed at %d: %s", pos, e)
            self._mdlog_head = pos + 1
            replayed += 1
        if replayed:
            self.log.info("mdlog: replayed %d events", replayed)
            self._flush_mdlog()

    def _mutate(self, steps: list) -> None:
        """Journal one event (durably, in the metadata pool) then
        apply it to the cache; the omap flush is lazy.  Caller holds
        self._lock."""
        pos = self.mdlog.append(denc.dumps(steps))
        self._mdlog_head = pos + 1
        self._apply_steps(steps)
        if sum(len(p) for p in self._pending_flush.values()) >= 512:
            self._flush_mdlog()       # bound journal segment growth

    def _apply_steps(self, steps: list) -> None:
        """Apply idempotent event steps to the dentry cache + pending
        flush set (replay-safe: steps carry absolute state)."""
        for st in steps:
            kind = st[0]
            if kind == "set":
                _, dino, name, inode = st
                ents = self._dentries(dino)
                ents[name] = dict(inode)
                self._dcache[dino] = ents
                self._pending_flush.setdefault(dino, {})[name] = \
                    denc.dumps(inode)
            elif kind == "rm":
                _, dino, name = st
                ents = self._dentries(dino)
                ents.pop(name, None)
                self._dcache[dino] = ents
                self._pending_flush.setdefault(dino, {})[name] = None
            elif kind == "mkdirobj":
                ino = st[1]
                self._created_dirs.add(ino)
                self._removed_dirs.discard(ino)
                if len(self._dcache) >= self._dcache_max:
                    self._dcache.pop(next(iter(self._dcache)))
                self._dcache[ino] = {}
            elif kind == "rmdirobj":
                ino = st[1]
                self._removed_dirs.add(ino)
                self._created_dirs.discard(ino)
                self._pending_flush.pop(ino, None)
                self._dcache.pop(ino, None)

    def _flush_mdlog(self) -> None:
        """Land journaled deltas in the directory omaps, then advance
        the journal commit position and trim expired segments (the
        reference's segment expiry).  Caller holds self._lock.  A
        partial flush is safe: steps are idempotent, so a crash here
        just replays them."""
        if self.mdlog is None or (
                not self._pending_flush and not self._created_dirs
                and not self._removed_dirs):
            return
        head = self._mdlog_head
        for ino in sorted(self._created_dirs):
            self.meta.write_full(dir_oid(ino), b"")
        for dino, names in sorted(self._pending_flush.items()):
            if dino in self._removed_dirs:
                continue
            sets = {n: blob for n, blob in names.items()
                    if blob is not None}
            rms = [n for n, blob in names.items() if blob is None]
            if sets:
                self.meta.set_omap(dir_oid(dino), sets)
            if rms:
                self.meta.rm_omap_keys(dir_oid(dino), rms)
        for ino in sorted(self._removed_dirs):
            try:
                self.meta.remove_object(dir_oid(ino))
            except RadosError:
                pass
        self._pending_flush.clear()
        self._created_dirs.clear()
        self._removed_dirs.clear()
        self.mdlog.commit(head)
        try:
            self.mdlog.trim()
        except RadosError:
            pass

    def _ensure_root(self) -> None:
        try:
            self.meta.stat(dir_oid(ROOT_INO))
        except RadosError:
            self.meta.write_full(dir_oid(ROOT_INO), b"")
            self.meta.set_omap(INOTABLE, {"next": b"2"})
        try:
            self.meta.execute(SUBTREES_OID, "kvstore", "put",
                              denc.dumps({"kv": {"/": denc.dumps(0)},
                                          "if_absent": True}))
        except RadosError:
            pass                          # root entry already present
        self._load_subtrees()

    # -- multi-rank: subtree authority (mds/Migrator.h:52 reduced) ---------

    def _load_subtrees(self) -> None:
        from . import load_subtree_table
        table = load_subtree_table(self.meta)
        if table and table != self._subtrees:
            # authority moved: anything we cached under a regained
            # subtree may predate the other rank's mutations
            self._subtrees = table
            self._dcache.clear()

    def _auth_rank(self, norm: str) -> int:
        from . import subtree_rank
        return subtree_rank(self._subtrees, norm)

    def _is_frozen(self, norm: str) -> bool:
        return any(norm == f or norm.startswith(f + "/")
                   for f in self._frozen_subtrees)

    def _note_load(self, norm: str) -> None:
        self._req_count += 1
        parts = self._split(norm)
        if parts:
            top = "/" + parts[0]
            self._dir_hits[top] = self._dir_hits.get(top, 0) + 1

    def _beacon_multirank(self) -> None:
        """Per-beacon multi-rank upkeep: refresh the subtree cache,
        publish our load sample, and (when enabled) run one balancer
        pass (mds/MDBalancer.h:39 reduced to a shared load table)."""
        if self.meta is None:
            return
        self._load_subtrees()
        load, self._req_count = self._req_count, 0
        hits, self._dir_hits = dict(self._dir_hits), {}
        try:
            self.meta.set_omap(LOAD_OID, {str(self.rank): denc.dumps(
                {"load": load, "hits": hits})})
        except RadosError:
            return
        if bool(getattr(self.conf, "mds_bal_auto", False)):
            try:
                self.maybe_balance(load, hits)
            except Exception as e:
                self.log.warn("balance pass failed: %s", e)

    def maybe_balance(self, load: int, hits: dict) -> None:
        """Export our hottest owned top-level subtree to the least-
        loaded rank when our load is at least 2x theirs."""
        min_load = int(getattr(self.conf, "mds_bal_min", 20) or 20)
        if load < min_load:
            return
        try:
            table = {int(r): denc.loads(v) for r, v in
                     self.meta.get_omap(LOAD_OID).items()}
        except RadosError:
            return
        peers = {r: e.get("load", 0) for r, e in table.items()
                 if r != self.rank}
        if not peers:
            return
        target = min(peers, key=peers.get)
        if peers[target] * 2 > load:
            return
        for top, _n in sorted(hits.items(), key=lambda t: -t[1]):
            if self._auth_rank(top) == self.rank and top != "/":
                self.log.info("balancer: exporting %s to rank %d "
                              "(load %d vs %d)", top, target, load,
                              peers[target])
                self.export_dir(top, target)
                return

    def export_dir(self, path: str, target_rank: int,
                   _crash_at: str | None = None) -> None:
        """Migrate authority over a subtree to another rank (the
        Migrator export state machine collapsed onto shared RADOS
        metadata: freeze -> revoke caps -> flush journal -> CAS the
        subtree table).  All metadata already lives in RADOS dir
        omaps, so no cache state ships — the importer faults it in.

        Crash safety: the table CAS is the single commit point.  Dying
        before it leaves the exporter authoritative (freeze state is
        in-memory); dying after it leaves the importer authoritative
        with a fully-flushed journal either way."""
        norm = self._norm(path)
        if norm == "/":
            raise RadosError(22, "cannot export the root")
        with self._lock:
            self._load_subtrees()
            if self._auth_rank(norm) != self.rank:
                raise RadosError(116, f"{norm} not ours to export")
            self._frozen_subtrees.add(norm)
        try:
            if _crash_at == "frozen":
                raise _SimulatedCrash("frozen")
            with self._lock:
                # every client's caps under the subtree must come home
                # (their buffered attrs flush) before authority moves
                flushes = self._revoke_caps("", [(norm, True)])
                self._apply_cap_flushes(flushes)
                self._flush_mdlog()
                self._dcache.clear()
                if _crash_at == "flushed":
                    raise _SimulatedCrash("flushed")
                cur = self._subtrees.get(norm)
                expect = denc.dumps(cur) if cur is not None else None
                self.meta.execute(SUBTREES_OID, "kvstore", "cas",
                                  denc.dumps({
                                      "key": norm, "expect": expect,
                                      "value": denc.dumps(
                                          int(target_rank))}))
                self._subtrees[norm] = int(target_rank)
                self.log.info("exported %s to rank %d", norm,
                              target_rank)
        finally:
            self._frozen_subtrees.discard(norm)

    # -- inode table -------------------------------------------------------

    def _alloc_ino(self) -> int:
        omap = self.meta.get_omap(INOTABLE)
        ino = int(omap.get("next", b"2"))
        self.meta.set_omap(INOTABLE, {"next": str(ino + 1).encode()})
        return ino

    # -- path resolution ---------------------------------------------------

    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.strip("/").split("/") if p]

    def _dentries(self, dir_ino: int,
                  cacheable: bool = True) -> dict[str, dict]:
        cached = self._dcache.get(dir_ino)
        if cached is not None:
            return cached
        try:
            omap = self.meta.get_omap(dir_oid(dir_ino))
        except RadosError:
            omap = {}
        out = {k: denc.loads(v) for k, v in omap.items()}
        # overlay journaled-but-unflushed deltas: a cache eviction
        # must never resurrect the pre-journal omap state
        for name, blob in self._pending_flush.get(dir_ino, {}).items():
            if blob is None:
                out.pop(name, None)
            else:
                out[name] = denc.loads(blob)
        if cacheable:
            # dirs OUTSIDE our subtree authority are never cached:
            # another rank mutates them and nothing would invalidate
            # our copy (the reference replicates such dirs with
            # explicit cache coherence; we read through instead)
            if len(self._dcache) >= self._dcache_max:
                self._dcache.pop(next(iter(self._dcache)))
            self._dcache[dir_ino] = out
        return out

    def _resolve(self, path: str) -> dict:
        """Path -> inode record; raises RadosError(ENOENT/ENOTDIR)."""
        cur = {"ino": ROOT_INO, "type": "dir"}
        cur_path = ""
        for part in self._split(path):
            if cur["type"] != "dir":
                raise RadosError(20, f"{part}: not a directory")
            ours = self._auth_rank(cur_path or "/") == self.rank
            ent = self._dentries(cur["ino"], cacheable=ours).get(part)
            if ent is None:
                raise RadosError(2, f"no such entry {part}")
            cur = ent
            cur_path = f"{cur_path}/{part}"
        return cur

    def _resolve_parent(self, path: str) -> tuple[dict, str]:
        parts = self._split(path)
        if not parts:
            raise RadosError(22, "bad path")
        parent = self._resolve("/".join(parts[:-1]))
        if parent["type"] != "dir":
            raise RadosError(20, "parent not a directory")
        return parent, parts[-1]

    # -- request handling --------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MClientRequest):
            threading.Thread(target=self._handle, args=(conn, msg),
                             daemon=True).start()
            return True
        if isinstance(msg, MClientCapsAck):
            # inline: the revoking op thread is WAITING on this while
            # holding the rank lock — acks must not need it
            state = self._revokes.get(msg.ack_id)
            self._laggy.pop(conn.peer_name, None)   # alive after all
            self._laggy_last.pop(conn.peer_name, None)
            if state is not None:
                with state["lock"]:
                    state["flushes"].update(msg.flushes or {})
                    state["acked"].add(conn.peer_name)
                    state["waiting"].discard(conn.peer_name)
                if not state["waiting"]:
                    state["event"].set()
            return True
        return False

    def _route_norm(self, op: str, norm: str) -> str:
        # ops that mutate the PARENT directory's omap (the dentry
        # lives there) route by the parent — otherwise mutating a
        # subtree ROOT's dentry from the subtree owner would silently
        # stale the parent owner's cache.  Shared rule with the client
        # (fs.route_path) so both sides agree.
        from . import route_path
        return route_path(op, norm)

    def _authority_gate(self, msg) -> "MClientReply | None":
        """Multi-rank routing: a frozen subtree answers EAGAIN (the
        export is mid-flight; retry lands post-CAS), a path whose
        authority is another rank answers ESTALE with the rank hint
        (the client refreshes its table and re-targets), and a
        cross-rank rename is EXDEV (matching the reference's
        cross-mds rename limits).  Structural ops on a subtree root
        owned by a DIFFERENT rank than its parent are EBUSY — the
        subtree must be imported back first (a reduced stand-in for
        the reference's cross-rank dirfrag locking)."""
        path = getattr(msg, "path", None)
        if path is None:
            return None
        norm = self._norm(path)
        route = self._route_norm(msg.op, norm)
        if self._is_frozen(norm) or self._is_frozen(route):
            return MClientReply(tid=msg.tid, result=-11, data=None)
        r = self._auth_rank(route)
        if r != self.rank:
            self._load_subtrees()     # maybe we just imported it
            r = self._auth_rank(route)
        if r != self.rank:
            return MClientReply(tid=msg.tid, result=-116,
                                data={"rank": r})
        if msg.op in ("rmdir", "unlink", "rename") and norm != "/":
            owner = self._subtrees.get(norm)
            if owner is not None and owner != self.rank:
                return MClientReply(tid=msg.tid, result=-16,
                                    data=None)    # EBUSY
        newp = getattr(msg, "new_path", None)
        if newp:
            nnorm = self._norm(newp)
            nroute = self._route_norm(msg.op, nnorm)
            if self._is_frozen(nnorm) or self._is_frozen(nroute):
                return MClientReply(tid=msg.tid, result=-11, data=None)
            nowner = self._subtrees.get(nnorm)
            if self._auth_rank(nroute) != self.rank or (
                    nowner is not None and nowner != self.rank):
                return MClientReply(tid=msg.tid, result=-18,
                                    data=None)
        self._note_load(norm)
        return None

    def _handle(self, conn, msg) -> None:
        with self._lock:
            self._sessions[msg.src] = conn.peer_addr
            gate = self._authority_gate(msg)
            if gate is not None:
                self.msgr.send_message(gate, conn.peer_name,
                                       conn.peer_addr)
                return
            try:
                affected = self._affected_paths(msg)
                if affected:
                    # Locker semantics: conflicting client caps are
                    # revoked (and their buffered attrs flushed)
                    # BEFORE the mutation executes
                    flushes = self._revoke_caps(msg.src, affected)
                    self._apply_cap_flushes(flushes)
                else:
                    # reads conflict only with WRITE-buffering caps:
                    # another client's unflushed size must land before
                    # we answer (reader-revokes-writer, Locker model)
                    conflicts = self._read_conflicts(msg)
                    if conflicts:
                        flushes = self._revoke_caps(
                            msg.src, conflicts, write_only=True)
                        self._apply_cap_flushes(flushes)
                data = self._execute(msg)
                grants = self._grant_caps(msg)
                reply = MClientReply(tid=msg.tid, result=0, data=data,
                                     grants=grants,
                                     snapc=self._snapc())
            except RadosError as e:
                reply = MClientReply(tid=msg.tid, result=-e.errno,
                                     data=None)
            except Exception as e:
                self.log.error("request %s failed: %s", msg.op, e)
                reply = MClientReply(tid=msg.tid, result=-5, data=None)
        self.msgr.send_message(reply, conn.peer_name, conn.peer_addr)

    # -- capabilities (Locker.cc reduced) ----------------------------------

    def _norm(self, path: str) -> str:
        return "/" + "/".join(self._split(path))

    def _parent_of(self, norm: str) -> str:
        return norm.rsplit("/", 1)[0] or "/"

    def _affected_paths(self, msg) -> list[tuple[str, bool]]:
        """Paths a mutation invalidates: (path, prefix?) pairs."""
        op = msg.op
        if op in ("getattr", "lookup", "readdir"):
            return []
        parts = self._split(msg.path)
        if ".snap" in parts:
            if op == "mkdir":
                # snapshot create: every buffered attr under the
                # snapped dir must land before the freeze, or the
                # frozen tree captures stale sizes
                dpath = "/" + "/".join(parts[:parts.index(".snap")])
                return [(dpath, True)]
            return []           # other snap ops are read-only/EROFS
        p = self._norm(msg.path)
        parent = self._parent_of(p)
        if op in ("mkdir", "create", "setattr", "unlink"):
            return [(parent, False), (p, False)]
        if op == "rmdir":
            return [(parent, False), (p, True)]
        if op == "rename":
            d = self._norm(msg.new_path)
            return [(parent, False), (self._parent_of(d), False),
                    (p, True), (d, True)]
        return []

    def _read_conflicts(self, msg) -> list[tuple[str, bool]]:
        p = self._norm(msg.path)
        if msg.op in ("getattr", "lookup"):
            return [(p, False)]
        if msg.op == "readdir":
            return [(p, True)]     # listings embed child sizes
        return []

    def _revoke_caps(self, requester: str, affected: list,
                     write_only: bool = False) -> dict:
        """Pull matching caps from every OTHER client; wait (bounded)
        for their acks, which carry buffered-attr flushes."""
        per_client: dict[str, list[str]] = {}
        for cap_path in list(self._caps):
            for apath, prefix in affected:
                hit = cap_path == apath or (
                    prefix and cap_path.startswith(apath + "/"))
                if not hit:
                    continue
                holders = self._caps[cap_path]
                for client in list(holders):
                    if client == requester:
                        continue
                    if write_only and "w" not in holders[client]:
                        continue
                    per_client.setdefault(client, []).append(cap_path)
                    del holders[client]
                if not holders:
                    del self._caps[cap_path]
                break
        targets = {c: ps for c, ps in per_client.items()
                   if c in self._sessions}
        if not targets:
            return {}
        ack_id = next(self._ack_id)
        # a client that already blew a revoke window is LAGGY: send
        # the revoke but do not wait on it again — one dead client
        # must not serialize every conflicting op behind 1s stalls
        waited = {c for c in targets if not self._laggy.get(c)}
        state = {"waiting": set(waited), "flushes": {}, "acked": set(),
                 "event": threading.Event(),
                 "lock": threading.Lock()}
        self._revokes[ack_id] = state
        for client, paths in targets.items():
            self.msgr.send_message(
                MClientCaps(ack_id=ack_id, paths=sorted(set(paths))),
                client, self._sessions[client])
        # bounded REAL-time wait: acks arrive on the messenger thread
        # (no rank lock needed); a dead client costs one window
        if state["waiting"]:
            state["event"].wait(1.0)
        self._revokes.pop(ack_id, None)
        # strike every target that did not ack — including laggy ones
        # we no longer wait on (a LATE ack clears the counter via the
        # ack handler, so only a truly dead client accumulates).
        # Copies under state["lock"]: the messenger thread may still
        # be mutating these sets for an ack in flight.
        with state["lock"]:
            acked = set(state["acked"])
            flushes = dict(state["flushes"])
        now = time.time()
        for client in set(targets) - acked:
            # at most one strike per real revoke window: laggy clients
            # get a zero-length window, so without this cooldown a
            # burst of ops would rapid-fire a 1.2s-RTT client straight
            # to 3 strikes before any in-flight ack could land
            if now - self._laggy_last.get(client, 0.0) < 1.0:
                continue
            self._laggy_last[client] = now
            fails = self._laggy.get(client, 0) + 1
            self._laggy[client] = fails
            if fails >= 3:
                # Session::close semantics: a persistently dead
                # client loses its session (and with it, its caps)
                self._laggy.pop(client, None)
                self._laggy_last.pop(client, None)
                self._sessions.pop(client, None)
                for holders in self._caps.values():
                    holders.pop(client, None)
        return flushes

    def _apply_cap_flushes(self, flushes: dict) -> None:
        """A revoked writer's buffered size lands before the op."""
        for path, size in flushes.items():
            try:
                parent, name = self._resolve_parent(path)
                ent = self._dentries(parent["ino"]).get(name)
                if ent is not None and ent["type"] == "file":
                    ent["size"] = max(int(ent["size"]), int(size))
                    ent["mtime"] = time.time()
                    self._mutate([("set", parent["ino"], name,
                                   ent)])
            except RadosError:
                continue

    def _grant_caps(self, msg) -> list:
        """Read caps on resolved paths; read+buffer caps on files the
        client created/opened (Fw analog)."""
        op = msg.op
        p = self._norm(msg.path)
        if op in ("getattr", "lookup", "readdir"):
            caps = "r"
        elif op in ("create", "setattr"):
            caps = "rw"
        else:
            return []
        self._caps.setdefault(p, {})[msg.src] = caps
        return [{"path": p, "caps": caps}]

    def _execute(self, msg):
        op, path = msg.op, msg.path
        if ".snap" in self._split(path) or (
                op == "rename" and
                ".snap" in self._split(msg.new_path)):
            return self._execute_snap(msg)
        if op == "getattr":
            return self._resolve(path)
        if op == "lookup":
            return self._resolve(path)
        if op == "readdir":
            node = self._resolve(path)
            if node["type"] != "dir":
                raise RadosError(20, "not a directory")
            return {name: ent for name, ent in
                    self._dentries(node["ino"]).items()}
        if op == "mkdir":
            parent, name = self._resolve_parent(path)
            if name in self._dentries(parent["ino"]):
                raise RadosError(17, "exists")
            ino = self._alloc_ino()
            inode = new_inode(ino, "dir")
            self._mutate([("mkdirobj", ino),
                          ("set", parent["ino"], name, inode)])
            return inode
        if op == "create":
            parent, name = self._resolve_parent(path)
            existing = self._dentries(parent["ino"]).get(name)
            if existing is not None:
                if existing["type"] != "file":
                    raise RadosError(21, "is a directory")
                return existing
            inode = new_inode(self._alloc_ino(), "file")
            self._mutate([("set", parent["ino"], name, inode)])
            return inode
        if op == "setattr":
            parent, name = self._resolve_parent(path)
            ent = self._dentries(parent["ino"]).get(name)
            if ent is None:
                raise RadosError(2, "no such entry")
            if msg.size is not None:
                ent["size"] = int(msg.size)
            ent["mtime"] = time.time()
            self._mutate([("set", parent["ino"], name, ent)])
            return ent
        if op == "unlink":
            parent, name = self._resolve_parent(path)
            ent = self._dentries(parent["ino"]).get(name)
            if ent is None:
                raise RadosError(2, "no such entry")
            if ent["type"] == "dir":
                raise RadosError(21, "is a directory")
            self._mutate([("rm", parent["ino"], name)])
            return ent          # client deletes the data objects
        if op == "rmdir":
            parent, name = self._resolve_parent(path)
            ent = self._dentries(parent["ino"]).get(name)
            if ent is None:
                raise RadosError(2, "no such entry")
            if ent["type"] != "dir":
                raise RadosError(20, "not a directory")
            if self._dentries(ent["ino"]):
                raise RadosError(39, "directory not empty")
            self._mutate([("rm", parent["ino"], name),
                          ("rmdirobj", ent["ino"])])
            return None
        if op == "rename":
            # renaming a directory into its own subtree would detach
            # it into an unreachable cycle (POSIX EINVAL)
            src_norm = "/" + "/".join(self._split(path))
            dst_norm = "/" + "/".join(self._split(msg.new_path))
            if dst_norm == src_norm or \
                    dst_norm.startswith(src_norm + "/"):
                raise RadosError(22, "destination inside source")
            src_parent, src_name = self._resolve_parent(path)
            ent = self._dentries(src_parent["ino"]).get(src_name)
            if ent is None:
                raise RadosError(2, "no such entry")
            dst_parent, dst_name = self._resolve_parent(msg.new_path)
            dst = self._dentries(dst_parent["ino"]).get(dst_name)
            replaced = None
            if dst is not None:
                # POSIX atomic replace for files (write-tmp + rename);
                # DIVERGENCE: replacing a directory destination is
                # EEXIST here (no dir-over-empty-dir)
                if dst["type"] != "file" or ent["type"] != "file":
                    raise RadosError(17, "destination exists")
                replaced = dst
            # ONE journal event: the rename replays atomically
            self._mutate([
                ("set", dst_parent["ino"], dst_name, ent),
                ("rm", src_parent["ino"], src_name)])
            return {"entry": ent, "replaced": replaced}
        raise RadosError(95, f"unknown mds op {op!r}")

    # -- snapshots (.snap, SnapServer/snaprealm reduced) -------------------

    def _load_snaps(self) -> None:
        try:
            omap = self.meta.get_omap("mds_snaps")
        except RadosError:
            return
        snapc = omap.pop("_snapc", None)
        self._snaps = {k: denc.loads(v) for k, v in omap.items()}
        if snapc is not None:
            seq, snaps = denc.loads(snapc)
            self.data_io.set_snap_context(seq, snaps)

    def _snapc(self) -> tuple:
        return (self.data_io.snap_seq, list(self.data_io.snaps))

    def _split_snap_path(self, path: str):
        """'a/b/.snap/name/rest...' -> ('a/b', 'name'|None, [rest])."""
        parts = self._split(path)
        i = parts.index(".snap")
        return ("/".join(parts[:i]),
                parts[i + 1] if len(parts) > i + 1 else None,
                parts[i + 2:])

    def _execute_snap(self, msg):
        op = msg.op
        if ".snap" not in self._split(msg.path):
            # rename whose DESTINATION is under .snap
            raise RadosError(30, "snapshots are read-only")
        dpath, name, rest = self._split_snap_path(msg.path)
        dnode = self._resolve(dpath)
        if dnode["type"] != "dir":
            raise RadosError(20, "not a directory")
        key = f"{dnode['ino']:x}:{name}" if name else None
        if op == "mkdir" and name and not rest:
            return self._snap_create(dnode, key, name)
        if op == "rmdir" and name and not rest:
            return self._snap_remove(key)
        if op in ("getattr", "lookup", "readdir"):
            return self._snap_read(op, dnode, name, rest)
        raise RadosError(30, "snapshots are read-only")   # EROFS

    def _snap_create(self, dnode, key, name):
        if key in self._snaps:
            raise RadosError(17, "snapshot exists")
        # make the frozen tree reflect every acked mutation
        self._flush_mdlog()
        # allocate the data-pool snapid: clients that learn the new
        # snap context (carried on every reply) make the OSDs COW
        # file data written from now on
        snapid = self.data_io.create_selfmanaged_snap()
        tree: dict[str, dict] = {}

        def freeze(ino: int, rel: str) -> None:
            ents = dict(self._dentries(ino))
            tree[rel] = ents
            for nm, ent in ents.items():
                if ent["type"] == "dir":
                    freeze(ent["ino"], f"{rel}/{nm}" if rel else nm)

        freeze(dnode["ino"], "")
        oid = f"snap.{dnode['ino']:x}.{snapid:x}"
        self.meta.write_full(oid, denc.dumps(tree))
        rec = {"snapid": snapid, "oid": oid,
               "created": time.time()}
        self._snaps[key] = rec
        self.meta.set_omap("mds_snaps", {
            key: denc.dumps(rec),
            "_snapc": denc.dumps(self._snapc())})
        self.log.info("snapshot %s of dir %x -> snapid %d",
                      key, dnode["ino"], snapid)
        return {"ino": dnode["ino"], "type": "dir",
                "snapid": snapid, "size": 0,
                "mtime": rec["created"], "ctime": rec["created"],
                "layout": dict(DEFAULT_LAYOUT)}

    def _snap_remove(self, key):
        rec = self._snaps.pop(key, None)
        if rec is None:
            raise RadosError(2, "no such snapshot")
        self._frozen_cache.pop(rec["oid"], None)
        try:
            self.meta.remove_object(rec["oid"])
        except RadosError:
            pass
        try:
            self.data_io.remove_selfmanaged_snap(rec["snapid"])
        except RadosError:
            pass
        self.meta.rm_omap_keys("mds_snaps", [key])
        self.meta.set_omap("mds_snaps",
                           {"_snapc": denc.dumps(self._snapc())})
        return None

    def _frozen(self, rec: dict) -> dict:
        tree = self._frozen_cache.get(rec["oid"])
        if tree is None:
            tree = denc.loads(self.meta.read(rec["oid"]))
            if len(self._frozen_cache) > 16:
                self._frozen_cache.pop(next(iter(self._frozen_cache)))
            self._frozen_cache[rec["oid"]] = tree
        return tree

    def _snap_read(self, op, dnode, name, rest):
        ino = dnode["ino"]
        if name is None:
            # '<dir>/.snap' itself: list this dir's snapshot names
            prefix = f"{ino:x}:"
            names = {k[len(prefix):]: {"ino": ino, "type": "dir",
                                       "size": 0, "mtime": v["created"],
                                       "ctime": v["created"],
                                       "layout": dict(DEFAULT_LAYOUT)}
                     for k, v in self._snaps.items()
                     if k.startswith(prefix)}
            if op == "readdir":
                return names
            return {"ino": ino, "type": "dir", "size": 0,
                    "mtime": 0.0, "ctime": 0.0,
                    "layout": dict(DEFAULT_LAYOUT)}
        rec = self._snaps.get(f"{ino:x}:{name}")
        if rec is None:
            raise RadosError(2, "no such snapshot")
        tree = self._frozen(rec)
        snapid = rec["snapid"]

        def anno(ent: dict) -> dict:
            return (dict(ent, snapid=snapid)
                    if ent.get("type") == "file" else dict(ent))

        # resolve `rest` inside the frozen tree
        rel = ""
        cur = {"ino": ino, "type": "dir", "size": 0, "mtime": 0.0,
               "ctime": 0.0, "layout": dict(DEFAULT_LAYOUT)}
        for i, part in enumerate(rest):
            ents = tree.get(rel, {})
            ent = ents.get(part)
            if ent is None:
                raise RadosError(2, f"no such entry {part}")
            cur = ent
            if ent["type"] == "dir":
                rel = f"{rel}/{part}" if rel else part
            elif i != len(rest) - 1:
                raise RadosError(20, f"{part}: not a directory")
        if op == "readdir":
            if cur["type"] != "dir":
                raise RadosError(20, "not a directory")
            return {nm: anno(e)
                    for nm, e in tree.get(rel, {}).items()}
        return anno(cur)
