"""DurabilityLedger: the client-side acked-write oracle.

A storage system's first contract is that an acknowledged write
survives a crash.  The ledger is how the chaos harness checks it the
Jepsen way: every payload a client ACTUALLY submitted is recorded
(with a digest) BEFORE the op goes out, promoted to "acked" when the
cluster acknowledges it, and after any number of crash-restart cycles
``verify`` asserts, per object:

  * the last ACKED payload is readable and bit-exact — a lost acked
    write is the one unforgivable outcome;
  * an object may instead hold a payload that was submitted but never
    acked (the crash ate the ack, not the write) — allowed, but only
    BIT-EXACT WHOLE: the read must equal exactly one recorded payload,
    so a torn/partially-applied transaction (bytes from two
    generations mixed) has no digest to match and fails loudly;
  * an acked delete stays deleted (no resurrection), and an object
    that was never acked into existence may be absent.

Bookkeeping assumes each object is mutated by one logical client
stream at a time (concurrent streams use disjoint oids — the chaos
harness's layout), matching the per-object ordering the cluster
itself guarantees.

The oracle covers EVERY front door, not just RADOS: `CephFSDoor` and
`RGWDoor` duck-type the IoCtx surface the ledger drives (write_full /
remove_object / read with RadosError errno semantics), so the same
write/delete/verify machinery crash-verifies acked CephFS metadata
mutations (file create + data write + size flush, unlink) and RGW
object puts/deletes over HTTP.
"""

from __future__ import annotations

import hashlib
import threading
import time

from .rados import RadosError

ETIMEDOUT = 110
ENOENT = 2

# marker for "object absent" outcomes (deletes) in the candidate sets
_ABSENT = "<absent>"


def _digest(payload: bytes) -> str:
    return hashlib.sha256(bytes(payload)).hexdigest()


class LedgerViolation(AssertionError):
    """A durability guarantee was broken (lost acked write, resurrected
    delete, or torn/partially-applied state)."""


def _flight_record(oid: str, detail: str, acked, candidates) -> None:
    """Feed the op-tracing flight recorder BEFORE the violation
    propagates: when armed (conf flight_recorder_dir, or a test
    fixture arming it directly) every registered daemon's in-flight +
    historic ops and pg log summaries are snapshotted — the 'deg:
    ACKED write lost' class of flake becomes a captured timeline
    instead of a rerun-and-hope.  Disarmed: one flag check.  Never
    raises; the violation stays the headline."""
    try:
        from ..utils import optracker
        optracker.flight_record(
            f"ledger-{oid}",
            extra={"oid": oid, "violation": detail,
                   "acked_digest": acked,
                   "candidate_digests": sorted(candidates or ())})
    except Exception:
        pass


class DurabilityLedger:
    def __init__(self):
        self._lock = threading.Lock()
        # oid -> digest of the last ACKED payload (_ABSENT = acked
        # delete); missing key = never acked into existence
        self._acked: dict[str, str] = {}
        # oid -> {digests submitted but not (yet) acked since the last
        # ack}: any of these MAY be on disk after a crash
        self._maybe: dict[str, set[str]] = {}
        self.acked_writes = 0
        self.acked_deletes = 0

    # -- bookkeeping -------------------------------------------------------

    def note_submit(self, oid: str, payload: bytes) -> None:
        """About to submit a write of `payload`: whatever happens next
        (ack, timeout, crash), this payload may reach disk."""
        with self._lock:
            self._maybe.setdefault(oid, set()).add(_digest(payload))

    def note_ack(self, oid: str, payload: bytes) -> None:
        """The cluster acked the write: from now on losing it is data
        loss.  Earlier unacked candidates are superseded."""
        with self._lock:
            self._acked[oid] = _digest(payload)
            self._maybe.pop(oid, None)
            self.acked_writes += 1

    def note_delete_submit(self, oid: str) -> None:
        with self._lock:
            self._maybe.setdefault(oid, set()).add(_ABSENT)

    def note_delete_ack(self, oid: str) -> None:
        with self._lock:
            self._acked[oid] = _ABSENT
            self._maybe.pop(oid, None)
            self.acked_deletes += 1

    def oids(self) -> list[str]:
        with self._lock:
            return sorted(set(self._acked) | set(self._maybe))

    # -- driving convenience ----------------------------------------------

    def write(self, io, oid: str, payload: bytes,
              retry_window: float = 90.0, on_retry=None) -> bool:
        """write_full with ledger bookkeeping: submit is recorded
        first, timeouts are retried (the resend may commit the FIRST
        attempt — same payload, so one candidate digest covers both),
        and only a real cluster ack promotes to acked.  Returns True
        on ack, False when the window closed with the payload still
        only a candidate."""
        self.note_submit(oid, payload)
        end = time.time() + retry_window
        while True:
            try:
                io.write_full(oid, payload)
            except RadosError as e:
                if e.errno != ETIMEDOUT:
                    raise
                if time.time() > end:
                    return False
                if on_retry is not None:
                    on_retry()
                continue
            self.note_ack(oid, payload)
            return True

    def delete(self, io, oid: str, retry_window: float = 90.0,
               on_retry=None) -> bool:
        self.note_delete_submit(oid)
        end = time.time() + retry_window
        while True:
            try:
                io.remove_object(oid)
            except RadosError as e:
                if e.errno == ENOENT:
                    pass       # an earlier timed-out attempt committed
                elif e.errno != ETIMEDOUT:
                    raise
                elif time.time() > end:
                    return False
                else:
                    if on_retry is not None:
                        on_retry()
                    continue
            self.note_delete_ack(oid)
            return True

    # -- the oracle --------------------------------------------------------

    def expected(self, oid: str) -> tuple[str | None, set[str]]:
        """(acked outcome or None, candidate outcomes) for an oid."""
        with self._lock:
            return self._acked.get(oid), set(self._maybe.get(oid, ()))

    def verify(self, io, retry_window: float = 60.0,
               on_retry=None) -> dict:
        """Assert every recorded object against the live cluster.
        Retries ETIMEDOUT reads inside the window (the cluster may
        still be re-peering after a restart); any durability violation
        raises LedgerViolation naming the oid and what was found."""
        checked = bitexact = unacked_seen = absent = 0
        for oid in self.oids():
            acked, maybe = self.expected(oid)
            end = time.time() + retry_window
            while True:
                got: str | None
                try:
                    got = _digest(io.read(oid))
                except RadosError as e:
                    if e.errno == ENOENT:
                        got = _ABSENT
                    elif e.errno == ETIMEDOUT and time.time() < end:
                        if on_retry is not None:
                            on_retry()
                        continue
                    else:
                        _flight_record(
                            oid, f"read errno {e.errno} past window",
                            acked, maybe)
                        raise LedgerViolation(
                            f"{oid}: read failed with errno {e.errno} "
                            f"past the retry window") from e
                break
            checked += 1
            if got == acked:
                bitexact += 1
                if got == _ABSENT:
                    absent += 1
                continue
            if got in maybe:
                # a submitted-but-unacked payload landed whole, or an
                # unacked delete took effect: atomic, allowed
                unacked_seen += 1
                if got == _ABSENT:
                    absent += 1
                continue
            if acked is None and got == _ABSENT:
                absent += 1    # never acked into existence: absence ok
                continue
            if got == _ABSENT:
                _flight_record(oid, "ACKED write lost (absent)",
                               acked, maybe)
                raise LedgerViolation(
                    f"{oid}: ACKED write lost (object absent, expected "
                    f"digest {acked})")
            _flight_record(oid, f"torn/resurrected state: read {got}",
                           acked, maybe)
            raise LedgerViolation(
                f"{oid}: read digest {got} matches no recorded payload "
                f"(acked {acked}, candidates {sorted(maybe)}) — torn "
                f"or resurrected state")
        return {"checked": checked, "bitexact_acked": bitexact,
                "unacked_candidates_seen": unacked_seen,
                "absent": absent, "acked_writes": self.acked_writes,
                "acked_deletes": self.acked_deletes}


class CephFSDoor:
    """CephFS front door for the ledger: each oid is a file under
    `root`, so a ledger write exercises the MDS metadata mutation
    chain (dentry+inode create, striper data write, size flush) and
    verify proves acked mutations survive crash-restart cycles."""

    def __init__(self, fs, root: str = "/ledger"):
        self.fs = fs
        self.root = root.rstrip("/") or "/ledger"
        # per-path serialization standing in for CephFS file
        # capabilities: a real MDS revokes Fr from readers while a
        # writer holds Fw, so open-truncate-write is never observable
        # half-done — without this a concurrent read can see the
        # truncated-empty window and the stale-read oracle (rightly)
        # flags bytes belonging to no write
        self._mu = threading.Lock()
        self._paths: dict[str, threading.Lock] = {}
        try:
            fs.mkdirs(self.root)
        except RadosError as e:
            if e.errno != 17:          # EEXIST is fine; fail fast on
                raise                  # real MDS/store errors

    def _path(self, oid: str) -> str:
        return f"{self.root}/{oid}"

    def _cap(self, oid: str) -> threading.Lock:
        with self._mu:
            return self._paths.setdefault(oid, threading.Lock())

    def write_full(self, oid: str, payload: bytes) -> None:
        with self._cap(oid):
            with self.fs.open(self._path(oid), "w") as f:
                f.write(bytes(payload))

    def remove_object(self, oid: str) -> None:
        with self._cap(oid):
            self.fs.unlink(self._path(oid))  # FsError IS a RadosError

    def read(self, oid: str) -> bytes:
        with self._cap(oid):
            with self.fs.open(self._path(oid), "r") as f:
                return f.read()


class RGWDoor:
    """RGW front door for the ledger: oids are S3 object keys in one
    bucket, driven over real HTTP — an acked PUT/DELETE is promoted
    exactly when the gateway's 2xx lands, and verify reads via GET.
    Transport failures and 5xx map to ETIMEDOUT (retryable), 404 to
    ENOENT, anything else to EIO."""

    def __init__(self, base_url: str, bucket: str = "ledger",
                 timeout: float = 30.0, headers: dict | None = None):
        self.base = base_url.rstrip("/")
        self.bucket = bucket
        self.timeout = timeout
        self.headers = dict(headers or {})
        try:
            self._req("PUT", f"/{bucket}")
        except RadosError as e:
            if e.errno not in (17,):   # EEXIST is fine
                raise

    def _req(self, method: str, path: str,
             data: bytes | None = None) -> bytes:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            f"{self.base}{path}", data=data, method=method,
            headers=self.headers)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise RadosError(ENOENT, f"{method} {path}: 404") \
                    from e
            if e.code == 409:
                raise RadosError(17, f"{method} {path}: 409") from e
            if e.code >= 500:
                raise RadosError(ETIMEDOUT,
                                 f"{method} {path}: {e.code}") from e
            raise RadosError(5, f"{method} {path}: {e.code}") from e
        except OSError as e:           # refused/reset/timeout
            raise RadosError(ETIMEDOUT, f"{method} {path}: {e}") from e

    def write_full(self, oid: str, payload: bytes) -> None:
        self._req("PUT", f"/{self.bucket}/{oid}", bytes(payload))

    def remove_object(self, oid: str) -> None:
        self._req("DELETE", f"/{self.bucket}/{oid}")

    def read(self, oid: str) -> bytes:
        return self._req("GET", f"/{self.bucket}/{oid}")


class SwiftDoor:
    """Swift front door for the ledger: the same gateway namespace as
    :class:`RGWDoor`, spoken as TempAuth'd Swift v1 — the token is
    minted at ``/auth/v1.0`` from the account credentials and carried
    as ``X-Auth-Token`` on every container/object op (re-minted once
    on a 401, covering token expiry).  Errno mapping matches RGWDoor
    so the same ledger/fault drills drive both dialects."""

    def __init__(self, base_url: str, container: str = "ledger",
                 access_key: str = "", secret_key: str = "",
                 timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.container = container
        self.access_key = access_key
        self.secret_key = secret_key
        self.timeout = timeout
        self._token = ""
        self._acct = f"AUTH_{access_key or 'anon'}"
        try:
            self._req("PUT", f"/v1/{self._acct}/{container}")
        except RadosError as e:
            if e.errno != 17:          # 202 re-PUT never errors; only
                raise                  # real failures propagate

    def _authenticate(self) -> None:
        import urllib.request
        req = urllib.request.Request(
            f"{self.base}/auth/v1.0", method="GET",
            headers={"X-Auth-User": f"{self.access_key}:swift",
                     "X-Auth-Key": self.secret_key})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            self._token = r.headers.get("X-Auth-Token", "")

    def _req(self, method: str, path: str,
             data: bytes | None = None, _retry: bool = True) -> bytes:
        import urllib.error
        import urllib.request
        try:
            if not self._token:
                self._authenticate()
            req = urllib.request.Request(
                f"{self.base}{path}", data=data, method=method,
                headers={"X-Auth-Token": self._token})
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 401 and _retry:
                self._token = ""       # expired: re-mint once
                return self._req(method, path, data, _retry=False)
            if e.code == 404:
                raise RadosError(ENOENT, f"{method} {path}: 404") \
                    from e
            if e.code == 409:
                raise RadosError(17, f"{method} {path}: 409") from e
            if e.code >= 500:
                raise RadosError(ETIMEDOUT,
                                 f"{method} {path}: {e.code}") from e
            raise RadosError(5, f"{method} {path}: {e.code}") from e
        except OSError as e:           # refused/reset/timeout
            raise RadosError(ETIMEDOUT, f"{method} {path}: {e}") from e

    def _opath(self, oid: str) -> str:
        return f"/v1/{self._acct}/{self.container}/{oid}"

    def write_full(self, oid: str, payload: bytes) -> None:
        self._req("PUT", self._opath(oid), bytes(payload))

    def remove_object(self, oid: str) -> None:
        self._req("DELETE", self._opath(oid))

    def read(self, oid: str) -> bytes:
        return self._req("GET", self._opath(oid))


class TwoZoneLedger(DurabilityLedger):
    """The two-zone durability oracle: acks are recorded at the
    PRIMARY zone's door (the only door clients write), and
    :meth:`verify_zones` proves the multisite promise on top of the
    single-zone oracle:

      * the primary passes the base :meth:`verify` (acked state
        bit-exact, no torn bytes, deletes deleted);
      * the REPLICA zone eventually converges to exactly the
        primary's surviving state per object — async replication is
        allowed lag, never divergence (a candidate payload that
        landed at the primary without an ack replicates too, so the
        equality is against what the primary actually holds);
      * an object whose delete was acked at the primary never
        RESURRECTS at either zone, no matter how the partition /
        crash schedule interleaved with full/incremental sync.
    """

    def __init__(self, primary, replica):
        super().__init__()
        self.primary = primary
        self.replica = replica

    # writes/deletes enter at the primary zone only

    def write_primary(self, oid: str, payload: bytes,
                      retry_window: float = 90.0, on_retry=None) -> bool:
        return self.write(self.primary, oid, payload,
                          retry_window=retry_window, on_retry=on_retry)

    def delete_primary(self, oid: str, retry_window: float = 90.0,
                       on_retry=None) -> bool:
        return self.delete(self.primary, oid,
                           retry_window=retry_window, on_retry=on_retry)

    def _read_state(self, door, oid: str, retry_window: float,
                    on_retry) -> str:
        end = time.time() + retry_window
        while True:
            try:
                return _digest(door.read(oid))
            except RadosError as e:
                if e.errno == ENOENT:
                    return _ABSENT
                if e.errno == ETIMEDOUT and time.time() < end:
                    if on_retry is not None:
                        on_retry()
                    continue
                raise LedgerViolation(
                    f"{oid}: zone read failed with errno {e.errno} "
                    f"past the retry window") from e

    def verify_zones(self, retry_window: float = 60.0,
                     convergence_window: float = 60.0,
                     on_retry=None) -> dict:
        out = {"primary": self.verify(self.primary,
                                      retry_window=retry_window,
                                      on_retry=on_retry)}
        converged = 0
        for oid in self.oids():
            want = self._read_state(self.primary, oid, retry_window,
                                    on_retry)
            end = time.time() + convergence_window
            while True:
                got = self._read_state(self.replica, oid,
                                       retry_window, on_retry)
                if got == want:
                    break
                if time.time() > end:
                    acked, maybe = self.expected(oid)
                    _flight_record(
                        oid, f"replica never converged: primary "
                             f"{want}, replica {got}", acked, maybe)
                    raise LedgerViolation(
                        f"{oid}: replica zone never converged "
                        f"(primary {want}, replica {got} after "
                        f"{convergence_window}s)")
                if on_retry is not None:
                    on_retry()
                time.sleep(0.1)
            converged += 1
        # no-resurrection sweep: an ACKED delete must hold at BOTH
        # zones — a full sync racing the tombstone must not have
        # copied the object back
        resurrect_checked = 0
        for oid in self.oids():
            acked, _maybe = self.expected(oid)
            if acked != _ABSENT:
                continue
            for zone, door in (("primary", self.primary),
                               ("replica", self.replica)):
                got = self._read_state(door, oid, retry_window,
                                       on_retry)
                if got != _ABSENT:
                    _flight_record(oid, f"delete resurrected at "
                                        f"{zone}: {got}", acked, ())
                    raise LedgerViolation(
                        f"{oid}: acked delete RESURRECTED at the "
                        f"{zone} zone (read digest {got})")
            resurrect_checked += 1
        out["replica_converged"] = converged
        out["deletes_held_both_zones"] = resurrect_checked
        return out
