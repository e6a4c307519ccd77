"""RGW multisite sync: a secondary zone pulls from a primary over S3.

The rgw_data_sync.h model (rgw_data_sync_info's StateFullSync ->
StateIncrementalSync per bucket shard) reduced to its working core:

  * FULL SYNC: list the peer's buckets, mirror bucket metadata
    (versioning flag included), list each bucket and copy every
    current object;
  * INCREMENTAL: poll each bucket's replication log (the cls_rgw
    bilog analog, served at ``GET /bucket?bilog&marker=N``) and apply
    each entry — put (fetch + store), delete, delete-marker — keeping
    a durable per-bucket marker in the local zone's RADOS, so a
    restarted agent resumes where it left off.

Reductions vs the reference (documented scope): object VERSION
HISTORIES are not mirrored — a versioned bucket's current objects and
delete markers replicate, matching what a reader of the secondary
observes; multi-shard bilogs and inter-zone ACLs are out of scope.
Requests to the peer are SigV4-signed when credentials are given.

FAILURE MODEL (the "front doors under fire" hardening): the agent
must degrade, not wedge or tight-loop.  Every peer request consults
the FaultSet partition rules (zones talk HTTP, not the messenger, so
the net-fault plane is applied here explicitly); a failed bucket is
retried a bounded number of times in-round (``rgw_sync_retries``) and
then QUARANTINED under per-bucket exponential backoff
(``rgw_sync_backoff_base`` doubling to ``rgw_sync_backoff_max``) so
one unreachable/corrupt bucket cannot stall the others; a failed
discovery round backs the whole agent off on the same curve.  All of
it is counted in the ``rgw_sync`` perf block (sync_errors /
sync_retries / sync_backoff_secs ...), and the per-bucket cursors are
durable in the local zone's RADOS — a gateway crash or OSD
kill+rebirth mid-sync resumes from the last saved marker.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import quote, urlparse
from xml.sax.saxutils import unescape

from ..client.rados import RadosError
from ..utils import denc, faults
from ..utils.perf_counters import PerfCountersBuilder
from . import auth_v4, index_oid

SYNC_STATE_OID = "rgw.sync.state"     # omap: bucket -> marker state


class RGWSyncAgent:
    """Runs inside the SECONDARY zone's gateway process: pulls from
    `peer_url` and applies into the local RGWDaemon's store."""

    def __init__(self, gw, peer_url: str, access_key: str = "",
                 secret_key: str = "", interval: float = 0.5,
                 entity: str | None = None,
                 peer_entity: str | None = None, conf=None):
        self.gw = gw                      # local RGWDaemon
        self.peer = peer_url.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.interval = interval
        # FaultSet addresses: partition rules match these (zone links
        # are HTTP, so the agent applies the net-fault plane itself)
        self.entity = entity or f"rgw.{gw.port}"
        self.peer_entity = peer_entity or \
            f"rgw.{urlparse(self.peer).port}"
        self.conf = conf if conf is not None \
            else getattr(gw.rados, "conf", None)
        self.log_prefix = f"rgw-sync<{self.peer}>"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.errors = 0
        self.perf = (PerfCountersBuilder("rgw_sync")
                     .add_u64_counter("sync_rounds")
                     .add_u64_counter("sync_errors")
                     .add_u64_counter("sync_retries")
                     .add_u64_counter("sync_quarantines")
                     .add_u64_counter("sync_objects_copied")
                     .add_u64_counter("sync_deletes_applied")
                     .add_time("sync_backoff_secs")
                     .create_perf_counters())
        # bucket -> {"failures": n, "until": monotonic}: a quarantined
        # bucket sits out rounds until its backoff deadline passes
        self._quarantine: dict[str, dict] = {}
        self._round_failures = 0
        self._round_until = 0.0

    # -- knobs -------------------------------------------------------------

    def _knob(self, name: str, default):
        return getattr(self.conf, name, default) \
            if self.conf is not None else default

    def _backoff(self, failures: int) -> float:
        base = float(self._knob("rgw_sync_backoff_base", 0.5))
        cap = float(self._knob("rgw_sync_backoff_max", 10.0))
        return min(base * (2 ** max(0, failures - 1)), cap)

    def perf_dump(self) -> dict:
        """The ``perf dump rgw_sync`` block (schema pinned by
        tests/test_observability.py)."""
        out = self.perf.dump()
        out["quarantined_buckets"] = sorted(self._quarantine)
        return {"rgw_sync": out}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RGWSyncAgent":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rgw-sync")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- peer REST ---------------------------------------------------------

    def _req(self, method: str, path: str, raw_query: str = "",
             data: bytes = b"") -> bytes:
        if faults.get().partitioned(self.entity, self.peer_entity):
            # the zone link is HTTP: a messenger-style partition rule
            # must still sever it — surface as the transport error an
            # unreachable peer would produce
            raise OSError(f"partitioned: {self.entity} -x-> "
                          f"{self.peer_entity}")
        host = urlparse(self.peer).netloc
        headers: dict = {"Host": host}
        if self.access_key:
            headers.update(auth_v4.sign_v4(
                method, path, raw_query, {"host": host}, data,
                self.access_key, self.secret_key))
        url = self.peer + quote(path) + \
            (f"?{raw_query}" if raw_query else "")
        r = urllib.request.Request(url, data=data or None,
                                   method=method, headers=headers)
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.read()

    # -- durable per-bucket markers ---------------------------------------

    def _state(self) -> dict[str, dict]:
        try:
            raw = self.gw.io.get_omap(SYNC_STATE_OID)
        except RadosError:
            return {}
        return {b: denc.loads(v) for b, v in raw.items()}

    def _save_state(self, bucket: str, st: dict) -> None:
        self.gw.io.set_omap(SYNC_STATE_OID, {bucket: denc.dumps(st)})

    # -- sync passes -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if time.monotonic() < self._round_until:
                continue          # round-level backoff: poll, don't spin
            try:
                self.sync_once()
                self._round_failures = 0
            except Exception:
                # a failed DISCOVERY (peer unreachable/partitioned):
                # back the whole agent off exponentially instead of
                # tight-looping against a dead link
                self.errors += 1
                self.perf.inc("sync_errors")
                self._round_failures += 1
                backoff = self._backoff(self._round_failures)
                self._round_until = time.monotonic() + backoff
                self.perf.tinc("sync_backoff_secs", backoff)

    def sync_once(self) -> None:
        """One round: discover buckets, full-sync the new ones,
        incremental the rest.  A bucket that fails its bounded
        in-round retries is quarantined (skipped under exponential
        backoff) so the other buckets keep replicating."""
        import re
        self.perf.inc("sync_rounds")
        body = self._req("GET", "/").decode()
        buckets = [unescape(b) for b in
                   re.findall(r"<Name>([^<]+)</Name>", body)]
        retries = max(0, int(self._knob("rgw_sync_retries", 3)))
        now = time.monotonic()
        for bucket in buckets:
            q = self._quarantine.get(bucket)
            if q is not None and now < q["until"]:
                continue                   # still backing off
            if q is not None:
                self.perf.inc("sync_retries")   # post-backoff retry
            self._sync_bucket_bounded(bucket, retries, q)

    def _sync_bucket_bounded(self, bucket: str, retries: int,
                             q: dict | None) -> None:
        prior_failures = q["failures"] if q else 0
        for attempt in range(retries + 1):
            if self._stop.is_set():
                return
            try:
                # re-read the durable cursor each attempt: a partial
                # full sync saved progress before it failed
                st = self._state().get(bucket)
                if st is None or st.get("stage") == "full":
                    self._full_sync(bucket, st or {})
                else:
                    self._incremental(bucket, st)
                self._quarantine.pop(bucket, None)
                return
            except Exception:
                self.errors += 1
                self.perf.inc("sync_errors")
                if attempt < retries:
                    self.perf.inc("sync_retries")
        failures = prior_failures + 1
        backoff = self._backoff(failures)
        self._quarantine[bucket] = {
            "failures": failures,
            "until": time.monotonic() + backoff}
        self.perf.inc("sync_quarantines")
        self.perf.tinc("sync_backoff_secs", backoff)

    def _mirror_bucket_meta(self, bucket: str) -> None:
        if not self.gw._bucket_exists(bucket):
            self.gw._set_bucket_meta(bucket, {"created": ""})
            try:
                self.gw.io.write_full(index_oid(bucket), b"")
            except RadosError:
                pass
        try:
            vraw = self._req("GET", f"/{bucket}",
                             raw_query="versioning").decode()
        except urllib.error.HTTPError:
            return
        meta = self.gw._bucket_meta(bucket) or {"created": ""}
        for status in ("Enabled", "Suspended"):
            if f"<Status>{status}</Status>" in vraw:
                if meta.get("versioning") != status:
                    meta["versioning"] = status
                    self.gw._set_bucket_meta(bucket, meta)
                break

    def _full_sync(self, bucket: str, st: dict) -> None:
        """StateFullSync: pin the log position FIRST, then copy the
        listing — ops racing the copy land in the log and replay in
        the incremental stage (at-least-once, puts are idempotent)."""
        import re
        self._mirror_bucket_meta(bucket)
        if "marker" in st:
            # resuming a crashed full sync: keep the ORIGINAL pin —
            # ops logged while we were down must replay incrementally
            pinned = int(st["marker"])
        else:
            entries = json.loads(self._req(
                "GET", f"/{bucket}",
                raw_query="bilog&marker=0") or b"[]")
            pinned = max((e["seq"] for e in entries), default=0)
        marker = st.get("listing_marker", "")
        while True:
            q = "max-keys=100" + (f"&marker={quote(marker)}"
                                  if marker else "")
            body = self._req("GET", f"/{bucket}",
                             raw_query=q).decode()
            keys = [unescape(k) for k in
                    re.findall(r"<Key>([^<]+)</Key>", body)]
            for key in keys:
                self._copy_object(bucket, key)
            if "<IsTruncated>true</IsTruncated>" not in body \
                    or not keys:
                break
            marker = keys[-1]
            self._save_state(bucket, {"stage": "full",
                                      "listing_marker": marker,
                                      "marker": pinned})
        self._save_state(bucket, {"stage": "incr", "marker": pinned})

    def _incremental(self, bucket: str, st: dict) -> None:
        marker = int(st.get("marker", 0))
        entries = json.loads(self._req(
            "GET", f"/{bucket}",
            raw_query=f"bilog&marker={marker}") or b"[]")
        for ent in entries:
            op, key = ent.get("op"), ent.get("key", "")
            if op == "put":
                self._copy_object(bucket, key)
            elif op in ("delete", "delete-marker"):
                try:
                    self._apply_local("DELETE", bucket, key)
                    self.perf.inc("sync_deletes_applied")
                except urllib.error.HTTPError:
                    pass
            elif op == "delete-version":
                # version histories aren't mirrored: re-copy the
                # current object (covers marker-removal restores),
                # deleting when nothing current remains
                self._copy_object(bucket, key)
            marker = ent["seq"]
            self._save_state(bucket, {"stage": "incr",
                                      "marker": marker})

    def _copy_object(self, bucket: str, key: str) -> None:
        try:
            data = self._req("GET", f"/{bucket}/{key}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                try:
                    self._apply_local("DELETE", bucket, key)
                    self.perf.inc("sync_deletes_applied")
                except urllib.error.HTTPError:
                    pass
                return
            raise
        self._apply_local("PUT", bucket, key, data)
        self.perf.inc("sync_objects_copied")

    def _apply_local(self, method: str, bucket: str, key: str,
                     data: bytes = b"") -> None:
        """Apply through the LOCAL gateway's HTTP surface so index,
        versioning and bilog bookkeeping all engage."""
        host = f"127.0.0.1:{self.gw.port}"
        headers: dict = {"Host": host}
        if self.gw.access_key:
            headers.update(auth_v4.sign_v4(
                method, f"/{bucket}/{key}", "", {"host": host}, data,
                self.gw.access_key, self.gw.secret_key))
        r = urllib.request.Request(
            f"http://{host}/{quote(bucket)}/{quote(key)}",
            data=data if method == "PUT" else None,
            method=method, headers=headers)
        with urllib.request.urlopen(r, timeout=30):
            pass
