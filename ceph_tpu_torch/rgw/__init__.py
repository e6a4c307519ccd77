"""RGW: S3-dialect HTTP object gateway (rgw/rgw_main.cc, rgw_rest_s3.cc
reduced to the core object workflow).

The reference fronts RADOS with civetweb/asio frontends, a REST dialect
layer, and cls_rgw-maintained bucket indexes.  This gateway keeps that
shape: a threaded stdlib HTTP frontend, bucket metadata + per-bucket
indexes in omaps (mutated server-side), object data striped into the
data pool, and signature auth in both AWS v2 and v4 dialects
(auth_v4.py; rgw/rgw_auth_s3.h:24-32).  Object versioning follows
rgw/rgw_op.h:484-493 (RGWGetBucketVersioning/RGWSetBucketVersioning)
and RGWDeleteObj's delete-marker path: versioned buckets stack
versions per key, a plain DELETE plants a marker, and deleting the
marker restores the previous version.  Every mutation appends to a
per-bucket replication log (the cls_rgw bilog analog, served at
``?bilog&marker=N``) that feeds the multisite sync agent
(rgw/sync.py).  The Swift v1 dialect (rgw/swift.py, TempAuth +
container/object ops over the SAME namespace) serves /auth/v1.0 and
/v1/* requests that don't carry AWS signatures.  Lifecycle is out of
scope.

S3 surface:
    GET  /                          ListAllMyBuckets
    PUT  /bucket                    create bucket
    DELETE /bucket                  delete (must be empty)
    GET  /bucket?prefix=&max-keys=&marker=   ListBucket (paginated:
                                    NextMarker continuation, index read
                                    via ranged omap — O(page), not
                                    O(bucket))
    GET  /bucket?uploads            list in-progress multipart uploads
    PUT  /bucket/key                put object
    GET|HEAD /bucket/key            get/stat object
    DELETE /bucket/key              delete object
    POST /bucket/key?uploads        InitiateMultipartUpload
    PUT  /bucket/key?uploadId=&partNumber=   UploadPart
    POST /bucket/key?uploadId=      CompleteMultipartUpload
    DELETE /bucket/key?uploadId=    AbortMultipartUpload
(rgw/rgw_op.cc RGWInitMultipart/RGWPutObj 'multipart'/
 RGWCompleteMultipart/RGWAbortMultipart, rgw_rest_s3.cc)
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, unquote, urlparse
from xml.sax.saxutils import escape

from ..client.rados import RadosError
from ..client.striper import Layout, StripedObject
from ..utils import denc
from . import auth_v4

BUCKETS_ROOT = "rgw.buckets"        # omap: bucket name -> meta
DATA_POOL = "rgw_data"


def index_oid(bucket: str) -> str:
    return f"bucket.index.{bucket}"


def uploads_oid(bucket: str) -> str:
    """omap: uploadId -> {key, started} (RGWMPObj meta analog)."""
    return f"bucket.uploads.{quote(bucket, safe='')}"


def parts_oid(bucket: str, upload_id: str) -> str:
    """omap: zero-padded part number -> {etag, size}."""
    return f"bucket.parts.{quote(bucket, safe='')}.{upload_id}"


def part_soid(bucket: str, key: str, upload_id: str, n: int) -> str:
    return obj_soid(bucket, key) + f".mp.{upload_id}.{n:05d}"


def obj_soid(bucket: str, key: str) -> str:
    """Collision-proof backing name: bucket and key are fully quoted
    (so 'a'/'b.c' and 'a.b'/'c' cannot alias, and '@' — reserved by
    the OSD namespace — never appears) and joined with '/', which the
    quoting removes from both halves."""
    return f"obj.{quote(bucket, safe='')}/{quote(key, safe='')}"


def versions_oid(bucket: str) -> str:
    """omap: quoted-key + NUL + version-id -> version meta.  The vid
    is a descending time stamp (see new_version_id), so a ranged read
    under one key's prefix walks versions newest-first."""
    return f"bucket.versions.{quote(bucket, safe='')}"


def version_key(key: str, vid: str) -> str:
    return f"{quote(key, safe='')}\x00{vid}"


def ver_soid(bucket: str, key: str, vid: str) -> str:
    """Backing object for one version.  The 'null' version (pre-
    versioning writes, and writes while suspended) lives at the base
    name so enabling versioning needs no data movement."""
    base = obj_soid(bucket, key)
    return base if vid == "null" else f"{base}.v.{vid}"


def bilog_oid(bucket: str) -> str:
    """omap: zero-padded seq -> replication-log entry (the cls_rgw
    bucket-index log reduced; rgw_data_sync.h incremental-sync feed)."""
    return f"bucket.bilog.{quote(bucket, safe='')}"


def new_version_id() -> str:
    """Lexically ASCENDING = newest first (complemented nanoseconds),
    plus randomness against same-tick collisions."""
    import os
    return (f"{0xFFFFFFFFFFFFFFFF - time.time_ns():016x}"
            f"{os.urandom(3).hex()}")


class RGWDaemon:
    """The radosgw process: HTTP frontend over a Rados handle."""

    def __init__(self, rados, port: int = 0, access_key: str = "",
                 secret_key: str = "", data_pool: str = DATA_POOL):
        self.rados = rados
        self.access_key = access_key
        self.secret_key = secret_key
        try:
            rados.create_pool(data_pool)
        except RadosError:
            pass
        self.io = rados.open_ioctx(data_pool)
        # per-key mutation guard (cls_rgw's prepare/complete head
        # guard reduced): PUT is remove-then-write-then-index and
        # DELETE is remove-then-unindex, so two overlapping mutations
        # on one key could interleave into an index entry pointing at
        # removed data — a permanent tear no read retry can settle
        self._keylock_mu = threading.Lock()
        self._keylocks: dict[tuple, threading.Lock] = {}
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                gw.handle(self, "GET")

            def do_PUT(self):
                gw.handle(self, "PUT")

            def do_DELETE(self):
                gw.handle(self, "DELETE")

            def do_HEAD(self):
                gw.handle(self, "HEAD")

            def do_POST(self):
                gw.handle(self, "POST")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RGWDaemon":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="rgw-http")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- auth (AWS v2-style shared-key signatures) -------------------------

    def _check_auth(self, req, method: str, path: str,
                    raw_query: str = "", body: bytes = b"") -> bool:
        if not self.access_key:
            return True                      # auth disabled
        header = req.headers.get("Authorization", "")
        if header.startswith(auth_v4.ALGORITHM):
            headers = {k.lower(): v for k, v in req.headers.items()}
            return auth_v4.verify_v4(method, path, raw_query, headers,
                                     body, self.access_key,
                                     self.secret_key)
        want = sign_v2(method, path, req.headers.get("Date", ""),
                       self.access_key, self.secret_key)
        return hmac.compare_digest(want, header)

    # -- replication log (cls_rgw bilog reduced) ---------------------------

    def _bilog(self, bucket: str, op: str, key: str,
               vid: str | None = None) -> None:
        """Append one entry to the bucket's replication log.  Seq is
        allocated from a per-bucket counter key; readers page with
        ?bilog&marker=N (rgw_data_sync.h incremental feed)."""
        try:
            # one atomic in-OSD append: concurrent object ops cannot
            # collide on a seq or clobber each other's entries
            self.io.execute(bilog_oid(bucket), "kvstore",
                            "append_log", denc.dumps({
                                "entry": denc.dumps(
                                    {"op": op, "key": key, "vid": vid,
                                     "ts": _http_date()})}))
        except RadosError:
            pass          # replication log must never fail the op

    def _bilog_page(self, bucket: str, marker: int,
                    count: int = 1000) -> list[dict]:
        try:
            vals = self.io.get_omap_vals(
                bilog_oid(bucket), start_after=f"{marker:020d}",
                prefix="", max_return=count + 1)
        except RadosError:
            return []
        out = []
        for k in sorted(vals):
            if k.startswith("\x00"):
                continue
            ent = denc.loads(vals[k])
            ent["seq"] = int(k)
            out.append(ent)
        return out[:count]

    def _create_bucket(self, bucket: str) -> None:
        self._set_bucket_meta(bucket, {"created": _http_date()})
        try:
            self.io.write_full(index_oid(bucket), b"")
        except RadosError:
            pass

    def _remove_bucket(self, bucket: str) -> None:
        self.io.rm_omap_keys(BUCKETS_ROOT, [bucket])
        for oid in (index_oid(bucket), bilog_oid(bucket)):
            try:
                self.io.remove_object(oid)
            except RadosError:
                pass

    # -- bucket metadata ---------------------------------------------------

    def _buckets(self) -> dict:
        try:
            return {k: denc.loads(v)
                    for k, v in self.io.get_omap(BUCKETS_ROOT).items()}
        except RadosError:
            return {}

    def _bucket_exists(self, bucket: str) -> bool:
        return self._bucket_meta(bucket) is not None

    def _bucket_meta(self, bucket: str) -> dict | None:
        try:
            got = self.io.get_omap_keys(BUCKETS_ROOT, [bucket])
        except RadosError:
            return None
        blob = got.get(bucket)
        return denc.loads(blob) if blob else None

    def _set_bucket_meta(self, bucket: str, meta: dict) -> None:
        self.io.set_omap(BUCKETS_ROOT, {bucket: denc.dumps(meta)})

    def _index_entry(self, bucket: str, key: str) -> dict | None:
        """One key's index record — a single-key omap read, not the
        whole bucket index."""
        try:
            got = self.io.get_omap_keys(index_oid(bucket), [key])
        except RadosError:
            return None
        blob = got.get(key)
        return denc.loads(blob) if blob else None

    def _index_page(self, bucket: str, marker: str, prefix: str,
                    count: int) -> dict:
        try:
            return {k: denc.loads(v) for k, v in self.io.get_omap_vals(
                index_oid(bucket), start_after=marker, prefix=prefix,
                max_return=count).items()}
        except RadosError:
            return {}

    def _index_empty(self, bucket: str) -> bool:
        return not self._index_page(bucket, "", "", 1)

    # -- request routing ---------------------------------------------------

    def handle(self, req, method: str) -> None:
        parsed = urlparse(req.path)
        path = unquote(parsed.path)
        query = parse_qs(parsed.query, keep_blank_values=True)
        # drain the request body FIRST: replying on an error path with
        # unread body bytes desyncs the keep-alive connection (the next
        # request line would be parsed out of the leftover payload)
        try:
            length = int(req.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self._error(req, 400, "InvalidArgument")
            return
        body = req.rfile.read(length) if length > 0 else b""
        from . import swift
        authz = req.headers.get("Authorization", "")
        if swift.handles(path) and not authz.startswith("AWS"):
            # the Swift dialect authenticates with its own TempAuth
            # token (rgw_rest_swift.cc), not AWS signatures
            try:
                swift.dispatch(self, req, method, path, query, body)
            except RadosError as e:
                self._error(req, 500, f"InternalError: {e}")
            return
        if not self._check_auth(req, method, path, parsed.query, body):
            self._error(req, 403, "AccessDenied")
            return
        parts = [p for p in path.split("/") if p]
        try:
            if not parts:
                if method == "GET":
                    self._list_buckets(req)
                else:
                    self._error(req, 405, "MethodNotAllowed")
            elif len(parts) == 1:
                self._bucket_op(req, method, parts[0], query, body)
            else:
                self._object_op(req, method, parts[0],
                                "/".join(parts[1:]), body, query)
        except RadosError as e:
            self._error(req, 500, f"InternalError: {e}")

    # -- responses ---------------------------------------------------------

    def _reply(self, req, code: int, body: bytes = b"",
               headers: dict | None = None) -> None:
        req.send_response(code)
        have_len = False
        for k, v in (headers or {}).items():
            req.send_header(k, v)
            if k.lower() == "content-length":
                have_len = True      # HEAD advertises the entity size
        if not have_len:
            req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        if req.command != "HEAD" and len(body):
            # gather-write: striper reads arrive as BufferList ropes —
            # the segments go straight to the socket, never joined
            from ..utils.bufferlist import iov_of
            for seg in iov_of(body):
                req.wfile.write(seg)

    def _xml(self, req, code: int, body: str,
             headers: dict | None = None) -> None:
        self._reply(req, code,
                    ('<?xml version="1.0" encoding="UTF-8"?>'
                     + body).encode(),
                    {"Content-Type": "application/xml",
                     **(headers or {})})

    def _error(self, req, code: int, s3code: str) -> None:
        self._xml(req, code, f"<Error><Code>{escape(s3code)}</Code>"
                             f"</Error>")

    # -- bucket ops --------------------------------------------------------

    def _list_buckets(self, req) -> None:
        entries = "".join(
            f"<Bucket><Name>{escape(name)}</Name>"
            f"<CreationDate>{meta['created']}</CreationDate></Bucket>"
            for name, meta in sorted(self._buckets().items()))
        self._xml(req, 200,
                  "<ListAllMyBucketsResult><Buckets>"
                  f"{entries}</Buckets></ListAllMyBucketsResult>")

    def _bucket_op(self, req, method: str, bucket: str,
                   query: dict, body: bytes = b"") -> None:
        if "versioning" in query:
            self._versioning_op(req, method, bucket, body)
            return
        if "versions" in query and method in ("GET", "HEAD"):
            self._list_versions(req, bucket, query)
            return
        if "bilog" in query and method == "GET":
            import json
            try:
                marker = int(query.get("marker", ["0"])[0])
            except ValueError:
                self._error(req, 400, "InvalidArgument")
                return
            entries = self._bilog_page(bucket, marker)
            self._reply(req, 200, json.dumps(entries).encode(),
                        {"Content-Type": "application/json"})
            return
        buckets = self._buckets()
        if method == "PUT":
            if bucket in buckets:
                self._error(req, 409, "BucketAlreadyExists")
                return
            self._create_bucket(bucket)
            self._reply(req, 200)
        elif method == "DELETE":
            if bucket not in buckets:
                self._error(req, 404, "NoSuchBucket")
                return
            if not self._index_empty(bucket):
                self._error(req, 409, "BucketNotEmpty")
                return
            self._remove_bucket(bucket)
            self._reply(req, 204)
        elif method in ("GET", "HEAD"):
            if bucket not in buckets:
                self._error(req, 404, "NoSuchBucket")
                return
            if "uploads" in query:
                self._list_uploads(req, bucket)
                return
            prefix = query.get("prefix", [""])[0]
            marker = query.get("marker", [""])[0]
            try:
                max_keys = int(query.get("max-keys", ["1000"])[0])
            except ValueError:
                self._error(req, 400, "InvalidArgument")
                return
            if max_keys < 0:
                self._error(req, 400, "InvalidArgument")
                return
            # ranged index read: one page + 1 sentinel for IsTruncated
            # (RGWRados::cls_bucket_list marker pagination)
            # delete-marker-latest keys are invisible to a plain list
            # (RGWListBucket skips entries whose current version is a
            # marker); page through the index until a full page of
            # visible keys (or exhaustion)
            page = {}
            cursor = marker
            exhausted = False
            while len(page) <= max_keys and not exhausted:
                chunk = self._index_page(bucket, cursor, prefix,
                                         max_keys + 1)
                if len(chunk) < max_keys + 1:
                    exhausted = True
                for k, v in chunk.items():
                    if not v.get("delete_marker"):
                        page[k] = v
                if chunk:
                    cursor = max(chunk)
            keys = sorted(page)
            truncated = len(keys) > max_keys
            keys = keys[:max_keys]
            entries = "".join(
                f"<Contents><Key>{escape(k)}</Key>"
                f"<Size>{page[k]['size']}</Size>"
                f"<ETag>&quot;{page[k]['etag']}&quot;</ETag>"
                "</Contents>"
                for k in keys)
            next_marker = (f"<NextMarker>{escape(keys[-1])}"
                           f"</NextMarker>") if truncated and keys \
                else ""
            self._xml(req, 200,
                      "<ListBucketResult>"
                      f"<Name>{escape(bucket)}</Name>"
                      f"<Prefix>{escape(prefix)}</Prefix>"
                      f"<Marker>{escape(marker)}</Marker>"
                      f"<KeyCount>{len(keys)}</KeyCount>"
                      f"<IsTruncated>{str(truncated).lower()}"
                      f"</IsTruncated>{next_marker}{entries}"
                      "</ListBucketResult>")
        else:
            self._error(req, 405, "MethodNotAllowed")

    # -- versioning (rgw/rgw_op.h:484-493 RGWGet/SetBucketVersioning) ------

    def _versioning_op(self, req, method: str, bucket: str,
                       body: bytes) -> None:
        meta = self._bucket_meta(bucket)
        if meta is None:
            self._error(req, 404, "NoSuchBucket")
            return
        if method in ("GET", "HEAD"):
            status = meta.get("versioning", "")
            inner = f"<Status>{status}</Status>" if status else ""
            self._xml(req, 200,
                      '<VersioningConfiguration xmlns="http://s3.'
                      f'amazonaws.com/doc/2006-03-01/">{inner}'
                      "</VersioningConfiguration>")
        elif method == "PUT":
            import re
            m = re.search(rb"<Status>\s*(Enabled|Suspended)\s*"
                          rb"</Status>", body)
            if m is None:
                self._error(req, 400, "IllegalVersioningConfiguration"
                                      "Exception")
                return
            meta["versioning"] = m.group(1).decode()
            self._set_bucket_meta(bucket, meta)
            self._reply(req, 200)
        else:
            self._error(req, 405, "MethodNotAllowed")

    def _version_record(self, bucket: str, key: str,
                        vid: str) -> dict | None:
        try:
            got = self.io.get_omap_keys(versions_oid(bucket),
                                        [version_key(key, vid)])
        except RadosError:
            got = {}          # no versions object yet: still fall
                              # through to the null-version fallback
        blob = got.get(version_key(key, vid))
        if blob:
            return denc.loads(blob)
        if vid == "null":
            # a pre-versioning object is addressable as version "null"
            # IMMEDIATELY (S3 null-version semantics); the omap record
            # only materializes on the next write (_migrate_null_
            # version), so fall back to the unmigrated index entry
            ent = self._index_entry(bucket, key)
            if ent is not None and \
                    ent.get("version_id", "null") == "null":
                return ent
        return None

    def _put_version_record(self, bucket: str, key: str, vid: str,
                            rec: dict) -> None:
        self.io.set_omap(versions_oid(bucket),
                         {version_key(key, vid): denc.dumps(rec)})

    def _key_versions(self, bucket: str, key: str) -> list[tuple]:
        """All (vid, record) for one key, newest first (vids are
        complemented timestamps, so lexical order IS newest-first)."""
        prefix = quote(key, safe="") + "\x00"
        try:
            vals = self.io.get_omap_vals(versions_oid(bucket),
                                         start_after="", prefix=prefix,
                                         max_return=100000)
        except RadosError:
            return []
        out = [(k[len(prefix):], denc.loads(v))
               for k, v in sorted(vals.items())]
        # a "null" vid sorts after hex stamps; order by recorded mtime
        out.sort(key=lambda t: -t[1].get("mtime_ns", 0))
        return out

    def _migrate_null_version(self, bucket: str, key: str) -> None:
        """First versioned write over a pre-versioning object: the
        existing base-name data becomes the 'null' version (S3's
        null-version semantics — no data movement, just a record)."""
        ent = self._index_entry(bucket, key)
        if ent is not None and "version_id" not in ent:
            ent["version_id"] = "null"
            ent["mtime_ns"] = ent.get("mtime_ns", 0)
            self._put_version_record(bucket, key, "null", ent)

    def _list_versions(self, req, bucket: str, query: dict) -> None:
        if not self._bucket_exists(bucket):
            self._error(req, 404, "NoSuchBucket")
            return
        prefix = query.get("prefix", [""])[0]
        try:
            vals = self.io.get_omap_vals(
                versions_oid(bucket), start_after="",
                prefix=quote(prefix, safe="") if prefix else "",
                max_return=100000)
        except RadosError:
            vals = {}
        per_key: dict[str, list] = {}
        for k, blob in vals.items():
            qkey, _, vid = k.partition("\x00")
            per_key.setdefault(unquote(qkey), []).append(
                (vid, denc.loads(blob)))
        entries = []
        for key in sorted(per_key):
            cur = self._index_entry(bucket, key) or {}
            latest_vid = cur.get("version_id")
            vers = sorted(per_key[key],
                          key=lambda t: -t[1].get("mtime_ns", 0))
            for vid, rec in vers:
                tag = ("DeleteMarker" if rec.get("delete_marker")
                       else "Version")
                extra = ("" if rec.get("delete_marker") else
                         f"<Size>{rec.get('size', 0)}</Size>"
                         f"<ETag>&quot;{rec.get('etag', '')}&quot;"
                         "</ETag>")
                entries.append(
                    f"<{tag}><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{str(vid == latest_vid).lower()}"
                    f"</IsLatest>"
                    f"<LastModified>{rec.get('mtime', '')}"
                    f"</LastModified>{extra}</{tag}>")
        self._xml(req, 200,
                  "<ListVersionsResult>"
                  f"<Name>{escape(bucket)}</Name>"
                  f"<Prefix>{escape(prefix)}</Prefix>"
                  f"{''.join(entries)}</ListVersionsResult>")

    # -- object ops --------------------------------------------------------

    def _object_op(self, req, method: str, bucket: str,
                   key: str, body: bytes = b"",
                   query: dict | None = None) -> None:
        query = query or {}
        bmeta = self._bucket_meta(bucket)
        if bmeta is None:
            self._error(req, 404, "NoSuchBucket")
            return
        vstate = bmeta.get("versioning", "")
        upload_id = query.get("uploadId", [None])[0]
        if method == "POST" and "uploads" in query:
            self._initiate_multipart(req, bucket, key)
            return
        if upload_id is not None:
            if method == "PUT":
                self._upload_part(req, bucket, key, upload_id,
                                  query, body)
            elif method == "POST":
                self._complete_multipart(req, bucket, key, upload_id,
                                         body)
            elif method == "DELETE":
                self._abort_multipart(req, bucket, key, upload_id)
            else:
                self._error(req, 405, "MethodNotAllowed")
            return
        req_vid = query.get("versionId", [None])[0]
        if method == "PUT":
            self._put_object(req, bucket, key, body, vstate)
        elif method in ("GET", "HEAD"):
            self._get_object(req, method, bucket, key, req_vid)
        elif method == "DELETE":
            self._delete_object(req, bucket, key, req_vid, vstate)
        else:
            self._error(req, 405, "MethodNotAllowed")

    @staticmethod
    def _serve_tag_ok(ent: dict, data: bytes) -> bool:
        """True when the bytes about to be served match the index
        entry that advertised them.  The etag is the exact tag for a
        plain PUT (md5 of the body); a striper read racing a
        remove-then-write returns sparse ZEROS of the right length,
        which only the content hash catches.  Multipart etags are
        compound (md5-of-md5s ``-N``), so those fall back to the
        length check."""
        if len(data) != int(ent["size"]):
            return False
        etag = ent.get("etag", "")
        if "-" in etag:
            return True
        from ..utils.bufferlist import iov_of
        m = hashlib.md5()
        for seg in iov_of(data):
            m.update(seg)
        return m.hexdigest() == etag

    def _keylock(self, bucket: str, key: str) -> threading.Lock:
        with self._keylock_mu:
            return self._keylocks.setdefault((bucket, key),
                                             threading.Lock())

    def _put_object(self, req, bucket: str, key: str, body: bytes,
                    vstate: str, swift_status: int | None = None) -> None:
        with self._keylock(bucket, key):
            self._put_object_locked(req, bucket, key, body, vstate,
                                    swift_status)

    def _put_object_locked(self, req, bucket: str, key: str,
                           body: bytes, vstate: str,
                           swift_status: int | None = None) -> None:
        etag = hashlib.md5(body).hexdigest()
        ent = {"size": len(body), "etag": etag, "mtime": _http_date(),
               "mtime_ns": time.time_ns()}
        headers = {"ETag": f'"{etag}"'}
        if vstate == "Enabled":
            self._migrate_null_version(bucket, key)
            vid = new_version_id()
            ent["version_id"] = vid
            StripedObject(self.io, ver_soid(bucket, key, vid)).write(
                body)
            self._put_version_record(bucket, key, vid, ent)
            headers["x-amz-version-id"] = vid
        else:
            # unversioned OR suspended: (over)write the null version.
            # Always clear the base object first — StripedObject.write
            # never truncates, so writing a shorter body over leftover
            # base data would serve a stale tail
            so = StripedObject(self.io, obj_soid(bucket, key))
            try:
                so.remove()
            except RadosError:
                pass
            so.write(body)
            if vstate == "Suspended":
                ent["version_id"] = "null"
                self._put_version_record(bucket, key, "null", ent)
                headers["x-amz-version-id"] = "null"
        self.io.set_omap(index_oid(bucket), {key: denc.dumps(ent)})
        self._bilog(bucket, "put", key, ent.get("version_id"))
        self._reply(req, swift_status or 200, headers=headers)

    def _get_object(self, req, method: str, bucket: str, key: str,
                    req_vid: str | None) -> None:
        # torn-read retry (RGWRados::get_obj's -ECANCELED loop): the
        # unversioned PUT path is remove-then-write (the striper never
        # truncates) and DELETE is remove-then-unindex, so a GET
        # landing inside either window can pair a live index entry
        # with missing/partial data.  Real RGW detects the head tag
        # changing under the read and restarts; here the index entry's
        # recorded size is the tag — on mismatch re-read from the
        # index, and only a persistent tear (never observed outside a
        # true race) surfaces as a retryable 500
        for _ in range(20):
            if req_vid is None:
                ent = self._index_entry(bucket, key)
                if ent is None:
                    self._error(req, 404, "NoSuchKey")
                    return
                if ent.get("delete_marker"):
                    req.send_response(404)
                    req.send_header("x-amz-delete-marker", "true")
                    req.send_header("x-amz-version-id",
                                    ent.get("version_id", "null"))
                    req.send_header("Content-Length", "0")
                    req.end_headers()
                    return
                vid = ent.get("version_id", "null")
            else:
                vid = req_vid
                ent = self._version_record(bucket, key, vid)
                if ent is None:
                    self._error(req, 404, "NoSuchVersion")
                    return
                if ent.get("delete_marker"):
                    # GET on a delete-marker version is 405 per S3
                    self._error(req, 405, "MethodNotAllowed")
                    return
            so = StripedObject(self.io, ver_soid(bucket, key, vid))
            data = so.read() if method == "GET" else b""
            if method != "GET" or self._serve_tag_ok(ent, data):
                break
            time.sleep(0.05)
        else:
            self._error(req, 500, "ReadRaceNotSettled")
            return
        req.send_response(200)
        # GET: length of what we actually send (a concurrent
        # overwrite can race the index read); HEAD: index size
        req.send_header("Content-Length",
                        str(len(data)) if method == "GET"
                        else str(ent["size"]))
        req.send_header("ETag", f'"{ent["etag"]}"')
        req.send_header("Last-Modified", ent["mtime"])
        if vid != "null" or req_vid is not None:
            req.send_header("x-amz-version-id", vid)
        req.send_header("Content-Type", "application/octet-stream")
        req.end_headers()
        if method == "GET":
            from ..utils.bufferlist import iov_of
            for seg in iov_of(data):
                req.wfile.write(seg)

    def _delete_object(self, req, bucket: str, key: str,
                       req_vid: str | None, vstate: str) -> None:
        with self._keylock(bucket, key):
            self._delete_object_locked(req, bucket, key, req_vid,
                                       vstate)

    def _delete_object_locked(self, req, bucket: str, key: str,
                              req_vid: str | None, vstate: str) -> None:
        if req_vid is not None:
            self._delete_version(req, bucket, key, req_vid)
            return
        if vstate in ("Enabled", "Suspended"):
            # plant a delete marker (RGWDeleteObj's versioned path);
            # suspended buckets use the null id, replacing any null
            # version outright
            self._migrate_null_version(bucket, key)
            vid = (new_version_id() if vstate == "Enabled" else "null")
            if vid == "null":
                old = self._version_record(bucket, key, "null")
                if old is not None and not old.get("delete_marker"):
                    StripedObject(self.io,
                                  ver_soid(bucket, key, "null")).remove()
            marker = {"delete_marker": True, "version_id": vid,
                      "mtime": _http_date(), "mtime_ns": time.time_ns()}
            self._put_version_record(bucket, key, vid, marker)
            self.io.set_omap(index_oid(bucket),
                             {key: denc.dumps(marker)})
            self._bilog(bucket, "delete-marker", key, vid)
            self._reply(req, 204, headers={
                "x-amz-delete-marker": "true",
                "x-amz-version-id": vid})
            return
        if self._index_entry(bucket, key) is not None:
            StripedObject(self.io, obj_soid(bucket, key)).remove()
            self.io.rm_omap_keys(index_oid(bucket), [key])
            self._bilog(bucket, "delete", key)
        self._reply(req, 204)

    def _delete_version(self, req, bucket: str, key: str,
                        vid: str) -> None:
        """Permanent removal of one version; deleting the current
        delete marker restores the previous version as latest."""
        rec = self._version_record(bucket, key, vid)
        if rec is None:
            self._error(req, 404, "NoSuchVersion")
            return
        if not rec.get("delete_marker"):
            try:
                StripedObject(self.io,
                              ver_soid(bucket, key, vid)).remove()
            except RadosError:
                pass
        self.io.rm_omap_keys(versions_oid(bucket),
                             [version_key(key, vid)])
        cur = self._index_entry(bucket, key)
        if cur is not None and cur.get("version_id", "null") == vid:
            remaining = self._key_versions(bucket, key)
            if remaining:
                _, newest = remaining[0]
                self.io.set_omap(index_oid(bucket),
                                 {key: denc.dumps(newest)})
            else:
                self.io.rm_omap_keys(index_oid(bucket), [key])
        self._bilog(bucket, "delete-version", key, vid)
        headers = {"x-amz-version-id": vid}
        if rec.get("delete_marker"):
            headers["x-amz-delete-marker"] = "true"
        self._reply(req, 204, headers=headers)

    # -- multipart upload (RGWInitMultipart/RGWCompleteMultipart) ----------

    def _initiate_multipart(self, req, bucket: str, key: str) -> None:
        import uuid
        upload_id = uuid.uuid4().hex[:16]
        self.io.set_omap(uploads_oid(bucket), {upload_id: denc.dumps(
            {"key": key, "started": _http_date()})})
        self._xml(req, 200,
                  "<InitiateMultipartUploadResult>"
                  f"<Bucket>{escape(bucket)}</Bucket>"
                  f"<Key>{escape(key)}</Key>"
                  f"<UploadId>{upload_id}</UploadId>"
                  "</InitiateMultipartUploadResult>")

    def _upload_meta(self, bucket: str, upload_id: str) -> dict | None:
        try:
            got = self.io.get_omap_keys(uploads_oid(bucket),
                                        [upload_id])
        except RadosError:
            return None
        blob = got.get(upload_id)
        return denc.loads(blob) if blob else None

    def _upload_part(self, req, bucket: str, key: str, upload_id: str,
                     query: dict, body: bytes) -> None:
        meta = self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            self._error(req, 404, "NoSuchUpload")
            return
        try:
            n = int(query.get("partNumber", ["0"])[0])
        except ValueError:
            n = 0
        if not 1 <= n <= 10000:
            self._error(req, 400, "InvalidPartNumber")
            return
        StripedObject(self.io,
                      part_soid(bucket, key, upload_id, n)).write(body)
        etag = hashlib.md5(body).hexdigest()
        self.io.set_omap(parts_oid(bucket, upload_id), {
            f"{n:05d}": denc.dumps({"etag": etag,
                                    "size": len(body)})})
        self._reply(req, 200, headers={"ETag": f'"{etag}"'})

    def _complete_multipart(self, req, bucket: str, key: str,
                            upload_id: str, body: bytes) -> None:
        import re
        meta = self._upload_meta(bucket, upload_id)
        if meta is None or meta["key"] != key:
            self._error(req, 404, "NoSuchUpload")
            return
        try:
            parts = {int(k): denc.loads(v) for k, v in
                     self.io.get_omap(parts_oid(bucket,
                                                upload_id)).items()}
        except RadosError:
            parts = {}
        want = [int(m) for m in
                re.findall(r"<PartNumber>(\d+)</PartNumber>",
                           body.decode("utf-8", "replace"))] \
            if body else sorted(parts)
        if not want or any(n not in parts for n in want):
            self._error(req, 400, "InvalidPart")
            return
        if any(b <= a for a, b in zip(want, want[1:])):
            # S3 requires strictly ascending part numbers — which also
            # rejects duplicates (a part listed twice would be
            # concatenated twice into the final object)
            self._error(req, 400, "InvalidPartOrder")
            return
        # assemble: copy each part into the final object at its
        # cumulative offset (RGWCompleteMultipart assembles via the
        # manifest; here data moves once through the striper).  On a
        # versioning-enabled bucket the completed object is a NEW
        # version, like any other PUT.
        bmeta = self._bucket_meta(bucket) or {}
        vstate = bmeta.get("versioning", "")
        vid = None
        if vstate == "Enabled":
            self._migrate_null_version(bucket, key)
            vid = new_version_id()
            final = StripedObject(self.io, ver_soid(bucket, key, vid))
        else:
            if vstate == "Suspended":
                vid = "null"
            final = StripedObject(self.io, obj_soid(bucket, key))
            try:
                final.remove()   # write never truncates: clear first
            except RadosError:
                pass
        offset = 0
        md5s = []
        for n in want:
            data = StripedObject(
                self.io, part_soid(bucket, key, upload_id, n)).read()
            final.write(data, offset=offset)
            offset += len(data)
            from ..utils.bufferlist import iov_of
            m = hashlib.md5()
            for seg in iov_of(data):
                m.update(seg)
            md5s.append(m.digest())
        etag = hashlib.md5(b"".join(md5s)).hexdigest() + \
            f"-{len(want)}"
        ent = {"size": offset, "etag": etag, "mtime": _http_date(),
               "mtime_ns": time.time_ns()}
        if vid is not None:
            ent["version_id"] = vid
            self._put_version_record(bucket, key, vid, ent)
        self.io.set_omap(index_oid(bucket), {key: denc.dumps(ent)})
        self._bilog(bucket, "put", key, vid)
        self._cleanup_upload(bucket, key, upload_id, parts)
        self._xml(req, 200,
                  "<CompleteMultipartUploadResult>"
                  f"<Bucket>{escape(bucket)}</Bucket>"
                  f"<Key>{escape(key)}</Key>"
                  f"<ETag>&quot;{etag}&quot;</ETag>"
                  "</CompleteMultipartUploadResult>",
                  headers={"x-amz-version-id": vid} if vid else None)

    def _abort_multipart(self, req, bucket: str, key: str,
                         upload_id: str) -> None:
        meta = self._upload_meta(bucket, upload_id)
        if meta is None:
            self._error(req, 404, "NoSuchUpload")
            return
        try:
            parts = {int(k): denc.loads(v) for k, v in
                     self.io.get_omap(parts_oid(bucket,
                                                upload_id)).items()}
        except RadosError:
            parts = {}
        self._cleanup_upload(bucket, meta["key"], upload_id, parts)
        self._reply(req, 204)

    def _cleanup_upload(self, bucket: str, key: str, upload_id: str,
                        parts: dict) -> None:
        for n in parts:
            try:
                StripedObject(self.io, part_soid(bucket, key,
                                                 upload_id, n)).remove()
            except RadosError:
                pass
        try:
            self.io.remove_object(parts_oid(bucket, upload_id))
        except RadosError:
            pass
        try:
            self.io.rm_omap_keys(uploads_oid(bucket), [upload_id])
        except RadosError:
            pass

    def _list_uploads(self, req, bucket: str) -> None:
        try:
            ups = {k: denc.loads(v) for k, v in
                   self.io.get_omap(uploads_oid(bucket)).items()}
        except RadosError:
            ups = {}
        entries = "".join(
            f"<Upload><Key>{escape(m['key'])}</Key>"
            f"<UploadId>{uid}</UploadId>"
            f"<Initiated>{m['started']}</Initiated></Upload>"
            for uid, m in sorted(ups.items()))
        self._xml(req, 200,
                  "<ListMultipartUploadsResult>"
                  f"<Bucket>{escape(bucket)}</Bucket>{entries}"
                  "</ListMultipartUploadsResult>")


def _http_date() -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())


def sign_v2(method: str, path: str, date: str, access: str,
            secret: str) -> str:
    """Client-side helper producing the Authorization header."""
    to_sign = "\n".join([method, "", "", date, path])
    sig = base64.b64encode(hmac.new(
        secret.encode(), to_sign.encode(), hashlib.sha1).digest()
    ).decode()
    return f"AWS {access}:{sig}"
