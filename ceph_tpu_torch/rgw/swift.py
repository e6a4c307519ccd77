"""Swift REST dialect (rgw/rgw_rest_swift.cc reduced): the same
buckets/objects the S3 surface serves, spoken as Swift v1 — matching
radosgw, where S3 buckets and Swift containers are one namespace.

Surface:
    GET  /auth/v1.0                  TempAuth: X-Auth-User/X-Auth-Key
                                     -> X-Auth-Token + X-Storage-Url
    GET  /v1/AUTH_<acct>             list containers (text or ?format=json)
    PUT  /v1/AUTH_<acct>/<cont>      create container (201)
    DELETE /v1/AUTH_<acct>/<cont>    delete container (204/409)
    GET  /v1/AUTH_<acct>/<cont>      list objects (?prefix=&marker=&format=)
    PUT  /v1/AUTH_<acct>/<cont>/<obj>   upload (201 + ETag)
    GET|HEAD /v1/.../<obj>           download / stat
    DELETE /v1/.../<obj>             remove (204)

The token is stateless TempAuth with an embedded mint timestamp:
"<ts>_<HMAC(secret, access:ts)>".  Possession of the account
credentials mints it, every /v1 request must carry it when the gateway
has auth enabled, and dispatch() enforces a validity window (mirroring
the v4 15-minute request-skew grace) — a leaked token expires instead
of being forever as good as the credentials themselves.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time

from ..client.striper import StripedObject
from . import ver_soid

TOKEN_TTL = 900.0        # seconds a minted token stays valid
TOKEN_SKEW = 60.0        # tolerated clock skew for ts-in-the-future


def mint_token(access: str, secret: str, now: float | None = None) -> str:
    ts = int(time.time() if now is None else now)
    sig = hmac.new(secret.encode(), f"swift:{access}:{ts}".encode(),
                   hashlib.sha256).hexdigest()
    return f"{ts}_{sig}"


def check_token(access: str, secret: str, token: str,
                now: float | None = None) -> bool:
    """Valid signature AND inside the validity window."""
    ts_s, _, sig = token.partition("_")
    if not sig or not ts_s.isdigit():
        return False
    ts = int(ts_s)
    now = time.time() if now is None else now
    if not (ts - TOKEN_SKEW <= now <= ts + TOKEN_TTL):
        return False
    want = hmac.new(secret.encode(), f"swift:{access}:{ts}".encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(sig, want)


def handles(path: str) -> bool:
    return path == "/auth/v1.0" or path.startswith("/v1/") \
        or path == "/v1"


def dispatch(gw, req, method: str, path: str, query: dict,
             body: bytes) -> None:
    """Route a Swift-dialect request against the gateway's store."""
    if path == "/auth/v1.0":
        _auth(gw, req)
        return
    if gw.access_key:
        token = req.headers.get("X-Auth-Token", "")
        if not check_token(gw.access_key, gw.secret_key, token):
            gw._reply(req, 401, b"Unauthorized")
            return
    parts = [p for p in path.split("/") if p][1:]   # drop "v1"
    if parts and parts[0].startswith("AUTH_"):
        parts = parts[1:]
    if not parts:
        _account(gw, req, method, query)
    elif len(parts) == 1:
        _container(gw, req, method, parts[0], query)
    else:
        _object(gw, req, method, parts[0], "/".join(parts[1:]), body)


def _auth(gw, req) -> None:
    user = req.headers.get("X-Auth-User", "")
    key = req.headers.get("X-Auth-Key", "")
    if gw.access_key and not (
            user.split(":")[0] == gw.access_key
            and hmac.compare_digest(key, gw.secret_key)):
        gw._reply(req, 401, b"Unauthorized")
        return
    host = req.headers.get("Host", "127.0.0.1")
    gw._reply(req, 200, b"", {
        "X-Auth-Token": mint_token(gw.access_key, gw.secret_key),
        "X-Storage-Url": f"http://{host}/v1/AUTH_"
                         f"{gw.access_key or 'anon'}",
    })


def _account(gw, req, method: str, query: dict) -> None:
    if method not in ("GET", "HEAD"):
        gw._reply(req, 405, b"")
        return
    names = sorted(gw._buckets())
    if query.get("format", [""])[0] == "json":
        out = json.dumps([{"name": n} for n in names]).encode()
        gw._reply(req, 200, out,
                  {"Content-Type": "application/json"})
    else:
        gw._reply(req, 200,
                  ("".join(f"{n}\n" for n in names)).encode(),
                  {"Content-Type": "text/plain"})


def _container(gw, req, method: str, cont: str, query: dict) -> None:
    if method == "PUT":
        if gw._bucket_exists(cont):
            gw._reply(req, 202, b"")      # Swift: re-PUT is accepted
            return
        gw._create_bucket(cont)
        gw._reply(req, 201, b"")
    elif method == "DELETE":
        if not gw._bucket_exists(cont):
            gw._reply(req, 404, b"")
            return
        if not gw._index_empty(cont):
            # includes delete-marker entries: a versioned container
            # must be purged through the S3 version surface first
            # (Swift exposes no version-purge op) — a marker still
            # guards hidden version data
            gw._reply(req, 409, b"")
            return
        gw._remove_bucket(cont)
        gw._reply(req, 204, b"")
    elif method in ("GET", "HEAD"):
        if not gw._bucket_exists(cont):
            gw._reply(req, 404, b"")
            return
        prefix = query.get("prefix", [""])[0]
        marker = query.get("marker", [""])[0]
        page = gw._index_page(cont, marker, prefix, 10000)
        entries = [(k, v) for k, v in sorted(page.items())
                   if not v.get("delete_marker")]
        if query.get("format", [""])[0] == "json":
            out = json.dumps([
                {"name": k, "bytes": v.get("size", 0),
                 "hash": v.get("etag", ""),
                 "last_modified": v.get("mtime", "")}
                for k, v in entries]).encode()
            gw._reply(req, 200, out,
                      {"Content-Type": "application/json"})
        else:
            gw._reply(req, 200,
                      ("".join(f"{k}\n" for k, _v in
                               entries)).encode(),
                      {"Content-Type": "text/plain"})
    else:
        gw._reply(req, 405, b"")


def _object(gw, req, method: str, cont: str, key: str,
            body: bytes) -> None:
    if not gw._bucket_exists(cont):
        gw._reply(req, 404, b"")
        return
    if method == "PUT":
        # same store path as an S3 put on an unversioned bucket
        meta = gw._bucket_meta(cont) or {}
        gw._put_object(req, cont, key, body,
                       meta.get("versioning", ""),
                       swift_status=201)
    elif method in ("GET", "HEAD"):
        ent = gw._index_entry(cont, key)
        if ent is None or ent.get("delete_marker"):
            gw._reply(req, 404, b"")
            return
        vid = ent.get("version_id", "null")
        data = b""
        if method == "GET":
            data = StripedObject(gw.io,
                                 ver_soid(cont, key, vid)).read()
        gw._reply(req, 200, data, {
            "ETag": ent.get("etag", ""),
            "Last-Modified": ent.get("mtime", ""),
            "Content-Type": "application/octet-stream",
            **({"Content-Length": str(ent.get("size", 0))}
               if method == "HEAD" else {}),
        })
    elif method == "DELETE":
        if gw._index_entry(cont, key) is None:
            gw._reply(req, 404, b"")
            return
        meta = gw._bucket_meta(cont) or {}
        # shares the S3 delete path: versioned containers get delete
        # markers, unversioned ones remove outright; bilog either way
        gw._delete_object(req, cont, key, None,
                          meta.get("versioning", ""))
    else:
        gw._reply(req, 405, b"")
