"""AWS Signature Version 4 for the S3 dialect.

The reference computes v4 signatures in rgw/rgw_auth_s3.{h,cc}
(rgw_create_s3_v4_canonical_request, rgw_calculate_s3_v4_aws_signature,
rgw/rgw_auth_s3.h:24-32): canonical request -> string-to-sign -> HMAC
chain keyed AWS4+secret over date/region/service.  This module is both
the client-side signer (tests use it to produce signed requests) and
the server-side verifier (RGWDaemon rebuilds the canonical request
from what actually arrived and compares digests).

Scope pins match the reference's S3 defaults: single region
("default"), service "s3", header-carried signatures (presigned URLs
are not in scope).
"""

from __future__ import annotations

import hashlib
import hmac
import time
from urllib.parse import quote

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"
REGION = "default"
SERVICE = "s3"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def signing_key(secret: str, date: str, region: str = REGION,
                service: str = SERVICE) -> bytes:
    """The v4 key-derivation chain (rgw_auth_s3.h
    rgw_calculate_s3_v4_aws_signature's inner HMAC ladder)."""
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_query(raw_query: str) -> str:
    """Sorted, strictly-encoded query string.  Operates on the RAW
    query (before any unquoting) so an encoded '&' in a value cannot
    split into extra parameters."""
    if not raw_query:
        return ""
    pairs = []
    for item in raw_query.split("&"):
        if not item:
            continue
        name, _, value = item.partition("=")
        # normalize percent-encoding: decode then re-encode with the
        # v4 unreserved set
        from urllib.parse import unquote_plus
        pairs.append((quote(unquote_plus(name), safe="-_.~"),
                      quote(unquote_plus(value), safe="-_.~")))
    return "&".join(f"{n}={v}" for n, v in sorted(pairs))


def canonical_request(method: str, path: str, raw_query: str,
                      headers: dict, signed_headers: list[str],
                      payload_hash: str) -> str:
    """rgw_create_s3_v4_canonical_request: the 6-line canonical form.
    `headers` maps lowercase name -> value as they appear on the wire;
    `path` is the already-decoded URI path, re-encoded per segment."""
    canon_uri = quote(path, safe="/-_.~") or "/"
    canon_headers = "".join(
        f"{h}:{' '.join(str(headers.get(h, '')).split())}\n"
        for h in signed_headers)
    return "\n".join([
        method, canon_uri, canonical_query(raw_query), canon_headers,
        ";".join(signed_headers), payload_hash])


def string_to_sign(timestamp: str, scope: str, creq: str) -> str:
    return "\n".join([ALGORITHM, timestamp, scope, _sha256_hex(
        creq.encode())])


def sign_v4(method: str, path: str, raw_query: str, headers: dict,
            payload: bytes, access: str, secret: str,
            timestamp: str | None = None,
            region: str = REGION) -> dict:
    """Client-side: return the headers to attach (Authorization,
    x-amz-date, x-amz-content-sha256).  `headers` should already hold
    `host`."""
    timestamp = timestamp or time.strftime("%Y%m%dT%H%M%SZ",
                                           time.gmtime())
    date = timestamp[:8]
    payload_hash = _sha256_hex(payload)
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = timestamp
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(hdrs) | {"x-amz-date", "x-amz-content-sha256"})
    scope = f"{date}/{region}/{SERVICE}/aws4_request"
    creq = canonical_request(method, path, raw_query, hdrs, signed,
                             payload_hash)
    sts = string_to_sign(timestamp, scope, creq)
    sig = hmac.new(signing_key(secret, date, region), sts.encode(),
                   hashlib.sha256).hexdigest()
    return {
        "Authorization": (
            f"{ALGORITHM} Credential={access}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"),
        "x-amz-date": timestamp,
        "x-amz-content-sha256": payload_hash,
    }


def parse_auth_header(header: str) -> dict | None:
    """Split `AWS4-HMAC-SHA256 Credential=..., SignedHeaders=...,
    Signature=...` into its parts; None if malformed."""
    if not header.startswith(ALGORITHM + " "):
        return None
    fields = {}
    for part in header[len(ALGORITHM) + 1:].split(","):
        name, _, value = part.strip().partition("=")
        fields[name] = value
    cred = fields.get("Credential", "")
    access, _, scope = cred.partition("/")
    if not access or not scope or "Signature" not in fields:
        return None
    return {
        "access": access,
        "scope": scope,
        "signed_headers": [h for h in
                           fields.get("SignedHeaders", "").split(";")
                           if h],
        "signature": fields["Signature"],
    }


def verify_v4(method: str, path: str, raw_query: str, headers: dict,
              payload: bytes, access: str, secret: str) -> bool:
    """Server-side: rebuild the canonical request from the request as
    received and compare signatures (and the payload digest, unless
    the client declared UNSIGNED-PAYLOAD)."""
    auth = parse_auth_header(headers.get("authorization", ""))
    if auth is None or auth["access"] != access:
        return False
    scope_parts = auth["scope"].split("/")
    if len(scope_parts) != 4 or scope_parts[3] != "aws4_request" \
            or scope_parts[2] != SERVICE:
        return False
    date, region = scope_parts[0], scope_parts[1]
    timestamp = headers.get("x-amz-date", "")
    if not timestamp.startswith(date):
        return False
    try:
        import calendar
        ts = calendar.timegm(time.strptime(timestamp,
                                           "%Y%m%dT%H%M%SZ"))
    except ValueError:
        return False
    if abs(time.time() - ts) > 900:
        return False          # outside the 15-min grace window: a
        # captured request must not verify forever (RGW_AUTH_GRACE)
    declared = headers.get("x-amz-content-sha256", UNSIGNED)
    if declared != UNSIGNED and declared != _sha256_hex(payload):
        return False          # body does not match its signed digest
    signed = auth["signed_headers"]
    if "host" not in signed or "x-amz-date" not in signed:
        return False          # v4 requires these to be signed
    creq = canonical_request(method, path, raw_query, headers, signed,
                             declared)
    sts = string_to_sign(timestamp, auth["scope"], creq)
    want = hmac.new(signing_key(secret, date, region), sts.encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, auth["signature"])
