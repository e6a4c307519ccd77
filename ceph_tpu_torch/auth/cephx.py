"""cephx-lite: shared-secret session auth + per-message signing.

Semantics follow auth/cephx/CephxProtocol.h (challenge/response proofs
over a shared secret; CephxSessionHandler's per-message signatures,
CephxSessionHandler.cc sign_message/check_message_signature) reduced to
the session layer: both ends prove knowledge of the entity's keyring
secret via HMAC challenges and derive a per-connection session key that
signs every frame.  The ticket-granting (AUTH_SESSION_KEY ->
service-ticket) indirection is deliberately not reproduced — one
keyring secret authenticates the session directly.  auth=none disables
the whole layer (config auth_cluster_required, like the reference's
auth supported knobs).
"""

from __future__ import annotations

import hashlib
import hmac
import os

NONCE_LEN = 16
PROOF_LEN = 32
SIG_LEN = 8


def make_nonce() -> bytes:
    return os.urandom(NONCE_LEN)


def proof(key: bytes, client_nonce: bytes, server_nonce: bytes,
          who: bytes) -> bytes:
    """Challenge-response proof: knowledge of `key` bound to both
    nonces and the prover's role (so a proof cannot be reflected)."""
    return hmac.new(key, b"cephx-proof" + client_nonce + server_nonce
                    + who, hashlib.sha256).digest()


def session_key(key: bytes, client_nonce: bytes,
                server_nonce: bytes) -> bytes:
    return hmac.new(key, b"cephx-session" + client_nonce + server_nonce,
                    hashlib.sha256).digest()


def sign(skey: bytes, frame: bytes) -> bytes:
    """Per-message signature (CephxSessionHandler::sign_message)."""
    return hmac.new(skey, frame, hashlib.sha256).digest()[:SIG_LEN]


def sign_iov(skey: bytes, parts) -> bytes:
    """Signature over a gather-write frame: the HMAC folds each buffer
    in place (label, header, seg table, payload, segments) — same
    digest as sign() over the joined bytes, zero joins."""
    h = hmac.new(skey, digestmod=hashlib.sha256)
    for p in parts:
        h.update(p)
    return h.digest()[:SIG_LEN]


def check(skey: bytes, frame: bytes, sig: bytes) -> bool:
    return hmac.compare_digest(sign(skey, frame), sig)


def check_iov(skey: bytes, parts, sig: bytes) -> bool:
    return hmac.compare_digest(sign_iov(skey, parts), sig)


# ---------------------------------------------------------------------------
# Ticket blobs + rotating service secrets (CephxProtocol.h:143
# CephXTicketBlob / CephXServiceTicketInfo, reduced).
#
# The TGS indirection: a client authenticates to the MON with its own
# keyring secret and asks for a SERVICE ticket — an opaque blob sealed
# under the service class's ROTATING secret (which only the service
# daemons fetch from the mon), carrying the client's identity, an
# expiry stamp and a fresh connection secret.  The service unseals the
# blob with its current (or previous — rotation keeps one back) secret
# and both sides derive per-connection session keys from the carried
# secret, so the service never needs the client's keyring entry and
# rotating the service secret invalidates outstanding tickets on the
# reference's schedule, not on daemon restarts.
#
# Sealing is XOR with a SHA256-CTR keystream + HMAC tag — integrity
# first, matching the framework's frame-signing (not encrypting)
# threat model.
# ---------------------------------------------------------------------------

SECRET_LEN = 32


def make_secret() -> bytes:
    return os.urandom(SECRET_LEN)


def _keystream(secret: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(
            secret + nonce + ctr.to_bytes(4, "big")).digest()
        ctr += 1
    return bytes(out[:n])


def seal(secret: bytes, payload: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    body = bytes(a ^ b for a, b in
                 zip(payload, _keystream(secret, nonce, len(payload))))
    tag = hmac.new(secret, b"cephx-seal" + nonce + body,
                   hashlib.sha256).digest()
    return nonce + tag + body


def unseal(secret: bytes, blob: bytes) -> bytes | None:
    if len(blob) < NONCE_LEN + 32:
        return None
    nonce, tag, body = (blob[:NONCE_LEN], blob[NONCE_LEN:NONCE_LEN + 32],
                        blob[NONCE_LEN + 32:])
    want = hmac.new(secret, b"cephx-seal" + nonce + body,
                    hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        return None
    return bytes(a ^ b for a, b in
                 zip(body, _keystream(secret, nonce, len(body))))
