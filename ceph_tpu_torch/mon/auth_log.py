"""AuthMonitor + LogMonitor: paxos-replicated keyring and cluster log
(mon/AuthMonitor.cc + mon/LogMonitor.cc reduced).

AuthMonitor owns the cluster keyring: `auth add/get-or-create/get/rm/
ls/export` commands mutate it through paxos, so every mon serves the
same keys and a restart loses nothing.  `auth export` emits the
keyring-file format the session layer consumes (auth/keyring.py) —
the `ceph auth get-or-create > keyring` provisioning flow.

LogMonitor is the cluster log: daemons send MLogMsg entries (and the
OSDMonitor logs its own state transitions); batches commit through
paxos and `log last [n]` reads them back, with old versions trimmed.
"""

from __future__ import annotations

from ..utils import denc
from .services import PaxosService


class AuthMonitor(PaxosService):
    name = "authm"

    def __init__(self, mon):
        super().__init__(mon)
        # entity -> {"key": b64 str, "caps": str}
        self.keys: dict[str, dict] = {}
        self.pending_keys: dict[str, dict] | None = None
        self._last_proposed = 0
        self.update_from_paxos()

    # -- paxos plumbing ----------------------------------------------------

    def update_from_paxos(self) -> None:
        v = self.version
        if v <= 0 or v == getattr(self, "_applied_v", 0):
            # a FOREIGN service's commit must not clear our queued
            # pending state (OSDMonitor guards on epoch the same way)
            return
        self._applied_v = v
        blob = self.mon.store.get_version(self.name, v)
        if blob is not None:
            self.keys = denc.loads(blob)
        self.have_pending = False
        self.pending_keys = None

    def create_pending(self) -> None:
        self.pending_keys = {k: dict(m) for k, m in self.keys.items()}
        self.have_pending = True

    def _pending(self) -> dict:
        if not self.have_pending or self.pending_keys is None:
            self.create_pending()
        return self.pending_keys

    def encode_pending(self, txn_ops: list) -> None:
        v = max(self.version, self._last_proposed) + 1
        txn_ops.append(("set", self.name, f"{v:020d}",
                        denc.dumps(self.pending_keys)))
        txn_ops.append(("set", self.name, "last_committed",
                        str(v).encode()))
        # each version is a full (small) snapshot: older ones are dead
        if v > 2:
            txn_ops.append(("rm", self.name, f"{v - 2:020d}", b""))
        self._last_proposed = v

    # -- commands ----------------------------------------------------------

    # -- rotating service secrets + ticket granting ------------------------
    #
    # CephxProtocol.h:143 (CephXTicketBlob) + KeyServer rotating
    # secrets, reduced: per service class the monitor keeps the
    # CURRENT and PREVIOUS rotating secret (so tickets sealed just
    # before a rotation stay redeemable until they expire); `auth
    # get-ticket` seals a fresh connection secret + expiry under the
    # current one; service daemons fetch the rotating pair over their
    # authenticated mon channel and never see client keyring entries.

    _ROT_KEY = "\x00rotating"        # reserved key in the auth blob

    def _rotating(self, pend=None) -> dict:
        src = pend if pend is not None else self.keys
        return src.get(self._ROT_KEY, {})

    def _rotate(self, service: str):
        """Stage a new rotating secret for `service` (keeps one
        previous); returns the new key id."""
        from ..auth import cephx
        import base64
        pend = self._pending()
        rot = dict(self._rotating(pend))
        cur = list(rot.get(service, []))
        new_id = (cur[0]["id"] + 1) if cur else 1
        cur.insert(0, {
            "id": new_id,
            "secret": base64.b64encode(cephx.make_secret()).decode(),
            "created": self.mon.clock.now()})
        rot[service] = cur[:2]
        pend[self._ROT_KEY] = rot
        self.propose_pending()
        return new_id

    def _cmd_get_ticket(self, cmd: dict):
        from ..auth import cephx
        from ..utils import denc as _denc
        import base64
        import os
        service = cmd.get("service", "")
        if not service or not service.isalnum():
            return -22, f"bad service {service!r}", b""
        rot = self._rotating().get(service)
        if not rot:
            # lazy first use: create the service's rotating secret
            # (a write -> rides paxos; the deferred-ack machinery
            # answers the client only after commit)
            self._rotate(service)
            rot = self._rotating(self.pending_keys).get(service)
        secret = base64.b64decode(rot[0]["secret"])
        ttl = float(self.mon.conf.auth_service_ticket_ttl)
        conn_key = os.urandom(32)
        expires = self.mon.clock.now() + ttl
        blob = cephx.seal(secret, _denc.dumps({
            "client": cmd.get("_requester", "client.?"),
            "key": conn_key, "expires": expires,
            "service": service}))
        out = _denc.dumps({"blob": blob, "key": conn_key,
                           "expires": expires, "service": service,
                           "key_id": rot[0]["id"]})
        return 0, f"ticket for {service}", out

    def _cmd_get_rotating(self, cmd: dict):
        from ..utils import denc as _denc
        service = cmd.get("service", "")
        requester = str(cmd.get("_requester", ""))
        # only a daemon of the class (or a mon) may fetch the
        # service's rotating secrets
        if not (requester.startswith(f"{service}.")
                or requester.startswith("mon.")):
            return -13, (f"{requester} may not read {service} "
                         f"rotating keys"), b""      # EACCES
        rot = self._rotating().get(service)
        if not rot:
            self._rotate(service)
            rot = self._rotating(self.pending_keys).get(service)
        return 0, f"{len(rot)} rotating keys", _denc.dumps(rot)

    def dispatch_command(self, cmd: dict):
        prefix = cmd.get("prefix", "")
        if not prefix.startswith("auth "):
            return None
        from ..auth.keyring import generate_key
        entity = cmd.get("entity", "")
        if entity.startswith("\x00"):
            return -22, "bad entity name", b""
        if prefix == "auth rotate":
            service = cmd.get("service", "")
            if not service or not service.isalnum():
                return -22, f"bad service {service!r}", b""
            new_id = self._rotate(service)
            return 0, f"rotated {service} key (id {new_id})", b""
        if prefix == "auth get-ticket":
            return self._cmd_get_ticket(cmd)
        if prefix == "auth get-rotating":
            return self._cmd_get_rotating(cmd)
        if prefix == "auth ls":
            lines = [f"{e} caps={m.get('caps', '')!r}"
                     for e, m in sorted(self.keys.items())
                     if not e.startswith("\x00")]
            return 0, "\n".join(lines), b""
        if prefix == "auth get":
            m = self.keys.get(entity)
            if m is None:
                return -2, f"no such entity {entity!r}", b""
            return 0, self._export_one(entity, m), b""
        if prefix == "auth export":
            text = "".join(self._export_one(e, m) + "\n"
                           for e, m in sorted(self.keys.items())
                           if not e.startswith("\x00"))
            return 0, text, text.encode()
        if prefix in ("auth add", "auth get-or-create"):
            if not entity:
                return -22, "entity required", b""
            if entity in self.keys:
                if prefix == "auth add":
                    return -17, f"{entity} already has a key", b""
                return 0, self._export_one(entity,
                                           self.keys[entity]), b""
            pend = self._pending()
            if entity in pend:
                # a second get-or-create racing the uncommitted
                # proposal must see the SAME key — regenerating would
                # invalidate the first caller's copy on commit
                if prefix == "auth add":
                    return -17, f"{entity} already has a key", b""
                return 0, self._export_one(entity, pend[entity]), b""
            pend[entity] = {"key": cmd.get("key") or generate_key(),
                            "caps": cmd.get("caps", "")}
            self.propose_pending()
            return 0, self._export_one(entity, pend[entity]), b""
        if prefix == "auth rm":
            if entity not in self.keys:
                return -2, f"no such entity {entity!r}", b""
            pend = self._pending()
            pend.pop(entity, None)
            self.propose_pending()
            return 0, f"removed {entity}", b""
        return -22, f"unknown auth command {prefix!r}", b""

    @staticmethod
    def _export_one(entity: str, m: dict) -> str:
        return f"[{entity}]\nkey = {m['key']}\n"


class LogMonitor(PaxosService):
    name = "logm"
    MAX_KEEP = 500                   # in-memory + store retention

    def __init__(self, mon):
        super().__init__(mon)
        self.entries: list[dict] = []
        self.pending_entries: list[dict] = []
        self._applied = 0
        self._last_proposed = 0
        self.update_from_paxos()

    # -- paxos plumbing ----------------------------------------------------

    def update_from_paxos(self) -> None:
        v = self.version
        if self._applied >= v:
            return                   # foreign commit: keep pending
        while self._applied < v:
            self._applied += 1
            blob = self.mon.store.get_version(self.name, self._applied)
            if blob is None:
                continue             # trimmed
            self.entries.extend(denc.loads(blob))
        if len(self.entries) > self.MAX_KEEP:
            del self.entries[: len(self.entries) - self.MAX_KEEP]
        self.have_pending = False

    def create_pending(self) -> None:
        self.have_pending = True

    def encode_pending(self, txn_ops: list) -> None:
        v = max(self.version, self._last_proposed) + 1
        txn_ops.append(("set", self.name, f"{v:020d}",
                        denc.dumps(self.pending_entries)))
        txn_ops.append(("set", self.name, "last_committed",
                        str(v).encode()))
        if v > self.MAX_KEEP:
            txn_ops.append(("rm", self.name,
                            f"{v - self.MAX_KEEP:020d}", b""))
        self.pending_entries = []
        self._last_proposed = v

    # -- entry points ------------------------------------------------------

    def log_entry(self, src: str, level: str,
                  text: str) -> None:
        """Queue one cluster-log entry (leader only; peons forward
        their daemons' MLogMsg traffic to the leader)."""
        self.pending_entries.append({
            "stamp": self.mon.clock.now(), "src": src,
            "level": level, "text": text})
        if not self.have_pending:
            self.create_pending()
        self.propose_pending()

    def handle_log(self, msg) -> None:
        for ent in msg.entries:
            self.pending_entries.append({
                "stamp": ent.get("stamp", self.mon.clock.now()),
                "src": msg.src, "level": ent.get("level", "INF"),
                "text": ent.get("text", "")})
        if self.pending_entries:
            if not self.have_pending:
                self.create_pending()
            self.propose_pending()

    def dispatch_command(self, cmd: dict):
        prefix = cmd.get("prefix", "")
        if prefix == "log last":
            try:
                n = int(cmd.get("num", 20))
            except (TypeError, ValueError):
                return -22, "bad num", b""
            lines = [f"{e['stamp']:.3f} {e['src']} [{e['level']}] "
                     f"{e['text']}" for e in self.entries[-n:]]
            return 0, "\n".join(lines), b""
        if prefix == "log":
            text = cmd.get("text", "")
            if not text:
                return -22, "text required", b""
            self.log_entry(cmd.get("src", "client"), "INF", text)
            return 0, "logged", b""
        return None
