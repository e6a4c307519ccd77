"""Keyring: entity name -> secret key (auth/KeyRing.{h,cc} analog).

File format mirrors the reference's ini keyring:

    [client.admin]
        key = <base64>
    [osd.0]
        key = <base64>

A "*" entry acts as the cluster-wide shared secret fallback (the
cephx-lite deployment mode: one secret for every daemon/client).
"""

from __future__ import annotations

import base64
import configparser
import os


def generate_key() -> str:
    """Fresh base64 secret (the `ceph-authtool --gen-key` analog)."""
    return base64.b64encode(os.urandom(24)).decode()


class KeyRing:
    def __init__(self):
        self.keys: dict[str, bytes] = {}

    def add(self, entity: str, key_b64: str) -> None:
        self.keys[entity] = base64.b64decode(key_b64)

    def get(self, entity: str) -> bytes | None:
        k = self.keys.get(entity)
        if k is None:
            k = self.keys.get("*")
        return k

    @classmethod
    def from_file(cls, path: str) -> "KeyRing":
        ring = cls()
        parser = configparser.ConfigParser()
        parser.read(path)
        for section in parser.sections():
            key = parser.get(section, "key", fallback=None)
            if key:
                ring.add(section, key.strip())
        return ring

    def save(self, path: str) -> None:
        parser = configparser.ConfigParser()
        for entity, key in self.keys.items():
            parser[entity] = {"key": base64.b64encode(key).decode()}
        with open(path, "w") as f:
            parser.write(f)
