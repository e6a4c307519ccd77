"""Auth: cephx-lite session authentication + keyring (auth/ analog)."""

from . import cephx
from .keyring import KeyRing, generate_key

__all__ = ["cephx", "KeyRing", "generate_key"]
