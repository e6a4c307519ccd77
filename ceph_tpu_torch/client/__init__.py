"""Client tier: Objecter + librados-style API (osdc/ + librados/ analog)."""

from .rados import Rados, IoCtx, RadosError
from .ledger import (CephFSDoor, DurabilityLedger, LedgerViolation,
                     RGWDoor, SwiftDoor, TwoZoneLedger)

__all__ = ["Rados", "IoCtx", "RadosError", "DurabilityLedger",
           "LedgerViolation", "CephFSDoor", "RGWDoor", "SwiftDoor",
           "TwoZoneLedger"]
