"""MonMap: the monitor roster (mon/MonMap.h analog).

Rank = index in sorted name order; elections prefer the lowest rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import denc
from ..utils.denc import denc_type


@denc_type
@dataclass
class MonMap:
    epoch: int = 1
    fsid: str = ""
    mons: dict[str, tuple] = field(default_factory=dict)   # name -> addr

    def add(self, name: str, addr: tuple) -> None:
        self.mons[name] = tuple(addr)

    def remove(self, name: str) -> None:
        self.mons.pop(name, None)

    def copy(self) -> "MonMap":
        return MonMap(epoch=self.epoch, fsid=self.fsid,
                      mons=dict(self.mons))

    @property
    def size(self) -> int:
        return len(self.mons)

    def ranks(self) -> list[str]:
        return sorted(self.mons)

    def rank_of(self, name: str) -> int:
        return self.ranks().index(name)

    def name_of_rank(self, rank: int) -> str:
        return self.ranks()[rank]

    def addr_of(self, name: str) -> tuple:
        return self.mons[name]

    def quorum_needed(self) -> int:
        return self.size // 2 + 1

    def encode(self) -> bytes:
        return denc.dumps(self)

    @staticmethod
    def decode(b: bytes) -> "MonMap":
        m = denc.loads(b)
        if not isinstance(m, MonMap):
            raise denc.DencError("not a MonMap")
        return m
