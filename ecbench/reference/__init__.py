"""The plain NumPy reference of the EC object path.

It imports nothing of the program under test.  `encode_object` is what
an OSD's whole-object EC write must produce from a payload: the shard
files (shard c holds chunk c of every stripe, the tail stripe padded
with zeros) and the per-stripe chunk CRCs in HashInfo order.
`read_object` is what a degraded read must return: the object's bytes,
rebuilt from the surviving shards.
"""

from __future__ import annotations

import numpy as np

from . import crc32c, gf256


class Profile:
    """The parts of an EC profile the reference needs."""

    def __init__(self, technique: str, k: int, m: int, stripe_unit: int):
        self.k, self.m, self.unit = int(k), int(m), int(stripe_unit)
        self.coding = gf256.coding_matrix(technique, self.k, self.m)

    @classmethod
    def of(cls, profile: dict) -> "Profile":
        return cls(profile["technique"], profile["k"], profile["m"],
                   profile["stripe_unit"])

    def stripes(self, nbytes: int) -> tuple[np.ndarray, np.ndarray]:
        """A zeroed buffer for a payload of `nbytes`, and its (S, k, L)
        stripe view: the tail stripe stays zero past the payload."""
        width = self.k * self.unit
        S = max(1, -(-nbytes // width))
        buf = np.zeros(S * width, dtype=np.uint8)
        return buf, buf.reshape(S, self.k, self.unit)


def encode_object(p: Profile, payload) -> tuple[np.ndarray, np.ndarray]:
    """-> (shards (k+m, S*L), stripe CRCs (S, k+m) uint32)."""
    payload = np.frombuffer(payload, dtype=np.uint8)
    buf, stripes = p.stripes(payload.size)
    buf[:payload.size] = payload
    parity = gf256.apply(p.coding, stripes)
    chunks = np.concatenate([stripes, parity], axis=1)     # (S, km, L)
    S, km, L = chunks.shape
    crcs = crc32c.crc_rows(chunks.reshape(S * km, L)).reshape(S, km)
    return chunks.transpose(1, 0, 2).reshape(km, S * L), crcs


def read_object(p: Profile, shards: dict, size: int) -> np.ndarray:
    """The object's first `size` bytes from any k of its shards."""
    present = sorted(shards)[:p.k]
    L = p.unit
    S = len(shards[present[0]]) // L
    have = np.stack([np.frombuffer(shards[c], dtype=np.uint8).reshape(S, L)
                     for c in present], axis=1)
    lost = [c for c in range(p.k) if c not in present]
    data = np.empty((S, p.k, L), dtype=np.uint8)
    for i, c in enumerate(present):
        if c < p.k:
            data[:, c] = have[:, i]
    if lost:
        rebuilt = gf256.apply(gf256.decode_rows(p.coding, lost, present),
                              have)
        for i, c in enumerate(lost):
            data[:, c] = rebuilt[:, i]
    return data.reshape(-1)[:size]
