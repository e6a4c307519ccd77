"""CRC32C (Castagnoli) in plain NumPy: the benchmark's reference.

Ceph's convention (`ceph_crc32c`): the seed is the raw initial register,
with no inversion before or after; reflected polynomial 0x82F63B78.  A
HashInfo chunk CRC is the CRC of the chunk with seed 0.

`crc_rows` checks many long rows at once.  Each row is cut into blocks,
every block's CRC is taken byte by byte with all blocks side by side,
and a row's blocks are then folded left to right.  With seed 0 the CRC
is linear over GF(2), so crc(A + B) = advance(crc(A), len(B)) ^ crc(B),
where advance runs a register through len(B) zero bytes; advance is
itself linear in the register and is tabulated per register byte.
"""

from __future__ import annotations

import numpy as np

POLY = 0x82F63B78


def _table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[i] = c
    return t


TABLE = _table()


def crc(seed: int, data) -> int:
    """Byte-at-a-time CRC32C of `data` from the raw register `seed`."""
    c = seed & 0xFFFFFFFF
    for b in bytes(data):
        c = (c >> 8) ^ int(TABLE[(c ^ b) & 0xFF])
    return c


def _advance_tables(nbytes: int) -> np.ndarray:
    """(4, 256) tables: advance(x) = XOR_p T[p][(x >> 8p) & 0xFF]."""
    images = np.array([crc(1 << b, bytes(nbytes)) for b in range(32)],
                      dtype=np.uint32)
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
    out = np.zeros((4, 256), dtype=np.uint32)
    for p in range(4):
        for bit in range(8):
            out[p] ^= np.where(bits[:, bit] == 1, images[8 * p + bit],
                               np.uint32(0)).astype(np.uint32)
    return out


def _advance(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (tables[0][x & 0xFF] ^ tables[1][(x >> 8) & 0xFF]
            ^ tables[2][(x >> 16) & 0xFF] ^ tables[3][x >> 24])


def crc_rows(rows: np.ndarray, block: int = 256) -> np.ndarray:
    """CRC32C (seed 0) of each row of an (N, L) uint8 array -> (N,) uint32."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    N, L = rows.shape
    while L % block:
        block //= 2
    nb = L // block
    cols = rows.reshape(N * nb, block).T.copy()      # (block, N * nb)
    c = np.zeros(N * nb, dtype=np.uint32)
    for j in range(block):
        c = (c >> 8) ^ TABLE[(c ^ cols[j]) & 0xFF]
    c = c.reshape(N, nb)
    adv = _advance_tables(block)
    out = c[:, 0].copy()
    for b in range(1, nb):
        out = _advance(adv, out) ^ c[:, b]
    return out
