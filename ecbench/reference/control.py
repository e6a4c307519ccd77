"""Controls: the reference in the program's place, each breaking one
guarantee that the configurations state.  A run of a control has to
come out as not correct (`python3 -m ecbench.control`).

  write          every parity chunk is the XOR of the data chunks: the
                 cheaper code that skips the GF(2^8) multiplies, so the
                 parity of the profile's technique is not exact;
  degraded_read  the read skips the decode and serves the lost data
                 chunk from the first parity shard, so the object's
                 bytes are not exact.
"""

from __future__ import annotations

import numpy as np

from . import Profile, crc32c


def encode_xor_parity(p: Profile, payload) -> tuple[np.ndarray, np.ndarray]:
    payload = np.frombuffer(payload, dtype=np.uint8)
    buf, stripes = p.stripes(payload.size)
    buf[:payload.size] = payload
    xor = np.bitwise_xor.reduce(stripes, axis=1)
    chunks = np.concatenate([stripes] + [xor[:, None]] * p.m, axis=1)
    S, km, L = chunks.shape
    crcs = crc32c.crc_rows(chunks.reshape(S * km, L)).reshape(S, km)
    return chunks.transpose(1, 0, 2).reshape(km, S * L), crcs


def read_without_decode(p: Profile, shards: dict, size: int) -> np.ndarray:
    L = p.unit
    S = len(shards[min(shards)]) // L
    data = np.empty((S, p.k, L), dtype=np.uint8)
    for c in range(p.k):
        src = shards[c] if c in shards else shards[p.k]
        data[:, c] = np.frombuffer(src, dtype=np.uint8).reshape(S, L)
    return data.reshape(-1)[:size]
