"""rjenkins1 32-bit hash, bit-exact with the reference's crush/hash.c.

Placement stability across daemons, versions and the C++ native core
requires these to be bit-identical; tests pin known vectors.  The mixing
function is Robert Jenkins' public-domain 96-bit mix
(burtleburtle.net/bob/hash/evahash.html), seeded as in crush/hash.c:24.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
SEED = 1315423911


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b - c) & M32; a ^= c >> 13
    b = (b - c - a) & M32; b ^= (a << 8) & M32
    c = (c - a - b) & M32; c ^= b >> 13
    a = (a - b - c) & M32; a ^= c >> 12
    b = (b - c - a) & M32; b ^= (a << 16) & M32
    c = (c - a - b) & M32; c ^= b >> 5
    a = (a - b - c) & M32; a ^= c >> 3
    b = (b - c - a) & M32; b ^= (a << 10) & M32
    c = (c - a - b) & M32; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= M32
    h = (SEED ^ a) & M32
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a2, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= M32; b &= M32
    h = (SEED ^ a ^ b) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= M32; b &= M32; c &= M32
    h = (SEED ^ a ^ b ^ c) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32
    h = (SEED ^ a ^ b ^ c ^ d) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def rjenkins_hash(data: bytes) -> int:
    """Whole-buffer rjenkins (ceph_str_hash_rjenkins semantics): used for
    object-name -> placement seed hashing."""
    a, b = 0x9E3779B9, 0x9E3779B9
    c = 0
    i, length = 0, len(data)
    while length - i >= 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M32
        a, b, c = _mix(a, b, c)
        i += 12
    rest = data[i:]
    c = (c + length) & M32
    pad = rest + b"\x00" * (12 - len(rest))
    a = (a + int.from_bytes(pad[0:4], "little")) & M32
    b = (b + int.from_bytes(pad[4:8], "little")) & M32
    # the final 4 bytes shift into the high 24 bits of c (length sits low)
    c = (c + (int.from_bytes(pad[8:12], "little") << 8)) & M32
    a, b, c = _mix(a, b, c)
    return c
