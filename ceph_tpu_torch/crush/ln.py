"""Fixed-point ln for straw2 (crush_ln semantics).

Uses the exact lookup tables the reference ships in
crush/crush_ln_table.h (vendored as constants in ln_tables.py), NOT
tables regenerated from the defining formulas: the shipped entries
deviate from round-to-nearest in hundreds of places (historic generator
artifact), and bit-exact placement compatibility — a hard requirement
(SURVEY §7 "CRUSH bit-exactness") — demands the shipped values.
"""

from __future__ import annotations

from .ln_tables import LH as _LH, LL as _LL, RH as _RH


def crush_ln(xin: int) -> int:
    """~ 2^44 * (48 + log2(x/0x10000)) for x in [1, 0x10000], fixed point.

    Mirrors crush/mapper.c:248: normalize x to [0x8000, 0x1ffff], split
    into a high part looked up in RH/LH and a low-order correction LL.
    """
    x = (xin + 1) & 0x1FFFF
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - x.bit_length()
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1               # even index: 256, 258, ... 512
    k = (index1 - 256) >> 1
    rh = _RH[k]
    lh = _LH[k]
    xl64 = (x * rh) >> 48
    result = iexpon << 44
    ll = _LL[xl64 & 0xFF]
    result += (lh + ll) >> 4
    return result
