"""Reed-Solomon over GF(2^8) in plain NumPy: the benchmark's reference.

Written from the published algorithms, not from the program: the field
is GF(2^8) under x^8 + x^4 + x^3 + x^2 + 1 (0x11D, jerasure's w=8 and
ISA-L's polynomial), and `reed_sol_van` is the systematic Vandermonde
construction (Plank, "A Tutorial on Reed-Solomon Coding", with the 2003
correction): the (k+m) x k extended Vandermonde matrix is
column-reduced until its top k x k block is the identity, then its
columns are scaled so that the first coding row is all ones.

This is the on-disk format the repository's encode corpus pins.  It
stops there: it does not also scale coding rows 2.. so that their first
column is one, a step jerasure's distribution matrix is recalled to
take (see PERF.md, open questions).
"""

from __future__ import annotations

import itertools

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


EXP, LOG = _tables()


def _mul_table() -> np.ndarray:
    a = np.arange(256)
    t = EXP[(LOG[a][:, None] + LOG[a][None, :]) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


MUL = _mul_table()          # MUL[a, b] = a * b in GF(2^8)


def mul(a: int, b: int) -> int:
    return int(MUL[a, b])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[(255 - LOG[a]) % 255])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8)."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            out[i] ^= MUL[a[i, j]][b[j]]
    return out


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises on a singular matrix."""
    n = a.shape[0]
    aug = np.concatenate([np.array(a, dtype=np.uint8),
                          np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        rows = [r for r in range(col, n) if aug[r, col]]
        if not rows:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        aug[[col, rows[0]]] = aug[[rows[0], col]]
        aug[col] = MUL[inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[aug[r, col]][aug[col]]
    return aug[:, n:]


def reed_sol_van(k: int, m: int) -> np.ndarray:
    """The m x k coding rows of reed_sol_van at w=8 in the repository's
    on-disk format (see the module's docstring)."""
    rows = k + m
    v = np.zeros((rows, k), dtype=np.uint8)
    v[0, 0] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(k):
            v[i, j] = acc
            acc = mul(acc, i)
    v[rows - 1, k - 1] = 1
    for i in range(k):
        if v[i, i] == 0:
            j = next(j for j in range(i + 1, k) if v[i, j])
            v[:, [i, j]] = v[:, [j, i]]
        v[:, i] = MUL[inv(int(v[i, i]))][v[:, i]]
        for j in range(k):
            if j != i and v[i, j]:
                v[:, j] ^= MUL[v[i, j]][v[:, i]]
    for j in range(k):
        d = int(v[k, j])
        if d != 1:
            v[:, j] = MUL[inv(d)][v[:, j]]
    return v[k:].copy()


TECHNIQUES = {"reed_sol_van": reed_sol_van}


def coding_matrix(technique: str, k: int, m: int) -> np.ndarray:
    return TECHNIQUES[technique](k, m)


def apply(matrix: np.ndarray, chunks: np.ndarray) -> np.ndarray:
    """(S, c, L) chunks -> (S, r, L): out[:, i] = XOR_j matrix[i, j] * chunks[:, j]."""
    S, c, L = chunks.shape
    out = np.zeros((S, matrix.shape[0], L), dtype=np.uint8)
    for i in range(matrix.shape[0]):
        for j in range(c):
            if matrix[i, j]:
                out[:, i] ^= MUL[matrix[i, j]][chunks[:, j]]
    return out


def decode_rows(coding: np.ndarray, want: list[int],
                present: list[int]) -> np.ndarray:
    """Rows that rebuild the chunks `want` from the k chunks `present`."""
    k = coding.shape[1]
    gen = np.concatenate([np.eye(k, dtype=np.uint8), coding])
    data_from_present = mat_inv(gen[list(present)])
    return matmul(gen[list(want)], data_from_present)


def is_mds(coding: np.ndarray) -> bool:
    """Every k of the k+m generator rows are independent."""
    k = coding.shape[1]
    gen = np.concatenate([np.eye(k, dtype=np.uint8), coding])
    for rows in itertools.combinations(range(gen.shape[0]), k):
        try:
            mat_inv(gen[list(rows)])
        except np.linalg.LinAlgError:
            return False
    return True
