"""SHEC plugin: Shingled Erasure Code (k data, m parity, c recoverable).

Matrix construction mirrors the reference exactly
(src/erasure-code/shec/ErasureCodeShec.cc:476
shec_reedsolomon_coding_matrix): start from the jerasure reed_sol_van
coding matrix, then zero a wrapping window of each parity row so parity
rr covers only ~c*k/m consecutive data chunks ("shingles"); the
`multiple` technique (default, :490-521) splits m into (m1, c1)/(m2, c2)
sub-shingles picked by the recovery-efficiency metric r_e1 (:435).

Unlike MDS codes, recovery may need FEWER than k chunks (local repair)
or may fail even with >= k available; minimum_to_decode is a solvability
search over parity subsets (the analog of shec_make_decoding_matrix's
exhaustive search, :546), and decode solves the sparse GF(2^8) system.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..ops import gf
from .interface import ErasureCode, ErasureCodeError
from .registry import ErasureCodePlugin

SINGLE = "single"
MULTIPLE = "multiple"


def _shingle_windows(k: int, m1: int, c1: int, m2: int, c2: int):
    """Per-parity-row zeroed column sets, replicating the reference loops."""
    zero: list[set[int]] = []
    for rr in range(m1):
        cols = set()
        end = ((rr * k) // m1) % k
        cc = (((rr + c1) * k) // m1) % k
        while cc != end:
            cols.add(cc)
            cc = (cc + 1) % k
        zero.append(cols)
    for rr in range(m2):
        cols = set()
        end = ((rr * k) // m2) % k
        cc = (((rr + c2) * k) // m2) % k
        while cc != end:
            cols.add(cc)
            cc = (cc + 1) % k
        zero.append(cols)
    return zero


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10 ** 8] * k
    r_e1 = 0.0
    for rr in range(m1):
        start = ((rr * k) // m1) % k
        end = (((rr + c1) * k) // m1) % k
        cc, first = start, True
        while first or cc != end:
            first = False
            r_eff_k[cc] = min(r_eff_k[cc],
                              ((rr + c1) * k) // m1 - (rr * k) // m1)
            cc = (cc + 1) % k
        r_e1 += ((rr + c1) * k) // m1 - (rr * k) // m1
    for rr in range(m2):
        start = ((rr * k) // m2) % k
        end = (((rr + c2) * k) // m2) % k
        cc, first = start, True
        while first or cc != end:
            first = False
            r_eff_k[cc] = min(r_eff_k[cc],
                              ((rr + c2) * k) // m2 - (rr * k) // m2)
            cc = (cc + 1) % k
        r_e1 += ((rr + c2) * k) // m2 - (rr * k) // m2
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_matrix(k: int, m: int, c: int, technique: str) -> np.ndarray:
    """(m x k) shingled coding matrix."""
    if technique == SINGLE:
        m1, c1, m2, c2 = 0, 0, m, c
    else:
        best = None
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r = _recovery_efficiency1(k, m1, m2, c1, c2)
                if best is None or r < best[0] - 1e-12:
                    best = (r, c1, m1)
        if best is None:
            raise ErasureCodeError(f"no valid shec split for k={k} m={m} c={c}")
        _, c1, m1 = best
        m2, c2 = m - m1, c - c1
    mtx = gf.reed_sol_van_matrix(k, m).copy()
    for rr, cols in enumerate(_shingle_windows(k, m1, c1, m2, c2)):
        for cc in cols:
            mtx[rr, cc] = 0
    return mtx


class ErasureCodeShec(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 3
    DEFAULT_C = 2

    def __init__(self, technique: str = MULTIPLE, backend=None):
        from .matrix_codec import TorchBackend
        self.technique = technique
        self.c = self.DEFAULT_C
        self.coding_matrix: np.ndarray | None = None
        self._plan_cache: dict = {}
        # region math rides the measured host/device router like the
        # matrix plugins (the reference shec links the jerasure SIMD
        # kernels; here the shingle matrix batches onto the device)
        self.backend = backend or TorchBackend()

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = self.profile_int(profile, "k", self.DEFAULT_K)
        self.m = self.profile_int(profile, "m", self.DEFAULT_M)
        self.c = self.profile_int(profile, "c", self.DEFAULT_C)
        w = self.profile_int(profile, "w", 8)
        if w != 8:
            raise ErasureCodeError("only w=8 supported")
        if not (0 < self.c <= self.m <= self.k):
            raise ErasureCodeError(
                f"require 0 < c <= m <= k, got k={self.k} m={self.m} c={self.c}")
        self.coding_matrix = shec_matrix(self.k, self.m, self.c,
                                         self.technique)
        self._plan_cache.clear()

    # -- planning: solvability search over parity subsets ------------------

    def _support(self, parity: int) -> set[int]:
        return {j for j in range(self.k) if self.coding_matrix[parity, j]}

    def _plan(self, want: frozenset, avail: frozenset):
        """Return (minimum chunk set, parities used, unknown data chunks).

        Enumerates parity subsets by increasing size and picks the
        fetch-minimal solvable plan (the reference's exhaustive
        decoding-matrix search, ErasureCodeShec.cc:546).
        """
        key = (want, avail)
        if key in self._plan_cache:
            return self._plan_cache[key]
        want_data = {i for i in want if i < self.k}
        want_parity = {i for i in want if i >= self.k}
        # data needed as direct reads or parity-rebuild inputs
        base_need = set(want_data)
        for p in want_parity:
            if p not in avail:
                base_need |= self._support(p - self.k)
        avail_parities = sorted(i - self.k for i in avail if i >= self.k)
        best = None
        for mask in range(1 << len(avail_parities)):
            ps = [avail_parities[i]
                  for i in range(len(avail_parities)) if mask >> i & 1]
            need = set(base_need)
            for p in ps:
                need |= self._support(p)
            unknowns = sorted(d for d in need if d not in avail)
            if len(unknowns) > len(ps):
                continue
            if unknowns:
                sub = self.coding_matrix[np.asarray(ps)][:, unknowns]
                if _gf_rank(sub) < len(unknowns):
                    continue
            elif ps:
                continue  # no unknowns -> no parities needed
            fetch = {d for d in need if d in avail}
            fetch |= {p + self.k for p in ps}
            fetch |= {p for p in want_parity if p in avail}
            plan = (fetch, tuple(ps), tuple(unknowns), frozenset(need))
            if best is None or len(fetch) < len(best[0]):
                best = plan
        if best is None:
            raise ErasureCodeError(
                f"cannot decode {sorted(want)} from {sorted(avail)}")
        if len(self._plan_cache) > 256:
            self._plan_cache.clear()
        self._plan_cache[key] = best
        return best

    def minimum_to_decode(self, want_to_read, available) -> list[int]:
        want = frozenset(int(i) for i in want_to_read)
        avail = frozenset(int(i) for i in available)
        if want <= avail:
            return sorted(want)
        fetch, _, _, _ = self._plan(want, avail)
        return sorted(fetch)

    # -- device shapes (decode solves on the host) --------------------------

    def device_backend(self):
        from .matrix_codec import TorchBackend
        be = self.backend
        return be if isinstance(be, TorchBackend) else None

    def stripe_encode_shapes(self, unit: int) -> list:
        be = self.device_backend()
        if be is None:
            return []
        return be.sync_shapes("bytes", self.coding_matrix, (),
                              (self.k, unit))

    # -- encode / decode ---------------------------------------------------

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        return self.backend.apply_bytes(
            self.coding_matrix, np.asarray(data_chunks, dtype=np.uint8))

    def decode_chunks(self, want_to_read, chunks) -> dict[int, np.ndarray]:
        have = {int(i): np.asarray(b, dtype=np.uint8)
                for i, b in chunks.items()}
        want = frozenset(int(i) for i in want_to_read)
        missing = want - have.keys()
        out = {i: have[i] for i in want if i in have}
        if not missing:
            return out
        _, ps, unknowns, _need = self._plan(frozenset(missing),
                                            frozenset(have.keys()))
        L = len(next(iter(have.values())))
        data = {d: have[d] for d in range(self.k) if d in have}
        if unknowns:
            # rhs_p = parity_p XOR sum over known support of M[p,d]*d
            rows = []
            rhs = []
            tbl = gf.mul_table()
            for p in ps:
                acc = have[p + self.k].copy()
                for d in self._support(p):
                    if d not in unknowns:
                        acc ^= tbl[self.coding_matrix[p, d]][data[d]]
                rows.append(self.coding_matrix[p][list(unknowns)])
                rhs.append(acc)
            C = np.stack(rows).astype(np.uint8)
            R = np.stack(rhs)
            solved = _gf_solve(C, R)
            for idx, d in enumerate(unknowns):
                data[d] = solved[idx]
        for i in sorted(missing):
            if i < self.k:
                out[i] = data[i]
            else:
                p = i - self.k
                acc = np.zeros(L, dtype=np.uint8)
                tbl = gf.mul_table()
                for d in self._support(p):
                    acc ^= tbl[self.coding_matrix[p, d]][data[d]]
                out[i] = acc
        return out


def _gf_rank(mat: np.ndarray) -> int:
    a = np.array(mat, dtype=np.uint8)
    rank = 0
    rows, cols = a.shape
    for col in range(cols):
        piv = None
        for r in range(rank, rows):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            continue
        a[[rank, piv]] = a[[piv, rank]]
        a[rank] = gf.gf_mul(a[rank], gf.gf_inv(a[rank, col]))
        for r in range(rows):
            if r != rank and a[r, col]:
                a[r] ^= gf.gf_mul(a[r, col], a[rank])
        rank += 1
    return rank


def _gf_solve(C: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Solve C x = R over GF(2^8); C (p x u) with rank u, R (p x L)."""
    a = np.array(C, dtype=np.uint8)
    r = np.array(R, dtype=np.uint8)
    p, u = a.shape
    row = 0
    for col in range(u):
        piv = None
        for rr in range(row, p):
            if a[rr, col]:
                piv = rr
                break
        if piv is None:
            raise ErasureCodeError("singular shec system")
        a[[row, piv]] = a[[piv, row]]
        r[[row, piv]] = r[[piv, row]]
        inv = gf.gf_inv(a[row, col])
        a[row] = gf.gf_mul(a[row], inv)
        r[row] = gf.mul_table()[inv][r[row]]
        for rr in range(p):
            if rr != row and a[rr, col]:
                f = a[rr, col]
                a[rr] ^= gf.gf_mul(f, a[row])
                r[rr] ^= gf.mul_table()[f][r[row]]
        row += 1
    return r[:u]


class ErasureCodeShecPlugin(ErasureCodePlugin):
    def factory(self, profile):
        technique = profile.get("technique", MULTIPLE)
        if technique not in (SINGLE, MULTIPLE):
            raise ErasureCodeError(
                f"shec technique must be single or multiple, got {technique!r}")
        from .plugin_jerasure import backend_from_profile
        return ErasureCodeShec(technique,
                               backend=backend_from_profile(profile))


def __erasure_code_init__(registry, name):
    registry.add(name, ErasureCodeShecPlugin())
