"""Hand-written CUDA kernels for the erasure-code path, and their wrappers.

Counterpart of ``ceph_tpu/ops/pallas_ec.py``:

  * ``gf_transform`` / ``make_encode_fn`` launch ``csrc/gf_encode.cu``
    (replaces ``_encode_kernel``): GF(2^8) matrix x chunks, the encode
    with the coding matrix and the rebuild decode with
    ``gf.decode_matrix`` rows;
  * ``gf_encode_segment_crcs`` launches its fused mode: the same
    product, plus the 4 KiB segment CRCs of the data and parity rows,
    with each data byte read once;
  * ``crc32c_segments`` and ``crc32c_chain`` launch the two passes of
    ``csrc/crc32c.cu`` (together they replace ``_crc_kernel``): segment
    CRCs of rows, and row CRCs from segment CRCs; ``crc32c_rows`` /
    ``make_crc_fn`` run both, CRC32C (seed 0) per row;
  * ``make_encode_crc_fn`` is the fused pass: ``gf_encode_segment_crcs``
    then ``crc32c_chain`` into one (B, k+m) array, on one stream with no
    host sync and no concatenation copy;
  * ``make_mesh_encode_crc_fn`` / ``make_mesh_crc_fn`` split one batch's
    chunk length across a dp x ls plane of cards (the reference's
    ``shard_map`` functions in ``ec_kernels``): each member runs the
    kernels above on its slice on its own stream, and the partial CRCs
    combine on the first member.

They keep ``pallas_ec``'s call contract without its TPU limits (any L,
no tile sizes).  Each wrapper checks device, dtype, shape and
contiguity.  A CPU tensor runs the plain PyTorch version from
``ops/ec_kernels.py``; a CUDA tensor launches the kernel or raises.

The kernels are built at first use with nvcc for sm_90a, one shared
library with a plain C interface per source (all sources compile in
parallel), into ``ceph_tpu_torch/_build/`` under a name keyed by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, and
bound with ctypes.  ``launches`` counts the launches of each kernel,
one key per kernel entry point, so a run can show which kernels its
path went through.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from . import crc32c as crc_mod
from . import ec_kernels, gf
from .ec_kernels import DEFAULT_COMPUTE, batched, host_results

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = {"gf_encode": "gf_encode.cu", "crc32c": "crc32c.cu"}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "gf_encode": {"ceph_gf_encode": [_P, _P, _P, _I, _I, _I, _I64, _P],
                  "ceph_gf_encode_crc": [_P, _P, _P, _I, _I, _I, _I64, _P,
                                         _P, _P]},
    "crc32c": {"ceph_crc32c_segments": [_P, _I64, _I64, _P, _P, _P],
               "ceph_crc32c_chain": [_P, _I64, _I, _P, _I, _I, _I, _P,
                                     _P],
               "ceph_copy_2d": [_P, _I64, _P, _I64, _I64, _I64, _P]},
}

# launches per kernel entry point: gf_encode.cu's plain and fused modes,
# crc32c.cu's segment and chain passes.  The fused pass is
# gf_encode_crc + crc32c_chain and has no count of its own.  Pipeline
# lanes launch from their own threads: every bump and reset takes
# _launch_lock.
launches = {"gf_encode": 0, "gf_encode_crc": 0, "crc32c_segments": 0,
            "crc32c_chain": 0}
_launch_lock = threading.Lock()

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()

CRC_SEG = 4096              # bytes per segment, csrc/crc_seg.cuh kSeg
CRC_BLOCK = 128             # bytes a lane group loads, kBlock
CRC_STRIDE = CRC_SEG + 16   # staged bytes per segment, kStride
CRC_COLS = 8                # segments per tensor-core fold, kCols
CRC_WARPS = 8               # warps splitting a segment, 512 bytes each
CRC_CHAIN_LEVELS = 20       # adv_4096 * 2^e, kChainLevels
CRC_RANGE = CRC_SEG // CRC_WARPS    # bytes folded by one warp, kRange
CRC_SLICES = CRC_RANGE * 8 // 256   # K-slices of a range, kSlices
CRC_FRAG_WORDS = 2 * CRC_SLICES * 32 * 4
CRC_SMEM_WORDS = CRC_FRAG_WORDS + (CRC_WARPS - 1) * 128   # kSmemWords
CRC_MAX_SEGMENTS = 32 << (CRC_CHAIN_LEVELS - 5)    # chain pass limit
GF_TAB_WORDS = 8            # table words per (row, column), kTabWords
GF_SMEM_MAX = 232448        # shared memory a Hopper block may opt into


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def launch_counts() -> dict[str, int]:
    """A consistent snapshot of `launches`."""
    with _launch_lock:
        return dict(launches)


def _count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, str]:
    """Compile every missing kernel library, one nvcc per source, all
    started together.  Returns nvcc's diagnostics per compiled source;
    raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names or SOURCES:
        so = library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: {logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn_name, argtypes in _ARGTYPES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_u8(t: torch.Tensor, ndim: int, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
        raise TypeError(f"{what}: want a uint8 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if t.ndim != ndim:
        raise ValueError(f"{what}: want {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.shape[-1] == 0:
        raise ValueError(f"{what}: chunk length must be at least 1")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Kernel parameters built on the host, cached per device
# ---------------------------------------------------------------------------


def gf_params(matrix: np.ndarray) -> np.ndarray:
    """gf_encode.cu's byte-permute product tables, (r, c, 8) uint32: for
    coefficient a = M[i][j], words 0-1 hold the bytes a*v, words 2-3 the
    bytes a*(v << 3) (v < 8), word 4 the bytes a*(v << 6) (v < 4)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    mul = gf.mul_table()[matrix]                     # (r, c, 256)
    v = np.arange(8)
    tab = np.zeros((r, c, 4 * GF_TAB_WORDS), dtype=np.uint8)
    tab[..., 0:8] = mul[..., v]
    tab[..., 8:16] = mul[..., v << 3]
    tab[..., 16:20] = mul[..., v[:4] << 6]
    return tab.view("<u4")


def gf_layout(r: int, c: int, fused: bool = False) -> int:
    """Shared-memory bytes of a gf_encode.cu block for an (r, c) matrix:
    the product tables; in the fused mode also the CRC fold's tables, its
    range CRCs and the r + c staged segments.  Raises ValueError when
    they do not fit."""
    smem = r * c * 4 * GF_TAB_WORDS
    if fused:
        parts = -(-(c + r) // CRC_COLS) * CRC_WARPS * CRC_COLS
        smem += 4 * (CRC_SMEM_WORDS + parts) + (r + c) * CRC_STRIDE
    if smem > GF_SMEM_MAX:
        raise ValueError(f"gf_encode: matrix {r}x{c} exceeds the kernel's "
                         f"shared memory ({smem} > {GF_SMEM_MAX} bytes)")
    return smem


def _columns(mat: np.ndarray) -> np.ndarray:
    """32x32 GF(2) matrix (out = M @ bits) -> 32 uint32 column words."""
    weights = (1 << np.arange(32, dtype=np.uint64))
    return (mat.astype(np.uint64) * weights[:, None]).sum(0).astype(
        np.uint32)


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """32x32 GF(2) matrix -> (8, 16) uint32: N[i, v] = M @ bits(v << 4i),
    so M @ bits(x) = XOR_i N[i, (x >> 4i) & 15]."""
    cols = _columns(mat)
    v = np.arange(16)
    out = np.zeros((8, 16), dtype=np.uint32)
    for i in range(8):
        for b in range(4):
            out[i] ^= np.where((v >> b) & 1, cols[4 * i + b], 0).astype(
                np.uint32)
    return out


def message_bits(nbytes: int) -> np.ndarray:
    """(32, 8 nbytes) 0/1: column 8p + b is the CRC (seed 0) of a message
    of `nbytes` bytes holding only bit b of byte p -- crc32c's
    message_matrix, built from the end of the message backwards with one
    byte step per position."""
    step = crc_mod.advance_matrix(1).astype(np.int64)
    cur = np.stack([crc_mod._u32_to_bits(crc_mod.crc32c_sw(0, bytes([1 << b])))
                    for b in range(8)], axis=1).astype(np.int64)   # (32, 8)
    out = np.zeros((32, 8 * nbytes), dtype=np.uint8)
    for p in range(nbytes - 1, -1, -1):
        out[:, 8 * p:8 * p + 8] = cur
        cur = (step @ cur) % 2
    return out


def crc_mma_fragments() -> np.ndarray:
    """The A fragments of csrc/crc_seg.cuh's tensor-core fold, (2, 16, 32,
    4) uint32 [row tile, K-slice, lane, register]: the bits of the 512-byte
    message matrix in the mma.m16n8k256 .b1 layout, paired with the bytes
    each lane loads.  Register j of lane (g, t) for tile T and slice
    s = 4k + s' holds CRC bit 16T + g (+8 for j = 1, 3) against the 32
    message bits of the word lane t loads as b0 (j = 0, 1) or b1 (j = 2,
    3): bytes 128k + 32t + 8s' (+4 for b1) onwards."""
    M = message_bits(CRC_RANGE).astype(np.uint64)           # (32, 4096)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    out = np.zeros((2, CRC_SLICES, 32, 4), dtype=np.uint32)
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for tile in range(2):
        for s in range(CRC_SLICES):
            k, s1 = divmod(s, 4)
            for j in range(4):
                rows = 16 * tile + g + (8 if j in (1, 3) else 0)
                o = CRC_BLOCK * k + 32 * t + 8 * s1 + (4 if j >= 2 else 0)
                cols = 8 * o[:, None] + np.arange(32)
                out[tile, s, :, j] = (M[rows[:, None], cols]
                                      * weights).sum(1).astype(np.uint32)
    return out


def crc_tables() -> np.ndarray:
    """The CRC table block of csrc/crc_seg.cuh: the tensor-core fold's A
    fragments, the range tails adv_{512 j}, j = 1..7, and the chain
    advances adv_4096 * 2^e, e = 0..19 (each advance as nibble tables)."""
    tails = [nibble_tables(crc_mod.advance_matrix(CRC_RANGE * j))
             for j in range(1, CRC_WARPS)]
    chain = [nibble_tables(crc_mod.advance_matrix(CRC_SEG << e))
             for e in range(CRC_CHAIN_LEVELS)]
    return np.concatenate([crc_mma_fragments().reshape(-1)]
                          + [t.reshape(-1) for t in tails + chain])


_consts: dict[tuple, ec_kernels._DeviceConst] = {}


def _on_device(key: tuple, build_fn, device: torch.device) -> torch.Tensor:
    """The parameter block `key` as bytes on `device`, built once."""
    const = _consts.get(key)
    if const is None:
        if len(_consts) > 256:
            _consts.clear()
        const = _consts[key] = ec_kernels._DeviceConst(
            np.ascontiguousarray(build_fn()).view(np.uint8))
    return const.on(device)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _gf_tables_on(matrix: np.ndarray, device: torch.device) -> torch.Tensor:
    return _on_device(("gf", matrix.shape, matrix.tobytes()),
                      lambda: gf_params(matrix), device)


def _gf_launch(matrix: np.ndarray, data: torch.Tensor,
               out: torch.Tensor) -> None:
    """gf_encode.cu's plain mode on data (B, c, L) into out (B, r, L)."""
    B, c, L = data.shape
    fn = _lib("gf_encode").ceph_gf_encode
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), out.data_ptr(),
                 _gf_tables_on(matrix, data.device).data_ptr(),
                 B, matrix.shape[0], c, L, _stream(data.device))
    _raise_on(err, "gf_encode")
    _count_launch("gf_encode")


def gf_transform(matrix: np.ndarray, data: torch.Tensor,
                 compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """(r, c) GF(2^8) matrix x data (B, c, L) uint8 -> (B, r, L) uint8 on
    data's device.  `compute` picks the plain version's accumulation;
    the kernel is exact whatever it says."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    _check_u8(data, 3, "gf_transform")
    if data.shape[1] != c:
        raise ValueError(f"gf_transform: matrix has {c} columns, data "
                         f"has {data.shape[1]} chunks")
    if data.device.type == "cpu":
        return ec_kernels.gf2_matmul_bytes(
            gf.expand_bitmatrix(matrix, 8), data, compute)
    gf_layout(r, c)
    B, _, L = data.shape
    out = torch.empty((B, r, L), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    _gf_launch(matrix, data, out)
    return out


def _segments(L: int) -> int:
    nseg = -(-L // CRC_SEG)
    if nseg > CRC_MAX_SEGMENTS:
        raise ValueError(f"crc32c: rows of {L} bytes exceed the chain "
                         f"pass's {CRC_MAX_SEGMENTS} segments")
    return nseg


def _crc_tables_on(device: torch.device) -> torch.Tensor:
    return _on_device(("crc",), crc_tables, device)


def gf_encode_segment_crcs(matrix: np.ndarray, data: torch.Tensor,
                           compute: str = DEFAULT_COMPUTE
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """gf_encode.cu's fused mode: (r, c) matrix x data (B, c, L) ->
    (out (B, r, L) uint8, segment CRCs (B, c + r, ceil(L / 4096))
    uint32 of the c data rows then the r output rows; see
    ``ec_kernels.segment_crcs`` for the segments)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    _check_u8(data, 3, "gf_encode_segment_crcs")
    if data.shape[1] != c:
        raise ValueError(f"gf_encode_segment_crcs: matrix has {c} "
                         f"columns, data has {data.shape[1]} chunks")
    B, _, L = data.shape
    nseg = _segments(L)
    if data.device.type == "cpu":
        out = ec_kernels.gf2_matmul_bytes(gf.expand_bitmatrix(matrix, 8),
                                          data, compute)
        return out, ec_kernels.segment_crcs(torch.cat([data, out], 1),
                                            CRC_SEG, compute)
    gf_layout(r, c, fused=True)
    out = torch.empty((B, r, L), dtype=torch.uint8, device=data.device)
    seg = torch.empty((B, c + r, nseg), dtype=torch.int32,
                      device=data.device)
    if B and r:
        fn = _lib("gf_encode").ceph_gf_encode_crc
        with torch.cuda.device(data.device):
            err = fn(data.data_ptr(), out.data_ptr(),
                     _gf_tables_on(matrix, data.device).data_ptr(),
                     B, r, c, L, _crc_tables_on(data.device).data_ptr(),
                     seg.data_ptr(), _stream(data.device))
        _raise_on(err, "gf_encode_crc")
        _count_launch("gf_encode_crc")
    return out, seg.view(torch.uint32)


def crc32c_segments(rows: torch.Tensor,
                    compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """crc32c.cu pass 1: (N, L) uint8 -> (N, ceil(L / 4096)) uint32
    segment CRCs (``ec_kernels.segment_crcs``)."""
    _check_u8(rows, 2, "crc32c_segments")
    N, L = rows.shape
    nseg = _segments(L)
    if rows.device.type == "cpu":
        return ec_kernels.segment_crcs(rows, CRC_SEG, compute)
    seg = torch.empty((N, nseg), dtype=torch.int32, device=rows.device)
    if N:
        fn = _lib("crc32c").ceph_crc32c_segments
        with torch.cuda.device(rows.device):
            err = fn(rows.data_ptr(), N, L, seg.data_ptr(),
                     _crc_tables_on(rows.device).data_ptr(),
                     _stream(rows.device))
        _raise_on(err, "crc32c_segments")
        _count_launch("crc32c_segments")
    return seg.view(torch.uint32)


def crc32c_chain(seg: torch.Tensor) -> torch.Tensor:
    """crc32c.cu pass 2: segment CRCs (N, nseg) uint32 of consecutive
    4 KiB segments -> (N,) uint32 CRCs of the rows they make up."""
    if not isinstance(seg, torch.Tensor) or seg.dtype != torch.uint32:
        raise TypeError("crc32c_chain: want a uint32 tensor")
    if seg.ndim != 2 or not seg.is_contiguous() or seg.shape[1] == 0:
        raise ValueError(f"crc32c_chain: want contiguous (N, nseg), got "
                         f"{tuple(seg.shape)}")
    N, nseg = seg.shape
    _segments(nseg * CRC_SEG)
    if seg.device.type == "cpu":
        return ec_kernels.chain_crcs(seg, CRC_SEG)
    out = torch.empty(N, dtype=torch.int32, device=seg.device)
    if N:
        fn = _lib("crc32c").ceph_crc32c_chain
        with torch.cuda.device(seg.device):
            err = fn(seg.data_ptr(), N, nseg, out.data_ptr(), 1, 1, 0,
                     _crc_tables_on(seg.device).data_ptr(),
                     _stream(seg.device))
        _raise_on(err, "crc32c_chain")
        _count_launch("crc32c_chain")
    return out.view(torch.uint32)


def crc32c_rows(rows: torch.Tensor,
                compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """CRC32C (seed 0) per row: (N, L) uint8 -> (N,) uint32."""
    _check_u8(rows, 2, "crc32c_rows")
    if rows.device.type == "cpu":
        return ec_kernels.make_crc_fn(rows.shape[1], compute=compute)(rows)
    return crc32c_chain(crc32c_segments(rows))


def make_encode_fn(matrix: np.ndarray, L: int | None = None,
                   compute: str = DEFAULT_COMPUTE):
    """fn(data (B, c, L) or (c, L)) -> (B, r, L) GF(2^8) transform.
    `L`, when given, is checked against every call."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)

    def run(data):
        if L is not None and data.shape[-1] != L:
            raise ValueError(f"encode: want L={L}, got {data.shape[-1]}")
        return gf_transform(matrix, data, compute)

    return batched(run)


def make_crc_fn(L: int, compute: str = DEFAULT_COMPUTE):
    """fn(rows (N, L) uint8) -> (N,) uint32 CRC32C, seed 0."""

    def run(rows):
        if rows.shape[-1] != L:
            raise ValueError(f"crc: want L={L}, got {rows.shape[-1]}")
        return crc32c_rows(rows, compute)

    return host_results(run)


def make_encode_crc_fn(matrix: np.ndarray, L: int,
                       compute: str = DEFAULT_COMPUTE):
    """fn(data (B, k, L)) -> (parity (B, m, L) uint8, crcs (B, k+m)
    uint32): CRCs of the k data chunks then the m parity chunks
    (HashInfo order).  Outputs stay on data's device."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    m, k = matrix.shape

    def run(data):
        _check_u8(data, 3, "encode_crc")
        if data.shape[1:] != (k, L):
            raise ValueError(f"encode_crc: want (B, {k}, {L}), got "
                             f"{tuple(data.shape)}")
        if data.device.type == "cpu":
            return ec_kernels.make_encode_crc_fn(matrix, L,
                                                 compute=compute)(data)
        parity, seg = gf_encode_segment_crcs(matrix, data)
        crcs = crc32c_chain(seg.view(-1, seg.shape[-1]))
        return parity, crcs.view(data.shape[0], k + m)

    return batched(run)


# ---------------------------------------------------------------------------
# Mesh functions: one batch's chunk length across a dp x ls plane
# ---------------------------------------------------------------------------


class _MeshRoute:
    """The plane the mesh functions run on (see ``ec_kernels`` for the
    algebra): member m = i * n_ls + j holds stripes [i*Sd, (i+1)*Sd) and
    padded columns [j*Lp, (j+1)*Lp), and works on a stream of its own.

    On cards, a member's slice goes up as one strided copy straight from
    the host batch (``ceph_copy_2d``: asynchronous from pinned memory,
    such as a staging arena), and the front pad and tail stripes are
    zeroed on the card, so no host copy pads the batch; its parity comes
    down the same way into one pinned array.  The partial CRCs combine
    on the first member: where Lp is a multiple of the 4 KiB CRC segment
    the members' segment CRCs, in ls order, are the segments of the whole
    padded row, and one ``crc32c_chain`` launch joins them; otherwise each
    member chains its own slice and the first member advances the slice
    CRCs over the bytes after them (a 32x32 GF(2) product in plain
    PyTorch) and XORs them.  Members wait for each other only through
    CUDA events.  CPU members take the same steps with plain copies and
    without streams, which is how the tests hold this route's combine."""

    def __init__(self, devices: tuple, n_dp: int, n_ls: int, L: int):
        self.devices = devices
        self.n_dp, self.n_ls = n_dp, n_ls
        self.L = L
        self.L_pad, self.Lp, self.pad = ec_kernels.mesh_geometry(L, n_ls)
        self.chain = self.Lp % CRC_SEG == 0
        self.comb = None if self.chain else \
            ec_kernels._slice_combine_matrices(n_ls, self.Lp)
        self.cuda = devices[0].type == "cuda"
        self.streams = [torch.cuda.Stream(device=d) for d in devices] \
            if self.cuda else None

    def ctx(self, m: int):
        """Member m's device and stream as the current ones."""
        if not self.cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.devices[m]))
        stack.enter_context(torch.cuda.stream(self.streams[m]))
        return stack

    def _cols(self, j: int) -> tuple[int, int, int]:
        """(first source column, columns, first destination column) of
        slice j in the unpadded row (no columns for a slice that lies in
        the front pad)."""
        start = j * self.Lp - self.pad
        c0 = max(0, start)
        c1 = max(c0, start + self.Lp)
        return c0, c1 - c0, c0 - start

    def _copy_2d(self, dst: int, dpitch: int, src: int, spitch: int,
                 width: int, height: int, m: int) -> None:
        """A strided copy on member m's stream, its card current."""
        with torch.cuda.device(self.devices[m]):
            err = _lib("crc32c").ceph_copy_2d(
                dst, dpitch, src, spitch, width, height,
                self.streams[m].cuda_stream)
        _raise_on(err, "mesh copy")

    def upload(self, batch: np.ndarray) -> list:
        """(S, ..., L) host batch -> members' (Sd, ..., Lp) slices."""
        S = batch.shape[0]
        Sd = -(-S // self.n_dp)
        if not self.cuda:
            arr = ec_kernels._mesh_pad(batch, self.n_dp, self.L_pad,
                                       self.pad)
            return [t for row in ec_kernels._mesh_slices(
                arr, self.devices, self.n_dp, self.n_ls, self.Lp)
                for t in row]
        batch = np.ascontiguousarray(batch)
        mid = batch.shape[1:-1]
        C = int(np.prod(mid, dtype=np.int64))
        out = []
        for m, dev in enumerate(self.devices):
            i, j = divmod(m, self.n_ls)
            live = max(0, min(S, (i + 1) * Sd) - i * Sd)
            with self.ctx(m):
                t = torch.empty((Sd,) + mid + (self.Lp,), dtype=torch.uint8,
                                device=dev)
                if live < Sd:
                    t[live:].zero_()
                c0, w, d0 = self._cols(j)
                if d0:
                    t[:live, ..., :d0].zero_()
                if live:
                    self._copy_2d(t.data_ptr() + d0, self.Lp,
                                  batch.ctypes.data + i * Sd * C * self.L
                                  + c0, self.L, w, live * C, m)
            out.append(t)
        return out

    def download(self, parts: list, S: int) -> np.ndarray:
        """Members' (Sd, ..., Lp) outputs -> one (S, ..., L) host array."""
        if not self.cuda:
            grid = [parts[i * self.n_ls:(i + 1) * self.n_ls]
                    for i in range(self.n_dp)]
            return ec_kernels._host_rows(grid, S, self.pad)
        Sd = parts[0].shape[0]
        mid = tuple(parts[0].shape[1:-1])
        C = int(np.prod(mid, dtype=np.int64))
        host = torch.empty((S,) + mid + (self.L,), dtype=torch.uint8,
                           pin_memory=True)
        for m, t in enumerate(parts):
            i, j = divmod(m, self.n_ls)
            live = max(0, min(S, (i + 1) * Sd) - i * Sd)
            c0, w, d0 = self._cols(j)
            if live:
                self._copy_2d(host.data_ptr() + i * Sd * C * self.L + c0,
                              self.L, t.data_ptr() + d0, self.Lp, w,
                              live * C, m)
        return host.numpy()

    def _gather(self, m: int, t: torch.Tensor) -> torch.Tensor:
        """Member m's output `t` as a tensor on the first member that its
        stream may read (after member m's work queued so far)."""
        if not self.cuda:
            return t.to(self.devices[0])
        if m == 0:
            return t
        done = torch.cuda.Event()
        done.record(self.streams[m])
        if self.devices[m] == self.devices[0]:
            self.streams[0].wait_event(done)
            t.record_stream(self.streams[0])
            return t
        with self.ctx(0):
            dst = torch.empty_like(t, device=self.devices[0])
        n = t.numel() * t.element_size()
        self._copy_2d(dst.data_ptr(), n, t.data_ptr(), n, n, 1, m)
        moved = torch.cuda.Event()
        moved.record(self.streams[m])
        self.streams[0].wait_event(moved)
        return dst

    def combine(self, segs: list) -> torch.Tensor:
        """Members' segment CRCs (Sd, R, nseg) uint32 -> the (S_pad, R)
        row CRCs on the first member."""
        Sd, R = segs[0].shape[:2]
        if not self.chain:
            parts = []
            for m, seg in enumerate(segs):
                with self.ctx(m):
                    parts.append(crc32c_chain(
                        seg.reshape(-1, seg.shape[-1])).view(Sd, R))
            segs = parts
        moved = [self._gather(m, t) for m, t in enumerate(segs)]
        with self.ctx(0):
            rows = []
            for i in range(self.n_dp):
                row = moved[i * self.n_ls:(i + 1) * self.n_ls]
                if self.chain:
                    rows.append(torch.cat(
                        [t.view(torch.int32) for t in row], dim=-1))
                else:
                    rows.append(ec_kernels.combine_crc_partials(
                        row, self.comb).view(torch.int32))
            out = torch.cat(rows)
            if self.chain:
                out = crc32c_chain(out.view(torch.uint32).reshape(
                    -1, out.shape[-1])).view(torch.int32).view(
                        self.n_dp * Sd, R)
            return out.cpu().numpy().view(np.uint32)

    def finish(self) -> None:
        """Wait for every member's queued work (the downloads)."""
        if self.cuda:
            for stream in self.streams:
                stream.synchronize()


def _mesh_route(devices, n_dp, n_ls, L: int) -> _MeshRoute | None:
    """The card's route over `devices`, or None when they are all CPU
    devices (the plain version then serves)."""
    devices, n_dp, n_ls = ec_kernels.mesh_layout(devices, n_dp, n_ls)
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return None
    if kinds != {"cuda"}:
        raise ValueError(f"mesh: members must all be CUDA or all CPU "
                         f"devices, got {sorted(kinds)}")
    return _MeshRoute(devices, n_dp, n_ls, int(L))


def mesh_encode_crc(matrix: np.ndarray, route: _MeshRoute,
                    donate: bool = False):
    """The mesh encode over `route` (``make_mesh_encode_crc_fn``'s body,
    which the tests also run on a CPU route)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    m, k = matrix.shape

    def run(batch, keep_resident: bool = False):
        batch = np.asarray(batch, dtype=np.uint8)
        if batch.ndim != 3 or batch.shape[1:] != (k, route.L):
            raise ValueError(f"mesh encode: want (S, {k}, {route.L}), got "
                             f"{batch.shape}")
        S = batch.shape[0]
        data = route.upload(batch)
        parity, segs = [], []
        for j, x in enumerate(data):
            with route.ctx(j):
                p, seg = gf_encode_segment_crcs(matrix, x)
            parity.append(p)
            segs.append(seg)
        host_parity = route.download(parity, S)
        crcs = route.combine(segs)[:S]
        route.finish()
        resident = None
        if keep_resident and not donate:
            grid = [list(range(i * route.n_ls, (i + 1) * route.n_ls))
                    for i in range(route.n_dp)]
            resident = (ec_kernels.MeshRows([[data[j] for j in r]
                                             for r in grid]),
                        ec_kernels.MeshRows([[parity[j] for j in r]
                                             for r in grid]),
                        route.pad)
        return host_parity, crcs, resident

    run.chunk_pad = route.pad
    return run


def mesh_crc(route: _MeshRoute):
    """The mesh CRC over `route` (``make_mesh_crc_fn``'s body)."""

    def run(batch):
        batch = np.asarray(batch, dtype=np.uint8)
        if batch.ndim != 2 or batch.shape[1] != route.L:
            raise ValueError(f"mesh crc: want (B, {route.L}), got "
                             f"{batch.shape}")
        rows = route.upload(batch)
        segs = []
        for j, x in enumerate(rows):
            with route.ctx(j):
                segs.append(crc32c_segments(x).unsqueeze(1))
        out = route.combine(segs)[:batch.shape[0], 0]
        route.finish()
        return out

    run.chunk_pad = route.pad
    return run


def make_mesh_encode_crc_fn(matrix: np.ndarray, L: int, devices,
                            n_dp: int = 1, n_ls: int | None = None,
                            compute: str = DEFAULT_COMPUTE,
                            donate: bool = False):
    """``ec_kernels.make_mesh_encode_crc_fn`` with the hand kernels on
    CUDA members: run(batch (S, k, L) host uint8, keep_resident=False) ->
    (parity (S, m, L), crcs (S, k+m) uint32, resident).  Per call each
    member launches gf_encode_crc once, then crc32c_chain runs once on
    the first member (Lp a multiple of 4 KiB) or once on each member.
    CPU members run the plain version."""
    route = _mesh_route(devices, n_dp, n_ls, L)
    if route is None:
        return ec_kernels.make_mesh_encode_crc_fn(matrix, L, devices, n_dp,
                                                  n_ls, compute, donate)
    return mesh_encode_crc(matrix, route, donate)


def make_mesh_crc_fn(L: int, devices, n_dp: int = 1,
                     n_ls: int | None = None,
                     compute: str = DEFAULT_COMPUTE):
    """``ec_kernels.make_mesh_crc_fn`` with the hand kernels on CUDA
    members: run(batch (B, L) host uint8) -> (B,) uint32.  Per call each
    member launches crc32c_segments once, and crc32c_chain runs as in
    the encode."""
    route = _mesh_route(devices, n_dp, n_ls, L)
    if route is None:
        return ec_kernels.make_mesh_crc_fn(L, devices, n_dp, n_ls, compute)
    return mesh_crc(route)
