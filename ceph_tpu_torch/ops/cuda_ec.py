"""Hand-written CUDA kernels for the erasure-code path, and their wrappers.

Counterpart of ``ceph_tpu/ops/pallas_ec.py``:

  * ``gf_transform`` / ``make_encode_fn`` launch ``csrc/gf_encode.cu``
    (replaces ``_encode_kernel``): GF(2^8) matrix x chunks, the encode
    with the coding matrix and the rebuild decode with
    ``gf.decode_matrix`` rows;
  * ``crc32c_rows`` / ``make_crc_fn`` launch ``csrc/crc32c.cu``
    (replaces ``_crc_kernel``): CRC32C (seed 0) per row;
  * ``make_encode_crc_fn`` is the fused pass: encode, then the CRCs of
    the data rows and of the parity rows into one (B, k+m) array, all on
    one stream with no host sync and no concatenation copy.

They keep ``pallas_ec``'s call contract without its TPU limits (any L,
no tile sizes).  Each wrapper checks device, dtype, shape and
contiguity.  A CPU tensor runs the plain PyTorch version from
``ops/ec_kernels.py``; a CUDA tensor launches the kernel or raises.

The kernels are built at first use with nvcc for sm_90a, one shared
library with a plain C interface per source (all sources compile in
parallel), into ``ceph_tpu_torch/_build/`` under a name keyed by a hash
of the source and flags, and bound with ctypes.  ``launches`` counts
kernel launches per wrapper, so a run can show which kernels its path
went through.
"""

from __future__ import annotations

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
from .ec_kernels import DEFAULT_COMPUTE, as_u8, batched

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = {"gf_encode": "gf_encode.cu", "crc32c": "crc32c.cu"}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "gf_encode": ("ceph_gf_encode", [_P, _P, _P, _I, _I, _I, _I64, _P]),
    "crc32c": ("ceph_crc32c_rows", [_P, _I, _I64, _P, _P, _I, _I, _I, _P,
                                    _P]),
}

# kernel launches per kernel (the fused pass launches gf_encode once
# and crc32c twice, and has no count of its own)
launches = {"gf_encode": 0, "crc32c": 0}

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()

CRC_SEG = 4096                  # bytes per segment, csrc/crc32c.cu kSeg
_CRC_LANE = 128                 # bytes per lane, kLane
_GF_MAX_PARAMS = 48 * 1024      # static shared-memory budget of a block


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    src = os.path.join(CSRC_DIR, SOURCES[name])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
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
            fn_name, argtypes = _ARGTYPES[name]
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
    """gf_encode.cu's parameter block: log[256] | exp[512] | the
    matrix's logs (r, c), with 255 standing for log 0."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    log = gf.GF_LOG.astype(np.uint8)
    log[0] = 255
    mlog = log[matrix]
    return np.concatenate([log, gf.GF_EXP.astype(np.uint8),
                           mlog.reshape(-1)])


def _columns(mat: np.ndarray) -> np.ndarray:
    """32x32 GF(2) matrix (out = M @ bits) -> 32 uint32 column words."""
    weights = (1 << np.arange(32, dtype=np.uint64))
    return (mat.astype(np.uint64) * weights[:, None]).sum(0).astype(
        np.uint32)


def crc_tables() -> np.ndarray:
    """crc32c.cu's table block: slicing-by-8 tables, then the column
    words of adv_128, adv_256, ..., adv_4096."""
    adv = [_columns(crc_mod.advance_matrix(_CRC_LANE << i))
           for i in range(6)]
    return np.concatenate([crc_mod._slice8_tables().reshape(-1)] + adv)


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
    if 768 + r * c > _GF_MAX_PARAMS:
        raise ValueError(f"gf_transform: matrix {r}x{c} exceeds the "
                         "kernel's shared-memory budget")
    B, _, L = data.shape
    out = torch.empty((B, r, L), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    params = _on_device(("gf", matrix.shape, matrix.tobytes()),
                        lambda: gf_params(matrix), data.device)
    fn = _lib("gf_encode").ceph_gf_encode
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), out.data_ptr(), params.data_ptr(),
                 B, r, c, L, _stream(data.device))
    _raise_on(err, "gf_encode")
    launches["gf_encode"] += 1
    return out


def _crc_launch(rows: torch.Tensor, out: torch.Tensor, per: int,
                stride: int, offset: int) -> None:
    """CRCs of rows (N, L) on the card into out (int32 storage) at
    (n // per) * stride + offset + n % per."""
    N, L = rows.shape
    if N == 0:
        return
    nseg = -(-L // CRC_SEG)
    seg = torch.empty(N * nseg, dtype=torch.int32, device=rows.device)
    tables = _on_device(("crc",), crc_tables, rows.device)
    fn = _lib("crc32c").ceph_crc32c_rows
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), N, L, seg.data_ptr(), out.data_ptr(),
                 per, stride, offset, tables.data_ptr(),
                 _stream(rows.device))
    _raise_on(err, "crc32c")
    launches["crc32c"] += 1


def crc32c_rows(rows: torch.Tensor,
                compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """CRC32C (seed 0) per row: (N, L) uint8 -> (N,) uint32."""
    _check_u8(rows, 2, "crc32c_rows")
    N, L = rows.shape
    if rows.device.type == "cpu":
        return ec_kernels.make_crc_fn(L, compute=compute)(rows)
    out = torch.empty(N, dtype=torch.int32, device=rows.device)
    _crc_launch(rows, out, 1, 1, 0)
    return out.view(torch.uint32)


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
        rows = as_u8(rows)
        if rows.shape[-1] != L:
            raise ValueError(f"crc: want L={L}, got {rows.shape[-1]}")
        return crc32c_rows(rows, compute)

    return run


def make_encode_crc_fn(matrix: np.ndarray, L: int,
                       compute: str = DEFAULT_COMPUTE):
    """fn(data (B, k, L)) -> (parity (B, m, L) uint8, crcs (B, k+m)
    uint32): CRCs of the k data chunks then the m parity chunks
    (HashInfo order).  Outputs stay on data's device."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    m, k = matrix.shape

    def run(data):
        _check_u8(data, 3, "encode_crc")
        B = data.shape[0]
        if data.shape[1:] != (k, L):
            raise ValueError(f"encode_crc: want (B, {k}, {L}), got "
                             f"{tuple(data.shape)}")
        if data.device.type == "cpu":
            return ec_kernels.make_encode_crc_fn(matrix, L,
                                                 compute=compute)(data)
        parity = gf_transform(matrix, data, compute)
        crcs = torch.empty((B, k + m), dtype=torch.int32,
                           device=data.device)
        _crc_launch(data.view(B * k, L), crcs, k, k + m, 0)
        _crc_launch(parity.view(B * m, L), crcs, m, k + m, k)
        return parity, crcs.view(torch.uint32)

    return batched(run)
