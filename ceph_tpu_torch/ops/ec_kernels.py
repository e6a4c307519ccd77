"""Plain PyTorch versions of the erasure-code device transforms.

Counterpart of ``ceph_tpu/ops/ec_kernels.py`` with the same signatures,
shapes and bytes out.  These are the readable formulation: GF(2^8)
multiply-by-constant is GF(2)-linear on a byte's bits, so an (m x k)
byte matrix becomes an (8m x 8k) 0/1 matrix and encode is

    parity_bits = (G_bits @ data_bits) mod 2;

CRC32C (seed 0) is GF(2)-linear in the message bits, so a chunk's CRC
is a fold of fixed-size blocks through one shared matrix followed by
per-position 32x32 combines (``ops/crc32c.py``).

They serve two roles: on CPU tensors they ARE the implementation (the
CUDA wrappers in ``ops/cuda_ec.py`` route CPU tensors here), and on the
card they are the plain reference the hand kernels are held against.
The TPU's MXU block-diagonal packing does not carry over.  The mesh
functions (``make_mesh_encode_crc_fn``, ``make_mesh_crc_fn``) split one
batch's chunk length across an explicit list of devices; their form
here serves CPU lanes and the tests, ``cuda_ec`` has the card's.

Every ``make_*`` function returns a callable that takes a uint8 tensor
(or a numpy array, which is moved to the package device) and returns
tensors on the input's device.  CRCs are ``torch.uint32``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import get_device
from . import crc32c as crc_mod
from . import gf

# Accumulation dtype of the bit-matrix contraction: "int8" sums the 0/1
# products in int32, "bf16" in float32 (exact: every sum is an integer
# far below 2**24).  Both give the same bytes.
_COMPUTE_DTYPES = {
    "int8": torch.int32,
    "bf16": torch.float32,
}

DEFAULT_COMPUTE = "int8"

# elements per broadcast product in the integer contraction
_INT_CONTRACT_BUDGET = 1 << 26


def as_u8(data, device=None) -> torch.Tensor:
    """uint8 tensor over `data`: a tensor stays where it is, a numpy
    array (or bytes) moves to `device` (default: the package device)."""
    if isinstance(data, torch.Tensor):
        return data if data.dtype == torch.uint8 else data.to(torch.uint8)
    arr = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
    return torch.from_numpy(arr).to(device or get_device())


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as torch.uint32."""
    x = torch.where(x >= (1 << 31), x - (1 << 32), x)
    return x.to(torch.int32).view(torch.uint32)


class _DeviceConst:
    """A host constant, uploaded once per device it is used on."""

    def __init__(self, arr: np.ndarray):
        self._arr = np.ascontiguousarray(arr)
        self._by_dev: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._by_dev.get(device)
        if t is None:
            t = torch.from_numpy(self._arr).to(device)
            self._by_dev[device] = t
        return t


def _contract(a: torch.Tensor, b: torch.Tensor,
              acc: torch.dtype) -> torch.Tensor:
    """(R, C) x (..., C, N) -> (..., R, N) sums of products in `acc`.

    torch has no integer matmul on CUDA, so the integer accumulation is
    a broadcast multiply-and-sum over C, chunked along N to bound its
    temporary."""
    a = a.to(acc)
    if acc.is_floating_point:
        return torch.matmul(a, b.to(acc))
    R, C = a.shape
    N = b.shape[-1]
    nlead = int(np.prod(b.shape[:-2], dtype=np.int64))
    step = max(1, _INT_CONTRACT_BUDGET // max(1, R * C * nlead))
    prods = a[:, :, None]
    outs = [(prods * b[..., s:s + step].to(acc).unsqueeze(-3)).sum(-2)
            for s in range(0, N, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n, L) uint8 -> (..., n*8, L) 0/1 uint8, row = n*8 + bit."""
    bits = (x.unsqueeze(-2) >> _shifts(x.device).view(8, 1)) & 1
    return bits.reshape(x.shape[:-2] + (x.shape[-2] * 8, x.shape[-1]))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n*8, L) 0/1 -> (..., n, L) uint8."""
    b = bits.reshape(bits.shape[:-2] + (bits.shape[-2] // 8, 8,
                                        bits.shape[-1])).to(torch.uint8)
    return (b << _shifts(b.device).view(8, 1)).sum(-2, dtype=torch.uint8)


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.int32) & 1).to(torch.uint8)


def gf2_matmul_bytes(g_bits, data: torch.Tensor,
                     compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """Apply a GF(2) bit-matrix to byte chunks.

    g_bits: (R, C) 0/1 (R, C multiples of 8), data: (..., C/8, L) uint8
    -> (..., R/8, L) uint8.
    """
    acc = _COMPUTE_DTYPES[compute]
    g = torch.as_tensor(g_bits, device=data.device)
    return _pack_bits(_mod2(_contract(g, _unpack_bits(data), acc)))


def host_results(fn):
    """fn over a uint8 tensor, which also takes numpy input (or bytes):
    that moves to the package device, and the results come back to the
    host, as a JAX array given to np.asarray does.  A tensor input keeps
    its results where they are."""

    def call(data):
        out = fn(as_u8(data))
        if isinstance(data, torch.Tensor):
            return out
        return tuple(o.cpu() for o in out) if isinstance(out, tuple) \
            else out.cpu()

    return call


def batched(fn):
    """Accept (k, L) as well as (B, k, L) — the 2-D form is a batch of
    one — and numpy input (see :func:`host_results`)."""

    def call(data):
        if data.ndim != 2:
            return fn(data)
        out = fn(data[None])
        return tuple(o[0] for o in out) if isinstance(out, tuple) \
            else out[0]

    return host_results(call)


def make_codec_fn(matrix: np.ndarray, w: int = 8,
                  compute: str = DEFAULT_COMPUTE):
    """Chunk transform from a GF(2^w) byte matrix.

    matrix: (m, k) uint8 over GF(2^8) (or an already-expanded GF(2)
    bit-matrix when w == 1).  Returns fn(data: (B, k, L) or (k, L)
    uint8) -> same-rank parity tensor.
    """
    if w == 8:
        bits = gf.expand_bitmatrix(np.asarray(matrix, dtype=np.uint8), 8)
    elif w == 1:
        bits = np.asarray(matrix, dtype=np.uint8)
        if bits.shape[0] % 8 or bits.shape[1] % 8:
            raise ValueError(f"bit-matrix shape {bits.shape} not a "
                             "multiple of 8")
    else:
        raise ValueError(f"unsupported w={w}")
    g = _DeviceConst(bits)
    return batched(
        lambda data: gf2_matmul_bytes(g.on(data.device), data, compute))


# ---------------------------------------------------------------------------
# Packetized GF(2) transforms (jerasure bitmatrix techniques)
#
# Bit-matrix techniques (cauchy_*, liberation) lay a chunk out as
# super-blocks of w packets and XOR whole packets per the 0/1 schedule.
# A packet XOR is bitwise, so the schedule is ONE GF(2) contraction with
# the raw bitmatrix, batched over super-blocks.
# ---------------------------------------------------------------------------


def gf2_packet_matmul(m_bits: torch.Tensor, packets: torch.Tensor,
                      compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """m_bits: (R, C) 0/1; packets: (..., C, P) uint8 -> (..., R, P) uint8.

    out[r] = XOR over c with m_bits[r, c] of packets[c]; bytes are 8
    independent GF(2) lanes, so unpack along the byte axis only.
    """
    acc = _COMPUTE_DTYPES[compute]
    lead = packets.shape[:-2]
    C, P = packets.shape[-2:]
    bits = (packets.unsqueeze(-1) >> _shifts(packets.device)) & 1
    bits = bits.reshape(lead + (C, P * 8))
    out = _mod2(_contract(m_bits, bits, acc))
    out = out.reshape(lead + (m_bits.shape[0], P, 8))
    return (out << _shifts(out.device)).sum(-1, dtype=torch.uint8)


def make_packet_codec_fn(matrix: np.ndarray, w: int, packetsize: int,
                         compute: str = DEFAULT_COMPUTE):
    """Packetized transform from a GF(2^w) byte matrix.

    matrix: (r, c) uint8 -> fn(data (B, c, L) or (c, L)) -> (B, r, L)
    parity in jerasure bitmatrix chunk layout.
    """
    bits = gf.expand_bitmatrix(np.asarray(matrix, dtype=np.uint8), w)
    return make_bits_codec_fn(bits, w, packetsize, compute)


def make_bits_codec_fn(bits: np.ndarray, w: int, packetsize: int,
                       compute: str = DEFAULT_COMPUTE):
    """Packetized transform from a raw GF(2) bit-matrix (liberation /
    blaum_roth minimal-density codes, which have no byte-matrix form)."""
    bits = np.asarray(bits, dtype=np.uint8)
    rows = bits.shape[0]
    m_bits = _DeviceConst(bits)

    def run(data):
        # data: (B, n, L) uint8, n*w == cols, L % (w*packetsize) == 0
        B, n, L = data.shape
        nblk = L // (w * packetsize)
        packets = data.reshape(B, n, nblk, w, packetsize).transpose(1, 2)
        packets = packets.reshape(B, nblk, n * w, packetsize)
        out = gf2_packet_matmul(m_bits.on(data.device), packets, compute)
        r = rows // w
        out = out.reshape(B, nblk, r, w, packetsize).transpose(1, 2)
        return out.reshape(B, r, nblk * w * packetsize)

    return batched(run)


# ---------------------------------------------------------------------------
# CRC32C (seed 0) over the last axis
# ---------------------------------------------------------------------------

DEFAULT_CRC_BLOCK = 16
CRC_GROUP = 64
_SEGMENTS_PER_CALL = 4096


def _pick_block(nbytes: int) -> int:
    for b in (128, 64, 32, 16, 8, 4, 2, 1):
        if nbytes % b == 0:
            return b
    return 1


def _flat_combine(mats: np.ndarray) -> np.ndarray:
    """(n, 32, 32) per-position combines -> (32, n*32) so the combine
    is one contraction over (position, state bit)."""
    return np.ascontiguousarray(mats.transpose(1, 0, 2).reshape(32, -1))


@functools.lru_cache(maxsize=64)
def _crc_fn(nbytes: int, block: int, compute: str):
    acc = _COMPUTE_DTYPES[compute]
    nblk = nbytes // block
    hierarchical = nblk % CRC_GROUP == 0 and nblk >= CRC_GROUP
    if hierarchical:
        fold_np, gcomb_np, top_np = crc_mod.block_crc_matrices_2level(
            nbytes, block, CRC_GROUP)
        gcomb = _DeviceConst(_flat_combine(gcomb_np))
        comb = _DeviceConst(_flat_combine(top_np))
    else:
        fold_np, comb_np = crc_mod.block_crc_matrices(nbytes, block)
        comb = _DeviceConst(_flat_combine(comb_np))
    fold = _DeviceConst(fold_np)         # (32, 8*block)

    def run(chunks: torch.Tensor) -> torch.Tensor:
        # chunks: (..., L) uint8; bits byte-major LSB-first to match
        # crc32c.message_matrix's column convention
        dev = chunks.device
        lead = chunks.shape[:-1]
        blocks = chunks.reshape(lead + (nblk, block))
        bits = (blocks.unsqueeze(-1) >> _shifts(dev)) & 1
        bits = bits.reshape(lead + (nblk, block * 8)).transpose(-1, -2)
        r = _mod2(_contract(fold.on(dev), bits, acc))    # (..., 32, nblk)
        if hierarchical:
            ngroups = nblk // CRC_GROUP
            # (..., u, g, t) -> (..., (t, u), g): one group per column
            rg = r.reshape(lead + (32, ngroups, CRC_GROUP))
            rg = rg.permute(*range(len(lead)), -1, -3, -2)
            rg = rg.reshape(lead + (CRC_GROUP * 32, ngroups))
            r = _mod2(_contract(gcomb.on(dev), rg, acc))  # (..., 32, ngroups)
        # (..., u, n) -> (..., (n, u), 1)
        flat = r.transpose(-1, -2).reshape(lead + (-1, 1))
        state = _mod2(_contract(comb.on(dev), flat, acc))[..., 0]
        weights = torch.tensor([1 << i for i in range(32)],
                               dtype=torch.int64, device=dev)
        return to_u32((state.to(torch.int64) * weights).sum(-1))

    return run


def make_crc_fn(nbytes: int, block: int = DEFAULT_CRC_BLOCK,
                compute: str = DEFAULT_COMPUTE):
    """CRC32C (seed 0) over the last axis: (..., L) uint8 -> (...) uint32.

    Seed chaining is applied on the host via crc32c.crc32c_combine.
    """
    if nbytes % block:
        block = _pick_block(nbytes)
    return host_results(_crc_fn(nbytes, block, compute))


def segment_crcs(rows: torch.Tensor, seg_len: int,
                 compute: str = DEFAULT_COMPUTE) -> torch.Tensor:
    """CRC32C (seed 0) of each `seg_len`-byte segment of each row, the
    segments counted from the row's end and the first front-padded with
    zeros (which leave a seed-0 CRC at 0): (..., L) uint8 ->
    (..., ceil(L / seg_len)) uint32.  ``chain_crcs`` joins them back into
    the row's CRC."""
    rows = as_u8(rows)
    L = rows.shape[-1]
    nseg = -(-L // seg_len)
    pad = nseg * seg_len - L
    if pad:
        rows = torch.cat([rows.new_zeros(rows.shape[:-1] + (pad,)), rows],
                         dim=-1)
    # a few thousand segments per call bound the contraction's temporaries
    segs = rows.reshape(-1, seg_len)
    if not segs.shape[0]:
        return rows.new_zeros(rows.shape[:-1] + (nseg,),
                              dtype=torch.int32).view(torch.uint32)
    crc = make_crc_fn(seg_len, compute=compute)
    out = torch.cat([crc(segs[i:i + _SEGMENTS_PER_CALL])
                     for i in range(0, segs.shape[0], _SEGMENTS_PER_CALL)])
    return out.reshape(rows.shape[:-1] + (nseg,))


def chain_crcs(seg_crcs: torch.Tensor, seg_len: int) -> torch.Tensor:
    """CRCs of consecutive `seg_len`-byte segments -> the CRC of their
    join: (..., nseg) uint32 -> (...) uint32, crc <- adv(crc) ^ next, with
    adv the advance over `seg_len` zero bytes."""
    dev = seg_crcs.device
    adv = torch.as_tensor(crc_mod.advance_matrix(seg_len), device=dev)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = (seg_crcs.view(torch.int32).to(torch.int64).unsqueeze(-1)
            >> shifts) & 1                                 # (..., nseg, 32)
    state = torch.zeros_like(bits[..., 0, :])
    for s in range(bits.shape[-2]):
        state = _contract(adv, state.unsqueeze(-1), torch.int32)[..., 0]
        state = (state + bits[..., s, :]) & 1
    return to_u32((state << shifts).sum(-1))


# ---------------------------------------------------------------------------
# Fused encode + scrub CRC
# ---------------------------------------------------------------------------


def encode_readback_bytes(B: int, k: int, m: int, L: int) -> int:
    """Exact D2H bytes one fused encode+CRC dispatch of a (B, k, L)
    batch fetches: the (B, m, L) parity block plus the 4-byte CRC per
    chunk — the data shards the host already holds are NEVER echoed
    back."""
    return B * m * L + 4 * B * (k + m)


def _encode_crc(matrix, nbytes, block, compute, witness_only):
    bits = _DeviceConst(
        gf.expand_bitmatrix(np.asarray(matrix, dtype=np.uint8), 8))
    if nbytes % block:
        block = _pick_block(nbytes)
    crc = _crc_fn(nbytes, block, compute)

    def run(data):
        parity = gf2_matmul_bytes(bits.on(data.device), data, compute)
        crcs = crc(torch.cat([data, parity], dim=-2))
        return crcs if witness_only else (parity, crcs)

    return host_results(run)


def make_encode_crc_fn(matrix: np.ndarray, nbytes: int,
                       block: int = DEFAULT_CRC_BLOCK,
                       compute: str = DEFAULT_COMPUTE):
    """fn(data (B, k, L)) -> (parity (B, m, L), crcs (B, k+m) uint32)."""
    return _encode_crc(matrix, nbytes, block, compute, False)


def make_encode_crc_witness_fn(matrix: np.ndarray, nbytes: int,
                               block: int = DEFAULT_CRC_BLOCK,
                               compute: str = DEFAULT_COMPUTE):
    """fn(data (B, k, L)) -> crcs (B, k+m) uint32 only: parity never
    leaves the device, and the CRCs depend on every parity byte."""
    return _encode_crc(matrix, nbytes, block, compute, True)


# ---------------------------------------------------------------------------
# Mesh-sharded encode + CRC: one batch across a dp x ls plane of devices
#
# Parity is row-local in the chunk-length axis L (parity byte l depends
# only on data bytes at position l), so splitting L across the "ls"
# members needs no exchange for the parity: each member encodes its
# L-slice against the whole generator.  The per-chunk CRC (seed 0) is
# GF(2)-linear in the message, so each member folds its slice alone, the
# partial of slice j is advanced over the (n_ls-1-j)*Lp bytes that follow
# it, and the partials XOR into the chunk's CRC on the plane's first
# member.  L that does not divide by n_ls is FRONT-padded with zeros:
# under seed 0 the CRC stays 0 through leading zeros and the pad
# columns' parity is zero, so both outputs slice back exactly.  The "dp"
# axis splits the stripes; S tail-pads with zero stripes.  Members are
# laid out row-major: member (i, j) is devices[i * n_ls + j].
# ---------------------------------------------------------------------------


def mesh_geometry(nbytes: int, n_ls: int) -> tuple[int, int, int]:
    """(L_pad, Lp, pad) for splitting an L=nbytes chunk axis over n_ls
    members: L front-pads to the next multiple of n_ls."""
    L_pad = -(-nbytes // n_ls) * n_ls
    return L_pad, L_pad // n_ls, L_pad - nbytes


def mesh_layout(devices, n_dp: int = 1,
                n_ls: int | None = None) -> tuple[tuple, int, int]:
    """(devices, n_dp, n_ls) checked: n_ls defaults to every device on
    the chunk-length axis."""
    devices = tuple(torch.device(d) for d in devices)
    n_dp = max(1, int(n_dp))
    if n_ls is None:
        n_ls = len(devices) // n_dp
    if n_dp * n_ls != len(devices) or not devices:
        raise ValueError(f"mesh {n_dp}x{n_ls} != {len(devices)} devices")
    return devices, n_dp, int(n_ls)


def _slice_combine_matrices(n_ls: int, Lp: int) -> np.ndarray:
    """(n_ls, 32, 32) GF(2): slice j's CRC partial advanced over the
    (n_ls-1-j)*Lp bytes that follow it, so XOR over j yields the full
    chunk CRC (linearity of seed-0 CRC32C in the message bits)."""
    return np.stack([crc_mod.advance_matrix((n_ls - 1 - j) * Lp)
                     for j in range(n_ls)]).astype(np.uint8)


def combine_crc_partials(partials: list, mats: np.ndarray) -> torch.Tensor:
    """XOR over j of mats[j] applied to partials[j], each (...) uint32 on
    one device: the slice CRCs of a row in ls order -> the row's CRC."""
    dev = partials[0].device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    acc = None
    for part, mat in zip(partials, mats):
        bits = (part.view(torch.int32).to(torch.int64).unsqueeze(-1)
                >> shifts) & 1                             # (..., 32)
        adv = _contract(torch.as_tensor(mat, device=dev),
                        bits.unsqueeze(-1), torch.int32)[..., 0]
        acc = adv if acc is None else acc + adv
    return to_u32(((acc & 1).to(torch.int64) << shifts).sum(-1))


class MeshRows:
    """A (S, C, L_pad) uint8 array held in pieces on the members of a
    dp x ls plane: member (i, j) holds rows [i*Sd, (i+1)*Sd) and columns
    [j*Lp, (j+1)*Lp) of it as one (Sd, C, Lp) tensor.  ``rows`` and
    ``select`` cut views; ``to_host`` gathers the cut into one numpy
    array.  The mesh functions' resident inputs and parity, which the
    HBM cache keeps."""

    __slots__ = ("grid", "row0", "nrows", "chunk")

    def __init__(self, grid: list, row0: int = 0, nrows: int | None = None,
                 chunk: int | None = None):
        self.grid = grid
        self.row0 = row0
        self.nrows = len(grid) * grid[0][0].shape[0] if nrows is None \
            else nrows
        self.chunk = chunk

    @property
    def shape(self) -> tuple:
        C, Lp = self.grid[0][0].shape[1:]
        L_pad = Lp * len(self.grid[0])
        return (self.nrows, L_pad) if self.chunk is not None \
            else (self.nrows, C, L_pad)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def rows(self, start: int, stop: int) -> "MeshRows":
        return MeshRows(self.grid, self.row0 + start, stop - start,
                        self.chunk)

    def select(self, chunk: int) -> "MeshRows":
        """Chunk row `chunk` of every stripe: (S, L_pad)."""
        return MeshRows(self.grid, self.row0, self.nrows, chunk)

    def to_host(self) -> np.ndarray:
        Sd = self.grid[0][0].shape[0]
        parts = []
        for i, row in enumerate(self.grid):
            a = max(self.row0, i * Sd)
            b = min(self.row0 + self.nrows, (i + 1) * Sd)
            if a >= b:
                continue
            pieces = [t[a - i * Sd: b - i * Sd] for t in row]
            if self.chunk is not None:
                pieces = [p[:, self.chunk] for p in pieces]
            parts.append(np.concatenate([p.cpu().numpy() for p in pieces],
                                        axis=-1))
        return np.concatenate(parts)


def _mesh_pad(batch: np.ndarray, n_dp: int, L_pad: int,
              pad: int) -> np.ndarray:
    """batch (S, ..., L) with L front-padded to L_pad and S tail-padded
    to a multiple of n_dp: a host copy of the whole batch when either
    pads, audited as ``ec.mesh_pad``."""
    S = batch.shape[0]
    S_pad = -(-S // n_dp) * n_dp
    if not pad and S_pad == S:
        return batch
    arr = np.zeros((S_pad,) + batch.shape[1:-1] + (L_pad,), dtype=np.uint8)
    arr[:S, ..., pad:] = batch
    from ..utils import copyaudit
    copyaudit.note("ec.mesh_pad", batch.nbytes)
    return arr


def _mesh_slices(arr: np.ndarray, devices, n_dp: int, n_ls: int,
                 Lp: int) -> list:
    """The padded batch as a dp x ls grid of member tensors."""
    Sd = arr.shape[0] // n_dp
    return [[torch.from_numpy(np.ascontiguousarray(
                arr[i * Sd:(i + 1) * Sd, ..., j * Lp:(j + 1) * Lp])).to(
                    devices[i * n_ls + j])
             for j in range(n_ls)] for i in range(n_dp)]


def _host_rows(grid: list, S: int, pad: int) -> np.ndarray:
    """A dp x ls grid of (Sd, C, Lp) member tensors -> (S, C, L) host
    array: members joined along L, rows along S, pads cut."""
    full = np.concatenate([np.concatenate([t.cpu().numpy() for t in row],
                                          axis=-1) for row in grid])
    return full[:S, ..., pad:]


def make_mesh_encode_crc_fn(matrix: np.ndarray, nbytes: int, devices,
                            n_dp: int = 1, n_ls: int | None = None,
                            compute: str = DEFAULT_COMPUTE,
                            donate: bool = False):
    """Mesh-sharded fused encode + CRC over `devices` (a dp x ls plane).

    Returns run(batch (S, k, L=nbytes) uint8 numpy, keep_resident=False)
    -> (parity (S, m, L) uint8, crcs (S, k+m) uint32, resident), host
    arrays equal to the single-device fused pass's.  resident is None,
    or (dev_data, dev_parity, chunk_pad) as :class:`MeshRows` over the
    members' padded slices when keep_resident is asked and the input
    was not donated (a donated input is released after the kernels)."""
    devices, n_dp, n_ls = mesh_layout(devices, n_dp, n_ls)
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    L = int(nbytes)
    L_pad, Lp, pad = mesh_geometry(L, n_ls)
    local = _encode_crc(matrix, Lp, DEFAULT_CRC_BLOCK, compute, False)
    comb = _slice_combine_matrices(n_ls, Lp)

    def run(batch, keep_resident: bool = False):
        batch = np.asarray(batch, dtype=np.uint8)
        S = batch.shape[0]
        grid = _mesh_slices(_mesh_pad(batch, n_dp, L_pad, pad), devices,
                            n_dp, n_ls, Lp)
        par_grid, rows = [], []
        for row in grid:
            outs = [local(x) for x in row]
            par_grid.append([p for p, _c in outs])
            first = row[0].device
            rows.append(combine_crc_partials(
                [c.to(first) for _p, c in outs], comb))
        crcs = torch.cat([r.to(devices[0]) for r in rows])
        crcs = crcs.view(torch.int32).cpu().numpy().view(np.uint32)[:S]
        parity = _host_rows(par_grid, S, pad)
        resident = None
        if keep_resident and not donate:
            resident = (MeshRows(grid), MeshRows(par_grid), pad)
        return parity, crcs, resident

    run.chunk_pad = pad
    return run


def make_mesh_crc_fn(nbytes: int, devices, n_dp: int = 1,
                     n_ls: int | None = None,
                     compute: str = DEFAULT_COMPUTE):
    """Mesh-sharded CRC32C (seed 0): run(batch (B, nbytes) uint8 numpy)
    -> (B,) uint32, the deep-scrub channel's mega-batch form.  Each
    member folds its slice of every row; the partials combine on the
    plane's first member."""
    devices, n_dp, n_ls = mesh_layout(devices, n_dp, n_ls)
    L = int(nbytes)
    L_pad, Lp, pad = mesh_geometry(L, n_ls)
    local = make_crc_fn(Lp, compute=compute)
    comb = _slice_combine_matrices(n_ls, Lp)

    def run(batch):
        batch = np.asarray(batch, dtype=np.uint8)
        B = batch.shape[0]
        grid = _mesh_slices(_mesh_pad(batch, n_dp, L_pad, pad), devices,
                            n_dp, n_ls, Lp)
        rows = [combine_crc_partials([local(x).to(row[0].device)
                                      for x in row], comb)
                for row in grid]
        out = torch.cat([r.to(devices[0]) for r in rows])
        return out.view(torch.int32).cpu().numpy().view(np.uint32)[:B]

    run.chunk_pad = pad
    return run
