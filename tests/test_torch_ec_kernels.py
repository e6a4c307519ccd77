"""ceph_tpu_torch's plain PyTorch transforms and CUDA-kernel wrappers
against ceph_tpu, on the CPU.

Inputs come from seeded numpy and go through both packages; every
output is an integer, so the tolerance is exact equality.  The Pallas
kernels run in interpret mode.  The CUDA kernels cannot run here: their
host-built parameter blocks are held by numpy emulations of the kernels'
algorithms, and chip_smoke.py holds the kernels themselves on the card.
"""

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import ec_kernels as jek
from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import pallas_ec
from ceph_tpu_torch.ops import crc32c as crc_mod
from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf


@pytest.fixture(autouse=True)
def _cpu_device():
    # one intra-op thread: the suite runs several workers side by side,
    # and these shapes are too small to gain from more
    prev, threads = ceph_tpu_torch.set_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    ceph_tpu_torch.set_device(prev)


def _data(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


SHAPES = [  # (k, m, B, L)
    (8, 3, 2, 1024),
    (8, 3, 3, 1000),       # odd B, L not a multiple of 128
    (2, 1, 1, 256),
    (2, 1, 5, 130),
    (8, 3, 1, 4096),
]


@pytest.mark.parametrize("compute", ["int8", "bf16"])
@pytest.mark.parametrize("k,m,B,L", SHAPES)
def test_codec_fn_matches_jax(k, m, B, L, compute):
    mat = gf.reed_sol_van_matrix(k, m)
    d = _data(k * 1000 + L, B, k, L)
    got = _np(ec_kernels.make_codec_fn(mat, compute=compute)(d))
    want = np.asarray(jek.make_codec_fn(mat)(d))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got[0], jgf.encode_np(mat, d[0]))


def test_codec_fn_two_dim_and_bitmatrix_form():
    mat = gf.reed_sol_van_matrix(4, 2)
    d = _data(7, 4, 512)
    got = _np(ec_kernels.make_codec_fn(mat)(d))
    assert got.shape == (2, 512)
    assert np.array_equal(got, jgf.encode_np(mat, d))
    bits = gf.expand_bitmatrix(mat, 8)
    assert np.array_equal(_np(ec_kernels.make_codec_fn(bits, w=1)(d)), got)
    with pytest.raises(ValueError):
        ec_kernels.make_codec_fn(mat, w=4)


@pytest.mark.parametrize("erased", [(0, 4, 9), (1,), (8, 9, 10)])
def test_decode_rows_match_jax(erased):
    k, m, B, L = 8, 3, 3, 1000
    coding = gf.reed_sol_van_matrix(k, m)
    d = _data(11, B, k, L)
    allc = np.concatenate([d, np.asarray(jek.make_codec_fn(coding)(d))], 1)
    present = [i for i in range(k + m) if i not in erased][:k]
    inv = gf.decode_matrix(gf.systematic_generator(coding, k), k, present)
    surv = np.ascontiguousarray(allc[:, present])
    got = _np(ec_kernels.make_codec_fn(inv)(surv))
    assert np.array_equal(got, np.asarray(jek.make_codec_fn(inv)(surv)))
    assert np.array_equal(got, d)


@pytest.mark.parametrize("compute", ["int8", "bf16"])
@pytest.mark.parametrize("L", [1000, 1024, 4096, 24, 7])
def test_crc_fn_matches_jax(L, compute):
    rows = _data(L, 5, L)
    got = _np(ec_kernels.make_crc_fn(L, compute=compute)(rows))
    assert got.dtype == np.uint32
    assert np.array_equal(got, np.asarray(jek.make_crc_fn(L)(rows)))
    assert np.array_equal(got, crc_mod.crc32c_batch(rows))


def test_crc_fn_batched_lead_dims_and_chaining():
    L = 2048
    chunks = _data(3, 2, 3, L)
    got = _np(ec_kernels.make_crc_fn(L)(chunks))
    assert got.shape == (2, 3)
    assert np.array_equal(got.reshape(-1),
                          crc_mod.crc32c_batch(chunks.reshape(6, L)))
    # seed chaining through the host combine equals one CRC of the join
    a, b = int(got[0, 0]), int(got[0, 1])
    joined = crc_mod.crc32c(0, chunks[0, :2].tobytes())
    assert crc_mod.crc32c_combine(a, b, L) == joined


@pytest.mark.parametrize("k,m,B,L", SHAPES)
def test_encode_crc_and_witness_match_jax(k, m, B, L):
    mat = gf.reed_sol_van_matrix(k, m)
    d = _data(L + B, B, k, L)
    parity, crcs = ec_kernels.make_encode_crc_fn(mat, L)(d)
    jp, jc = jek.make_encode_crc_fn(mat, L)(d)
    assert np.array_equal(_np(parity), np.asarray(jp))
    assert np.array_equal(_np(crcs), np.asarray(jc))
    wit = ec_kernels.make_encode_crc_witness_fn(mat, L)(d)
    assert np.array_equal(_np(wit), np.asarray(
        jek.make_encode_crc_witness_fn(mat, L)(d)))


def test_encode_readback_bytes_identity():
    for args in [(32, 8, 3, 1 << 20), (3, 2, 1, 1000)]:
        assert ec_kernels.encode_readback_bytes(*args) == \
            jek.encode_readback_bytes(*args)


@pytest.mark.parametrize("technique,k,w,packetsize", [
    ("cauchy_good", 4, 8, 16),
    ("cauchy_orig", 3, 8, 8),
])
def test_packet_codec_matches_jax(technique, k, w, packetsize):
    m = 2
    mat = (gf.cauchy_good_matrix if technique == "cauchy_good"
           else gf.cauchy_orig_matrix)(k, m)
    L = w * packetsize * 3
    d = _data(5, 3, k, L)
    got = _np(ec_kernels.make_packet_codec_fn(mat, w, packetsize)(d))
    assert np.array_equal(got, np.asarray(
        jek.make_packet_codec_fn(mat, w, packetsize)(d)))
    bits = gf.expand_bitmatrix(mat, w)
    assert np.array_equal(got[1], gf.bitmatrix_encode_np(
        bits, d[1], w, packetsize))


@pytest.mark.parametrize("name,k,w", [("liberation", 5, 7),
                                      ("blaum_roth", 4, 6),
                                      ("liber8tion", 6, 8)])
def test_bits_codec_matches_jax(name, k, w):
    bits = {"liberation": lambda: gf.liberation_bitmatrix(k, w),
            "blaum_roth": lambda: gf.blaum_roth_bitmatrix(k, w),
            "liber8tion": lambda: gf.liber8tion_bitmatrix(k)}[name]()
    packetsize = 8
    L = w * packetsize * 2
    d = _data(w, 2, k, L)
    for compute in ("int8", "bf16"):
        got = _np(ec_kernels.make_bits_codec_fn(bits, w, packetsize,
                                                compute)(d))
        assert np.array_equal(got, np.asarray(
            jek.make_bits_codec_fn(bits, w, packetsize)(d)))
    assert np.array_equal(got[0], gf.bitmatrix_encode_np(
        bits, d[0], w, packetsize))


# -- the CUDA wrappers' contract, on CPU tensors ---------------------------


@pytest.mark.parametrize("k,m,B,L", [(8, 3, 2, 1024), (2, 1, 3, 256)])
def test_wrappers_match_pallas_interpret(k, m, B, L):
    """cuda_ec keeps pallas_ec's call contract; on CPU tensors the
    wrappers serve the plain versions, held here against the Pallas
    kernels in interpret mode."""
    mat = gf.reed_sol_van_matrix(k, m)
    d = _data(B * L, B, k, L)
    before = dict(cuda_ec.launches)
    parity = _np(cuda_ec.make_encode_fn(mat, L)(d))
    assert np.array_equal(parity, np.asarray(
        pallas_ec.make_encode_fn(mat, L, interpret=True)(d)))
    rows = np.ascontiguousarray(d.reshape(B * k, L))
    crcs = _np(cuda_ec.make_crc_fn(L)(rows))
    assert np.array_equal(crcs, np.asarray(
        pallas_ec.make_crc_fn(L, interpret=True)(rows)))
    fp, fc = cuda_ec.make_encode_crc_fn(mat, L)(d)
    pp, pc = pallas_ec.make_encode_crc_fn(mat, L, interpret=True)(d)
    assert np.array_equal(_np(fp), np.asarray(pp))
    assert np.array_equal(_np(fc), np.asarray(pc))
    # rebuild decode through the same kernel contract
    allc = np.concatenate([d, parity], axis=1)
    present = list(range(m, k + m))
    inv = gf.decode_matrix(gf.systematic_generator(mat, k), k, present)
    surv = np.ascontiguousarray(allc[:, present])
    rebuilt = _np(cuda_ec.make_encode_fn(inv, L)(surv))
    assert np.array_equal(rebuilt, np.asarray(
        pallas_ec.make_encode_fn(inv, L, interpret=True)(surv)))
    assert np.array_equal(rebuilt, d)
    assert cuda_ec.launches == before      # CPU tensors launch nothing


def test_wrappers_ragged_and_two_dim():
    mat = gf.reed_sol_van_matrix(8, 3)
    d = _data(9, 8, 1001)
    parity, crcs = cuda_ec.make_encode_crc_fn(mat, 1001)(d)
    assert parity.shape == (3, 1001) and crcs.shape == (11,)
    assert np.array_equal(_np(parity), jgf.encode_np(mat, d))
    allc = np.concatenate([d, _np(parity)])
    assert np.array_equal(_np(crcs), crc_mod.crc32c_batch(allc))


def test_wrappers_validate_inputs():
    mat = gf.reed_sol_van_matrix(4, 2)
    good = torch.zeros((2, 4, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        cuda_ec.gf_transform(mat, good.to(torch.int32))
    with pytest.raises(ValueError):
        cuda_ec.gf_transform(mat, good[:, :3])          # wrong chunk count
    with pytest.raises(ValueError):
        cuda_ec.gf_transform(mat, good.transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError):
        cuda_ec.crc32c_rows(torch.zeros((2, 0), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cuda_ec.make_encode_crc_fn(mat, 64)(torch.zeros(
            (2, 4, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cuda_ec.make_crc_fn(64)(torch.zeros((2, 32), dtype=torch.uint8))


def test_kernel_sources_and_flags():
    for src in cuda_ec.SOURCES.values():
        text = open(f"{cuda_ec.CSRC_DIR}/{src}").read()
        assert "Replaces ceph_tpu/ops/pallas_ec.py:" in text
        assert "Bound:" in text
    assert "arch=compute_90a,code=sm_90a" in cuda_ec.NVCC_FLAGS
    a, b = cuda_ec.library_path("gf_encode"), cuda_ec.library_path("crc32c")
    assert a != b and a.startswith(cuda_ec.BUILD_DIR)


# -- numpy emulations of the kernels on the wrapper's parameter blocks -----


@pytest.mark.parametrize("coding", [gf.reed_sol_van_matrix(8, 3),
                                    gf.isa_cauchy_matrix(4, 3),
                                    np.array([[0, 1, 2], [3, 0, 255]],
                                             dtype=np.uint8)])
def test_gf_param_block_emulation(coding):
    """gf_encode.cu: out ^= exp[log a + log x], 255 marking log 0."""
    p = cuda_ec.gf_params(coding).astype(np.int64)
    r, c = coding.shape
    log, exp, mlog = p[:256], p[256:768], p[768:].reshape(r, c)
    d = _data(r * c, c, 333)
    out = np.zeros((r, 333), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            if mlog[i, j] == 255:
                continue
            lx = log[d[j]]
            prod = np.where(lx == 255, 0, exp[np.minimum(lx + mlog[i, j],
                                                         511)])
            out[i] ^= prod.astype(np.uint8)
    assert np.array_equal(out, jgf.encode_np(coding, d))


def _advance(cols, x):
    y = 0
    for i in range(32):
        if (x >> i) & 1:
            y ^= int(cols[i])
    return y


def _emulate_crc_row(row, tables, vec):
    """crc32c.cu: per-lane slices (slicing-by-8 when vec), shuffle-tree
    lane combine, chained segment combine, front zero padding."""
    T = tables[:8 * 256].reshape(8, 256)
    adv = tables[8 * 256:].reshape(6, 32)
    seg, lane_bytes = cuda_ec.CRC_SEG, 128
    L = len(row)
    nseg = -(-L // seg)
    pad = nseg * seg - L
    seg_crcs = []
    for s in range(nseg):
        lanes = []
        for lane in range(32):
            a0 = s * seg + lane * lane_bytes - pad
            crc = 0
            if vec:
                for q in range(lane_bytes // 8):
                    a = a0 + 8 * q
                    if a < 0:
                        continue
                    b = row[a:a + 8].astype(np.uint32)
                    lo = int(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24)
                    crc ^= lo
                    crc = (int(T[7][crc & 255]) ^ int(T[6][crc >> 8 & 255])
                           ^ int(T[5][crc >> 16 & 255]) ^ int(T[4][crc >> 24])
                           ^ int(T[3][b[4]]) ^ int(T[2][b[5]])
                           ^ int(T[1][b[6]]) ^ int(T[0][b[7]]))
            else:
                for a in range(max(a0, 0), a0 + lane_bytes):
                    crc = (crc >> 8) ^ int(T[0][(crc ^ int(row[a])) & 255])
            lanes.append(crc)
        for lvl in range(5):
            step = 1 << lvl
            lanes = [_advance(adv[lvl], lanes[i]) ^ lanes[i + step]
                     if i % (2 * step) == 0 else lanes[i]
                     for i in range(32)]
        seg_crcs.append(lanes[0])
    crc = seg_crcs[0]
    for sc in seg_crcs[1:]:
        crc = _advance(adv[5], crc) ^ sc
    return crc


@pytest.mark.parametrize("L,vec", [(1000, False), (4096, True),
                                   (5008, True), (9001, False)])
def test_crc_table_block_emulation(L, vec):
    tables = cuda_ec.crc_tables()
    assert tables.dtype == np.uint32 and tables.size == 8 * 256 + 6 * 32
    row = _data(L, L)
    assert _emulate_crc_row(row, tables, vec) == crc_mod.crc32c(0, row)
