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


def _host_copies(monkeypatch) -> list:
    calls = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        calls.append(self.shape)
        return cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    return calls


@pytest.mark.parametrize("make", [
    lambda m: ec_kernels.make_codec_fn(m),
    lambda m: ec_kernels.make_encode_crc_fn(m, 256),
    lambda m: ec_kernels.make_encode_crc_witness_fn(m, 256),
    lambda m: cuda_ec.make_encode_fn(m),
    lambda m: cuda_ec.make_encode_crc_fn(m, 256),
    lambda m: (lambda d: ec_kernels.make_crc_fn(256)(d.reshape(-1, 256))),
    lambda m: (lambda d: cuda_ec.make_crc_fn(256)(d.reshape(-1, 256))),
], ids=["codec", "encode_crc", "witness", "cuda_encode", "cuda_encode_crc",
        "crc", "cuda_crc"])
def test_numpy_input_results_come_back_to_the_host(make, monkeypatch):
    """A numpy batch moves to the package device and its results come
    back to the host, as a JAX array given to np.asarray does (the
    reference's tests read results that way); a tensor keeps its
    results where they are."""
    fn = make(gf.reed_sol_van_matrix(3, 2))
    data = np.random.default_rng(3).integers(0, 256, (2, 3, 256),
                                             dtype=np.uint8)
    calls = _host_copies(monkeypatch)
    fn(torch.from_numpy(data))
    assert calls == []
    out = fn(data)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(calls) == len(outs)
    assert all(o.device.type == "cpu" for o in outs)


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


@pytest.mark.parametrize("L", [1000, 4096, 9001, 33 * 4096 + 5])
def test_crc_pass_wrappers_match_jax(L):
    """crc32c.cu's two passes as wrappers: segment CRCs, then the chain
    back to row CRCs, held against ceph_tpu's CRC of the whole row."""
    rows = torch.from_numpy(_data(L + 1, 3, L))
    before = dict(cuda_ec.launches)
    seg = cuda_ec.crc32c_segments(rows)
    assert seg.dtype == torch.uint32 and seg.shape == (3, -(-L // 4096))
    got = _np(cuda_ec.crc32c_chain(seg))
    assert np.array_equal(got, np.asarray(jek.make_crc_fn(L)(rows.numpy())))
    assert np.array_equal(_np(seg[:, -1]), crc_mod.crc32c_batch(
        np.ascontiguousarray(rows.numpy()[:, -min(L, 4096):])))
    assert cuda_ec.launches == before
    with pytest.raises(TypeError):
        cuda_ec.crc32c_chain(seg.view(torch.int32))


@pytest.mark.parametrize("k,m,B,L", [(8, 3, 2, 4096), (4, 2, 3, 9001)])
def test_gf_encode_segment_crcs_matches_jax(k, m, B, L):
    """gf_encode.cu's fused mode as a wrapper: parity, and segment CRCs
    of data then parity rows that chain to ceph_tpu's HashInfo CRCs."""
    mat = gf.reed_sol_van_matrix(k, m)
    d = _data(L * k, B, k, L)
    parity, seg = cuda_ec.gf_encode_segment_crcs(mat, torch.from_numpy(d))
    assert seg.shape == (B, k + m, -(-L // 4096))
    jp, jc = jek.make_encode_crc_fn(mat, L)(d)
    assert np.array_equal(_np(parity), np.asarray(jp))
    crcs = cuda_ec.crc32c_chain(seg.reshape(B * (k + m), -1))
    assert np.array_equal(_np(crcs).reshape(B, k + m), np.asarray(jc))


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


def _segments(rows, seg):
    """(R, L) -> (R, nseg, seg): segments counted from the row's end, the
    first front-padded with zeros, as both kernels stage them."""
    R, L = rows.shape
    nseg = -(-L // seg)
    padded = np.zeros((R, nseg * seg), dtype=np.uint8)
    padded[:, nseg * seg - L:] = rows
    return padded.reshape(R, nseg, seg)


def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of y:x, sign-replicated when bit 3 of that nibble is
    set."""
    x, y, sel = np.broadcast_arrays(*(np.asarray(a, dtype=np.uint32)
                                      for a in (x, y, sel)))
    src = np.stack([(z >> np.uint32(8 * i)) & np.uint32(255)
                    for z in (x, y) for i in range(4)])
    out = np.zeros(x.shape, dtype=np.uint32)
    for i in range(4):
        nib = (sel >> np.uint32(4 * i)) & np.uint32(15)
        val = np.take_along_axis(
            src, (nib & np.uint32(7)).astype(np.int64)[None], 0)[0]
        val = np.where(nib & 8, np.where(val & 0x80, 255, 0), val)
        out |= val.astype(np.uint32) << np.uint32(8 * i)
    return out


def _gf_segment(tables, staged, r):
    """gf_encode.cu on one staged segment (c, n), n % 16 == 0: the input
    words go in pairs (wa, wb) of each 16 bytes; one PRMT selector holds
    the 3-bit indices of two bytes of both, the three PRMT product
    lookups per row are XORed into interleaved accumulators, and unpair()
    restores word order."""
    c = staged.shape[0]
    words = np.ascontiguousarray(staged).view("<u4").reshape(c, -1, 2, 2)
    wa, wb = words[..., 0], words[..., 1]              # (c, n/16, 2)
    u32 = np.uint32
    sa = (wa & u32(0x07070707)) | ((wb & u32(0x07070707)) << u32(4))
    sb = ((wa >> u32(3)) & u32(0x07070707)) | ((wb << u32(1))
                                             & u32(0x70707070))
    sc = ((wa >> u32(6)) & u32(0x03030303)) | ((wb >> u32(2))
                                             & u32(0x30303030))
    out = np.zeros((r,) + wa.shape[1:] + (2,), dtype=np.uint32)
    for j in range(c):
        for i in range(r):
            t = tables[i, j]
            for h in range(2):
                out[i, ..., h] ^= (
                    _byte_perm(t[0], t[1], sa[j] >> u32(16 * h))
                    ^ _byte_perm(t[2], t[3], sb[j] >> u32(16 * h))
                    ^ _byte_perm(t[4], u32(0), sc[j] >> u32(16 * h)))
    x, y = out[..., 0], out[..., 1]
    words_out = np.stack([_byte_perm(x, y, u32(0x6420)),
                          _byte_perm(x, y, u32(0x7531))], axis=-1)
    return np.ascontiguousarray(words_out).reshape(r, -1).view(np.uint8)


def _gf_emulate(matrix, data):
    """The plain kernel: 16-byte pieces, a ragged tail loaded as zeros and
    stored masked."""
    r, c = matrix.shape
    tables = cuda_ec.gf_params(matrix)
    assert tables.dtype == np.uint32 and tables.shape == (r, c, 8)
    L = data.shape[1]
    padded = np.zeros((c, -(-L // 16) * 16), dtype=np.uint8)
    padded[:, :L] = data
    return _gf_segment(tables, padded, r)[:, :L]


@pytest.mark.parametrize("coding", [
    gf.reed_sol_van_matrix(8, 3),
    gf.isa_cauchy_matrix(4, 3),
    np.array([[0, 1, 2], [3, 0, 255]], dtype=np.uint8),   # zero coefficients
    gf.reed_sol_van_matrix(4, 6),                          # two row groups
    np.random.default_rng(9).integers(0, 3, (9, 5)).astype(np.uint8) * 91,
])
def test_gf_param_block_emulation(coding):
    """gf_encode.cu: the byte-permute product tables reproduce the GF(2^8)
    product, r > 4 and zero coefficients included, ragged L too."""
    for L in (333, 4096, 9001):
        d = _data(coding.size + L, coding.shape[1], L)
        assert np.array_equal(_gf_emulate(coding, d),
                              jgf.encode_np(coding, d))


def test_gf_layout_budget():
    assert cuda_ec.gf_layout(3, 8) == 24 * 32
    assert cuda_ec.gf_layout(3, 8, fused=True) == (
        24 * 32 + 4 * (cuda_ec.CRC_SMEM_WORDS + 2 * 64) + 11 * 4112)
    assert cuda_ec.gf_layout(4, 40, fused=True) <= cuda_ec.GF_SMEM_MAX
    with pytest.raises(ValueError):
        cuda_ec.gf_layout(8, 48, fused=True)
    with pytest.raises(ValueError):
        cuda_ec.gf_layout(100, 100)


def _advance(nib, x):
    """crc_seg.cuh advance(): 8 nibble lookups."""
    y = np.zeros_like(x)
    for i in range(8):
        y ^= nib[i][(x >> np.uint32(4 * i)) & np.uint32(15)]
    return y


def _bits(words):
    """(..., n) uint32 -> (..., 32 n) 0/1, bit i of word j at 32 j + i."""
    w = np.asarray(words, dtype=np.uint32)[..., None]
    return ((w >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        *w.shape[:-2], -1)


def _gather4(w, t):
    x = (w >> np.uint32(t)) & np.uint32(0x11111111)
    x = (x | (x >> np.uint32(3))) & np.uint32(0x03030303)
    x = (x | (x >> np.uint32(6))) & np.uint32(0x000F000F)
    return (x | (x >> np.uint32(12))) & np.uint32(0xFF)


def _crc_range8(ranges, frags):
    """crc_seg.cuh fold_range8() before its tail advance: (G, 8, 512)
    ranges -> (G, 8) CRCs.  The mma.m16n8k256 .b1 products are rebuilt
    from the fragments in the PTX layout, and the parity bits come back
    as the ballots and gather4 do."""
    G = ranges.shape[0]
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    # lane (g, t) loads bytes [128k + 32t, +32) of segment g: w[k][0..7]
    w = np.stack([np.stack([np.ascontiguousarray(
        ranges[:, g[l], 128 * k + 32 * t[l]:128 * k + 32 * t[l] + 32])
        .view("<u4") for k in range(4)], axis=1) for l in lanes],
        axis=1)                                             # (G, 32, 4, 8)
    ballots = {}
    for tile in range(2):
        D = np.zeros((G, 16, 8), dtype=np.int64)
        for sl in range(cuda_ec.CRC_SLICES):
            k, s1 = divmod(sl, 4)
            A = np.zeros((16, 256), dtype=np.int64)
            B = np.zeros((G, 256, 8), dtype=np.int64)
            for l in lanes:
                regs = frags[tile, sl, l]
                k0 = 32 * t[l]
                A[g[l], k0:k0 + 32] = _bits(regs[0:1])
                A[g[l] + 8, k0:k0 + 32] = _bits(regs[1:2])
                A[g[l], 128 + k0:160 + k0] = _bits(regs[2:3])
                A[g[l] + 8, 128 + k0:160 + k0] = _bits(regs[3:4])
                B[:, k0:k0 + 32, g[l]] = _bits(w[:, l, k, 2 * s1:2 * s1 + 1])
                B[:, 128 + k0:160 + k0, g[l]] = _bits(
                    w[:, l, k, 2 * s1 + 1:2 * s1 + 2])
            D += np.einsum("rk,Gkc->Grc", A, B)
        # lane (g, t): d0 = D[g][2t], d1 = D[g][2t+1], d2, d3 rows g + 8
        for j in range(4):
            rows = g + (8 if j >= 2 else 0)
            bit = D[:, rows, 2 * t + (j & 1)] & 1                    # (G, 32)
            ballots[tile, j] = (bit.astype(np.uint32)
                                << lanes.astype(np.uint32)).sum(1)
    out = np.zeros((G, 8), dtype=np.uint32)
    for n in range(8):
        tn, e = n >> 1, n & 1
        for tile in range(2):
            for h in range(2):
                out[:, n] |= (_gather4(ballots[tile, 2 * h + e], tn)
                              << np.uint32(16 * tile + 8 * h)).astype(np.uint32)
    return out


def _fold_segments(segs, tables):
    """crc32c.cu pass 1 on (S, 4096) segments in groups of 8: warp w folds
    its 512-byte range on the tensor cores, advances the result over the
    ranges after it, and the 8 ranges join by XOR."""
    S = segs.shape[0]
    G = -(-S // 8)
    padded = np.zeros((G * 8, cuda_ec.CRC_SEG), dtype=np.uint8)
    padded[:S] = segs
    padded = padded.reshape(G, 8, -1)
    frags = tables[:cuda_ec.CRC_FRAG_WORDS].reshape(2, -1, 32, 4)
    tails = tables[cuda_ec.CRC_FRAG_WORDS:
                   cuda_ec.CRC_SMEM_WORDS].reshape(-1, 8, 16)
    crc = np.zeros((G, 8), dtype=np.uint32)
    for warp in range(cuda_ec.CRC_WARPS):
        x0 = cuda_ec.CRC_RANGE * warp
        part = _crc_range8(padded[:, :, x0:x0 + cuda_ec.CRC_RANGE], frags)
        tail = cuda_ec.CRC_WARPS - 1 - warp
        crc ^= _advance(tails[tail - 1], part) if tail else part
    return crc.reshape(-1)[:S]


def _chain(seg_crc, tables):
    """crc32c.cu's chain pass: lane runs of 2^p segments aligned to the
    row's end, chained with adv_4096, then a shuffle tree with
    adv_{4096 * 2^(p + i)}."""
    N, nseg = seg_crc.shape
    chain = tables[cuda_ec.CRC_SMEM_WORDS:].reshape(-1, 8, 16)
    p = 0
    while (32 << p) < nseg:
        p += 1
    run, lead = 1 << p, (32 << p) - nseg
    crc = np.zeros((N, 32), dtype=np.uint32)
    for lane in range(32):
        for t in range(run):
            s = lane * run + t - lead
            if s >= 0:
                crc[:, lane] = _advance(chain[0], crc[:, lane]) ^ seg_crc[:, s]
    for lvl in range(5):
        s = 1 << lvl
        for lane in range(0, 32, 2 * s):
            crc[:, lane] = _advance(chain[p + lvl], crc[:, lane]) \
                ^ crc[:, lane + s]
    return crc[:, 0]


def _crc_emulate(rows, tables):
    N = rows.shape[0]
    segs = _segments(rows, cuda_ec.CRC_SEG)
    seg_crc = _fold_segments(segs.reshape(-1, cuda_ec.CRC_SEG), tables)
    return _chain(seg_crc.reshape(N, -1), tables)


@pytest.mark.parametrize("L,vec", [(1000, False), (4096, True),
                                   (5008, True), (9001, False),
                                   (33 * 4096 + 5, False)])
def test_crc_table_block_emulation(L, vec):
    """crc32c.cu: staged segments folded on the tensor cores and the tree
    chain, ragged L and a row of more than 32 segments (lane runs of 2)
    included.  `vec` is the kernel's 16-byte staging path (L % 16 == 0);
    both paths stage the same bytes."""
    assert vec == (L % 16 == 0)
    tables = cuda_ec.crc_tables()
    assert tables.dtype == np.uint32
    assert tables.size == 2 * 16 * 32 * 4 + 7 * 128 + 20 * 128
    rows = _data(L, 3, L)
    assert np.array_equal(_crc_emulate(rows, tables),
                          crc_mod.crc32c_batch(rows))


def test_crc_nibble_advance_tables():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    for n in (128, 4096, 4096 << 7):
        nib = cuda_ec.nibble_tables(crc_mod.advance_matrix(n))
        want = [crc_mod.crc32c_combine(int(v), 0, n) for v in x]
        assert _advance(nib, x).tolist() == want


@pytest.mark.parametrize("k,m,B,L", [(8, 3, 2, 4096), (8, 3, 3, 1000),
                                     (4, 2, 2, 9001), (2, 5, 1, 8192 + 48)])
def test_fused_mode_emulation(k, m, B, L):
    """gf_encode.cu's fused mode: each (stripe, segment) stages its k data
    segments, computes the m parity segments beside them and folds all
    k+m segment CRCs into (B, k+m, nseg); the chain pass places row
    CRCs in HashInfo order.  Held against ceph_tpu's fused pass."""
    mat = gf.reed_sol_van_matrix(k, m)
    d = _data(L + k, B, k, L)
    gtab, ctab = cuda_ec.gf_params(mat), cuda_ec.crc_tables()
    nseg = -(-L // cuda_ec.CRC_SEG)
    seg_crc = np.zeros((B, k + m, nseg), dtype=np.uint32)
    parity = np.zeros((B, m, nseg * cuda_ec.CRC_SEG), dtype=np.uint8)
    for b in range(B):
        segs = _segments(d[b], cuda_ec.CRC_SEG)
        for s in range(nseg):
            par = _gf_segment(gtab, segs[:, s], m)
            parity[b, :, s * cuda_ec.CRC_SEG:(s + 1) * cuda_ec.CRC_SEG] = par
            seg_crc[b, :, s] = _fold_segments(
                np.concatenate([segs[:, s], par]), ctab)
    parity = parity[..., nseg * cuda_ec.CRC_SEG - L:]
    crcs = _chain(seg_crc.reshape(B * (k + m), nseg), ctab).reshape(B, k + m)
    jp, jc = jek.make_encode_crc_fn(mat, L)(d)
    assert np.array_equal(parity, np.asarray(jp))
    assert np.array_equal(crcs, np.asarray(jc))
