"""The reference is checked, not trusted: fixed vectors, the algebra's
own properties, and, at small sizes, the port's host codec."""

import itertools

import numpy as np
import pytest

from ecbench.reference import (Profile, control, crc32c, encode_object,
                               gf256, read_object)


def test_gf256_fixed_vectors():
    assert gf256.mul(2, 0x80) == 0x1D          # x^8 = x^4+x^3+x^2+1
    assert gf256.mul(3, 7) == 9                # (x+1)(x^2+x+1) = x^3+1
    assert gf256.mul(0, 0xAB) == 0 and gf256.mul(1, 0xAB) == 0xAB
    for a in range(1, 256):
        assert gf256.mul(a, gf256.inv(a)) == 1


def test_reed_sol_van_is_systematic_mds_with_an_xor_row():
    for k, m in ((8, 3), (2, 1), (4, 2), (6, 3)):
        c = gf256.reed_sol_van(k, m)
        assert c.shape == (m, k)
        assert np.all(c[0] == 1)
        assert gf256.is_mds(c)


def test_reed_sol_van_equals_the_ports_on_disk_format():
    from ceph_tpu_torch.ops import gf
    for k, m in ((8, 3), (2, 1), (4, 2), (12, 4)):
        assert np.array_equal(gf256.reed_sol_van(k, m),
                              gf.reed_sol_van_matrix(k, m))


def test_crc32c_fixed_vectors():
    assert crc32c.crc(0xFFFFFFFF, b"123456789") ^ 0xFFFFFFFF == 0xE3069283
    assert crc32c.crc(0xFFFFFFFF, bytes(32)) ^ 0xFFFFFFFF == 0x8A9136AA
    assert crc32c.crc(0, b"") == 0


@pytest.mark.parametrize("L", [4096, 1000, 37, 1 << 16])
def test_crc_rows_equals_bytewise_and_the_ports(L):
    from ceph_tpu_torch.ops import crc32c as port_crc
    rows = np.random.default_rng(L).integers(0, 256, (5, L), dtype=np.uint8)
    got = crc32c.crc_rows(rows)
    assert [int(x) for x in got] == [crc32c.crc(0, r) for r in rows]
    assert np.array_equal(got, port_crc.crc32c_batch(rows))


@pytest.mark.parametrize("nbytes", [8 * 4096 * 3, 8 * 4096 * 3 - 1234])
def test_encode_object_equals_the_ports_host_codec(nbytes, cpu_port):
    """Shards and HashInfo-order CRCs of the port's NumPy codec (no
    device) at a small size, a tail stripe padded with zeros included."""
    from ceph_tpu_torch.erasure.registry import registry
    from ceph_tpu_torch.ops import crc32c as port_crc
    payload = np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    p = Profile("reed_sol_van", 8, 3, 4096)
    shards, crcs = encode_object(p, payload)
    codec = registry.factory("jerasure", {"technique": "reed_sol_van",
                                          "k": "8", "m": "3"})
    buf = np.zeros(shards.shape[1] * 8, dtype=np.uint8)
    buf[:nbytes] = np.frombuffer(payload, dtype=np.uint8)
    stripes = buf.reshape(-1, 8, 4096)
    parity = codec.encode_batch(stripes) if hasattr(codec, "encode_batch") \
        else np.stack([codec.encode_chunks(s) for s in stripes])
    allc = np.concatenate([stripes, np.asarray(parity)], axis=1)
    assert np.array_equal(shards, allc.transpose(1, 0, 2).reshape(11, -1))
    S = allc.shape[0]
    assert np.array_equal(
        crcs, port_crc.crc32c_batch(allc.reshape(S * 11, 4096)).reshape(S, 11))


def test_read_object_from_any_k_shards():
    p = Profile("reed_sol_van", 8, 3, 4096)
    payload = np.random.default_rng(3).integers(
        0, 256, 8 * 4096 * 2 + 77, dtype=np.uint8)
    shards, _ = encode_object(p, payload.tobytes())
    for lost in itertools.combinations(range(11), 3):
        have = {c: shards[c].tobytes() for c in range(11) if c not in lost}
        assert np.array_equal(read_object(p, have, payload.size), payload)


def test_controls_break_their_guarantee():
    p = Profile("reed_sol_van", 8, 3, 4096)
    payload = np.random.default_rng(4).integers(
        0, 256, 8 * 4096 * 2, dtype=np.uint8).tobytes()
    ref, ref_crcs = encode_object(p, payload)
    bad, bad_crcs = control.encode_xor_parity(p, payload)
    assert np.array_equal(bad[:9], ref[:9])          # data and XOR row
    assert not np.array_equal(bad[9:], ref[9:])
    assert not np.array_equal(bad_crcs, ref_crcs)
    have = {c: ref[c] for c in range(11) if c != 5}
    out = control.read_without_decode(p, have, len(payload))
    assert not np.array_equal(out, np.frombuffer(payload, dtype=np.uint8))
