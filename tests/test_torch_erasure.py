"""ceph_tpu_torch's erasure layer and object path against ceph_tpu, on
the CPU device.

The port's codec comes from its own registry with host_cutover=1, so
its device routing (warm-up, readiness, fused pass, D2H accounting)
runs here on the plain PyTorch versions.  Shard files and CRCs written
by either package's ecutil must decode in the other.  Exact equality
throughout: every output is an integer.
"""

import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.erasure import matrix_codec as jmc
from ceph_tpu.erasure.registry import registry as jregistry
from ceph_tpu.ops import hbm_cache as jhbm_cache
from ceph_tpu.ops import pipeline as jpipeline
from ceph_tpu.osd import ecutil as jecutil
from ceph_tpu_torch.erasure import matrix_codec as tmc
from ceph_tpu_torch.erasure.registry import registry as tregistry
from ceph_tpu_torch.ops import crc32c as crc_mod
from ceph_tpu_torch.ops import ec_kernels, hbm_cache
from ceph_tpu_torch.ops import pipeline as tpipeline
from ceph_tpu_torch.osd import ecutil as tecutil
from ceph_tpu_torch.utils import faults as tfaults


@pytest.fixture(autouse=True)
def _cpu_device():
    # one intra-op thread: the suite runs several workers side by side,
    # and these shapes are too small to gain from more
    prev, threads = ceph_tpu_torch.set_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    # the codec's batches ride the shared pipeline: stop its threads
    # and drop its lanes (and any quarantine) with the test — both
    # packages' pipelines, since the reference's codecs start theirs
    tpipeline.get().stop()
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    torch.set_num_threads(threads)
    ceph_tpu_torch.set_device(prev)


def _profile(k=8, m=3, **extra):
    p = {"k": str(k), "m": str(m), "technique": "reed_sol_van",
         "host_cutover": "1"}
    p.update(extra)
    return p


def _wait(get_fn, timeout=60.0):
    t0 = time.monotonic()
    while get_fn() is None:
        assert time.monotonic() - t0 < timeout, "device warm-up stuck"
        time.sleep(0.01)


def _stripes(seed, S, k, L):
    return np.random.default_rng(seed).integers(0, 256, (S, k, L),
                                                dtype=np.uint8)


def test_registry_names_port_modules():
    import importlib
    reg_mod = importlib.import_module("ceph_tpu_torch.erasure.registry")
    assert set(reg_mod._BUILTIN_PLUGINS) == {"tpu", "jerasure", "isa",
                                             "shec", "lrc"}
    for path in reg_mod._BUILTIN_PLUGINS.values():
        assert path.startswith("ceph_tpu_torch.erasure.")
    codec = tregistry.factory("tpu", _profile())
    assert type(codec).__module__ == "ceph_tpu_torch.erasure.plugin_tpu"
    assert isinstance(codec.backend, tmc.TorchBackend)


@pytest.mark.parametrize("k,m,S,L", [(8, 3, 3, 1024), (2, 1, 5, 256),
                                     (4, 2, 1, 4096)])
def test_fused_device_pass_matches_jax_codec(k, m, S, L):
    ours = tregistry.factory("tpu", _profile(k, m))
    theirs = jregistry.factory("tpu", _profile(k, m))
    stripes = _stripes(S * L, S, k, L)
    be = ours.backend
    _wait(lambda: be.fused_fn_if_ready(ours.coding_matrix,
                                       be.pad_batch(stripes).shape))
    d2h = tpipeline.stats()["bytes_d2h"]
    allc, crcs = ours.encode_stripes_with_crcs(stripes)
    assert ours.stat_counters()["device_stripe_passes"] == 1
    S_pad = be.pad_batch(stripes).shape[0]
    assert tpipeline.stats()["bytes_d2h"] - d2h == \
        ec_kernels.encode_readback_bytes(S_pad, k, m, L)
    jallc, jcrcs = theirs.encode_stripes_with_crcs(stripes)
    assert np.array_equal(allc, jallc)
    assert crcs.dtype == np.uint32 and np.array_equal(crcs, jcrcs)
    assert not ours.degraded


def test_host_path_while_cold_is_bit_identical():
    codec = tregistry.factory("tpu", _profile())
    codec.backend.HOST_CUTOVER_BYTES = 1 << 40       # pin the host path
    stripes = _stripes(1, 2, 8, 512)
    allc, crcs = codec.encode_stripes_with_crcs(stripes)
    assert codec.stat_counters()["host_stripe_passes"] == 1
    jallc, jcrcs = jregistry.factory("tpu", _profile()) \
        .encode_stripes_with_crcs(stripes)
    assert np.array_equal(allc, jallc) and np.array_equal(crcs, jcrcs)


@pytest.mark.parametrize("erased", [(0, 4, 9), (2,), (8, 9, 10)])
def test_decode_batch_matches_jax_codec(erased):
    k, m, S, L = 8, 3, 3, 4096      # over MIN_DEVICE_BYTES
    ours = tregistry.factory("tpu", _profile())
    theirs = jregistry.factory("tpu", _profile())
    stripes = _stripes(7, S, k, L)
    allc, _ = theirs.encode_stripes_with_crcs(stripes)
    want = [i for i in erased if i < k] or [erased[0]]
    present = ours.minimum_to_decode(
        want, [i for i in range(k + m) if i not in erased])
    surv = np.ascontiguousarray(allc[:, present])
    rows = ours._decode_rows(want, present)
    _wait(lambda: ours.backend.device_fn_if_ready(
        "bytes", rows, (), ours.backend.pad_batch(surv).shape))
    h2d = tpipeline.stats()["bytes_h2d"]
    got = ours.decode_batch(want, present, surv)
    assert tpipeline.stats()["bytes_h2d"] > h2d    # went to the device
    assert np.array_equal(got, theirs.decode_batch(want, present, surv))
    assert np.array_equal(got, allc[:, want])


@pytest.mark.parametrize("compute", ["int8", "bf16"])
def test_encode_with_crcs_matches_jax_codec(compute):
    ours = tregistry.factory("tpu", _profile(compute=compute))
    theirs = jregistry.factory("tpu", _profile(compute=compute))
    data = _stripes(3, 2, 8, 1000)
    d2h = ours.backend.bytes_d2h
    p, c = ours.encode_with_crcs(data)
    assert ours.backend.bytes_d2h - d2h == \
        ec_kernels.encode_readback_bytes(2, 8, 3, 1000)
    jp, jc = theirs.encode_with_crcs(data)
    assert np.array_equal(p, np.asarray(jp))
    assert np.array_equal(c, np.asarray(jc))


def test_profile_validation():
    from ceph_tpu_torch.erasure.interface import ErasureCodeError
    with pytest.raises(ErasureCodeError):
        tregistry.factory("tpu", _profile(compute="fp8"))
    with pytest.raises(ErasureCodeError):
        tregistry.factory("tpu", _profile(batch_stripes="0"))
    codec = tregistry.factory("tpu", _profile(batch_stripes="4"))
    assert codec.batch_stripes == 4


def test_injected_device_error_degrades_not_errors():
    codec = tregistry.factory("tpu", _profile(2, 1))
    codec.backend.HOST_CUTOVER_BYTES = None    # measured routing, as in prod
    L = 1 << 16
    data = np.frombuffer(b"ab" * L, dtype=np.uint8).reshape(2, L)
    before = codec.encode_chunks(data.copy())
    events = []
    tregistry.add_health_hook("test", lambda n, r: events.append(n))
    try:
        tfaults.get().tpu_device_error(1.0)
        after = codec.encode_chunks(data.copy())
        assert codec.degraded
        assert isinstance(codec.backend, tmc.NumpyBackend)
        assert np.array_equal(before, after)
        assert events == ["tpu"]
        stripes = _stripes(5, 2, 2, 256)
        allc, crcs = codec.encode_stripes_with_crcs(stripes)
        jallc, jcrcs = jregistry.factory("tpu", _profile(2, 1)) \
            .encode_stripes_with_crcs(stripes)
        assert np.array_equal(allc, jallc) and np.array_equal(crcs, jcrcs)
        assert events == ["tpu"]            # sticky and silent
    finally:
        tfaults.get().clear()
        tregistry.remove_health_hook("test")
        tregistry.degraded.pop("tpu", None)


def test_kernel_error_raises_not_degrades(monkeypatch):
    codec = tregistry.factory("tpu", _profile())
    stripes = _stripes(6, 2, 8, 1024)
    _wait(lambda: codec.backend.fused_fn_if_ready(codec.coding_matrix,
                                                  stripes.shape))

    def boom(*a, **kw):
        raise RuntimeError("gf_encode: CUDA error 700 at launch")

    monkeypatch.setattr(codec.backend, "fused_fn_if_ready",
                        lambda *a: boom)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        codec.encode_stripes_with_crcs(stripes)
    assert not codec.degraded
    assert isinstance(codec.backend, tmc.TorchBackend)
    assert "tpu" not in tregistry.degraded


def test_failed_warm_up_raises_on_later_dispatch(monkeypatch):
    codec = tregistry.factory("tpu", _profile())
    be = codec.backend
    stripes = _stripes(10, 2, 8, 1024)

    def no_build(*a, **kw):
        raise RuntimeError("nvcc failed: gf_encode.cu")

    monkeypatch.setattr(be, "_fn", no_build)
    # the first dispatch starts the warm-up and serves from the host
    allc, crcs = codec.encode_stripes_with_crcs(stripes)
    jallc, jcrcs = jregistry.factory("tpu", _profile()) \
        .encode_stripes_with_crcs(stripes)
    assert np.array_equal(allc, jallc) and np.array_equal(crcs, jcrcs)
    t0 = time.monotonic()
    while True:
        try:
            codec.encode_stripes_with_crcs(stripes)
        except RuntimeError as e:
            assert "nvcc failed" in str(e)
            break
        assert time.monotonic() - t0 < 60, "warm-up error never surfaced"
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        codec.encode_stripes_with_crcs(stripes)     # every later call
    assert codec.stat_counters()["device_stripe_passes"] == 0
    assert not codec.degraded


TECHNIQUE_PROFILES = [
    ("reed_sol_van", 8, 3, None),
    ("reed_sol_r6_op", 4, 2, None),
    ("cauchy_orig", 4, 2, None),
    ("cauchy_good", 6, 3, None),
    ("liberation", 5, 2, 7),
    ("blaum_roth", 4, 2, 6),
    ("liber8tion", 6, 2, 8),
    ("isa_reed_sol_van", 6, 3, None),
    ("isa_cauchy", 4, 3, None),
]


def test_technique_table_is_the_same():
    assert set(tmc.TECHNIQUES) == set(jmc.TECHNIQUES)
    assert {t for t, *_ in TECHNIQUE_PROFILES} == set(tmc.TECHNIQUES)


@pytest.mark.parametrize("technique,k,m,w", TECHNIQUE_PROFILES)
def test_coding_matrix_equality(technique, k, m, w):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    if w is not None:
        prof["w"] = str(w)
    ours = tregistry.factory("tpu", prof)
    theirs = jregistry.factory("tpu", prof)
    assert np.array_equal(ours.coding_matrix, theirs.coding_matrix)
    assert ours.rep == theirs.rep
    if ours.rep == tmc.REP_BITS:
        assert np.array_equal(ours.gen_bits, theirs.gen_bits)
    else:
        assert np.array_equal(ours.generator, theirs.generator)


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("jerasure", {"k": "5", "m": "2", "technique": "liberation",
                  "w": "7"}),
    ("isa", {"k": "6", "m": "3", "technique": "cauchy"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
])
def test_host_plugins_match_jax(plugin, profile):
    ours = tregistry.factory(plugin, profile)
    theirs = jregistry.factory(plugin, profile)
    payload = np.random.default_rng(8).integers(
        0, 256, 50_000, dtype=np.uint8).tobytes()
    n = ours.get_chunk_count()
    got = ours.encode(range(n), payload)
    want = theirs.encode(range(n), payload)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    keep = {i: got[i] for i in range(n) if i not in (0, n - 1)}
    size = len(got[0])
    out = ours.decode(range(ours.get_data_chunk_count()), keep, size)
    for i, chunk in out.items():
        assert np.array_equal(chunk, want[i])


def test_packet_transform_on_device_path():
    be = tmc.TorchBackend()
    be.HOST_CUTOVER_BYTES = 1
    from ceph_tpu_torch.ops import gf
    mat = gf.cauchy_good_matrix(4, 2)
    w, ps = 8, 2048
    chunks = _stripes(9, 2, 4, w * ps * 2)
    _wait(lambda: be.device_fn_if_ready("packets", mat, (w, ps),
                                        chunks.shape))
    got = be.apply_packets(mat, chunks, w, ps)
    # the device sample was recorded
    assert be._perf[("dev", be._bucket(chunks.nbytes))]["n"] == 1
    host = jmc.NumpyBackend().apply_packets(mat, chunks, w, ps)
    assert np.array_equal(got, host)


def _payload(n, seed=4):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("unit,size", [(4096, 100_000), (1 << 16, 700_001)])
def test_ecutil_interchange_both_directions(unit, size):
    k, m = 8, 3
    ours = tregistry.factory("tpu", _profile(k, m))
    theirs = jregistry.factory("tpu", _profile(k, m))
    tinfo, jinfo = tecutil.StripeInfo(k, unit), jecutil.StripeInfo(k, unit)
    payload = _payload(size)
    S = tinfo.stripe_count(size)
    _wait(lambda: ours.backend.fused_fn_if_ready(
        ours.coding_matrix, (1 << (S - 1).bit_length() if S > 1 else 1,
                             k, tinfo.chunk_size)))
    t_shards, t_crcs = tecutil.encode_object(ours, tinfo, payload)
    assert ours.stat_counters()["device_stripe_passes"] == 1
    j_shards, j_crcs = jecutil.encode_object(theirs, jinfo, payload)
    assert t_crcs == j_crcs
    for a, b in zip(t_shards, j_shards):
        assert bytes(a) == bytes(b)
    for c, shard in enumerate(t_shards):
        assert t_crcs[c] == crc_mod.crc32c(0, bytes(shard))
    dropped = (1, 5, 10)
    t_kept = {i: bytes(s) for i, s in enumerate(t_shards) if i not in dropped}
    j_kept = {i: bytes(s) for i, s in enumerate(j_shards) if i not in dropped}
    # ceph_tpu's shards decode in the port, and the port's in ceph_tpu
    assert bytes(tecutil.decode_object(ours, tinfo, j_kept, size)) == payload
    assert bytes(jecutil.decode_object(theirs, jinfo, t_kept, size)) \
        == payload


def test_fold_shard_crcs_matches_jax():
    crcs = np.random.default_rng(2).integers(0, 1 << 32, (6, 11),
                                             dtype=np.uint32)
    for upto in (None, 0, 3):
        assert tecutil.fold_shard_crcs(crcs, 4096, upto) == \
            jecutil.fold_shard_crcs(crcs, 4096, upto)


@pytest.mark.parametrize("unit,size", [(4096, 150_000), (1 << 16, 300_001)])
def test_ecutil_async_through_pipeline_both_directions(unit, size):
    """encode_object_async / decode_object through the port's pipeline
    (device path, cache-tagged, QoS-tagged) against ceph_tpu's, both
    ways: identical shards and stripe CRCs, and either package decodes
    the other's shards with chunks lost."""
    k, m = 8, 3
    ours = tregistry.factory("tpu", _profile(k, m))
    theirs = jregistry.factory("tpu", _profile(k, m))
    tinfo, jinfo = tecutil.StripeInfo(k, unit), jecutil.StripeInfo(k, unit)
    payload = _payload(size, seed=unit)
    S = tinfo.stripe_count(size)
    shape = (tpipeline.next_bucket(S), k, tinfo.chunk_size)
    _wait(lambda: ours.backend.fused_fn_if_ready(ours.coding_matrix, shape))
    hbm_cache.configure(64 << 20)
    intent = hbm_cache.CacheIntent("pg_t", "obj", (1, 1), size,
                                   tinfo.chunk_size)
    t_shards, t_stripe_crcs = tecutil.encode_object_async(
        ours, tinfo, payload, cache=intent, qos="gold").result(60)
    assert ours.stat_counters()["device_stripe_passes"] == 1
    j_shards, j_stripe_crcs = jecutil.encode_object_async(
        theirs, jinfo, payload).result(60)
    assert np.array_equal(t_stripe_crcs, j_stripe_crcs)
    for a, b in zip(t_shards, j_shards):
        assert bytes(a) == bytes(b)
    # the device dispatch left the stripes on the (CPU) lane
    assert hbm_cache.get().commit("pg_t", "obj", (1, 1))
    ent = hbm_cache.get().lookup("pg_t", "obj")
    assert tecutil.fold_shard_crcs(ent.crcs, tinfo.chunk_size) == \
        jecutil.fold_shard_crcs(j_stripe_crcs, jinfo.chunk_size)
    lost = (0, 3, 9)
    rows = ours._decode_rows([0, 3], ours.minimum_to_decode(
        [0, 3], [i for i in range(k + m) if i not in lost]))
    _wait(lambda: ours.backend.device_fn_if_ready(
        "bytes", rows, (), (shape[0], k, tinfo.chunk_size)))
    t_kept = {i: bytes(s) for i, s in enumerate(t_shards) if i not in lost}
    j_kept = {i: bytes(s) for i, s in enumerate(j_shards) if i not in lost}
    dev0 = tpipeline.stats()["dev_dispatches"]
    assert bytes(tecutil.decode_object(ours, tinfo, j_kept, size)) == payload
    assert tpipeline.stats()["dev_dispatches"] == dev0 + 1
    assert bytes(jecutil.decode_object(theirs, jinfo, t_kept, size)) \
        == payload
