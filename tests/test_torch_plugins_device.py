"""The jerasure, isa, shec and lrc codecs of ceph_tpu_torch on their
device branch, held against ceph_tpu's, on the CPU.

BASELINE.md configs #1-#5, each under its own plugin, at payloads of 64
KiB and more: under that size TorchBackend always serves the host, so
the plugins' device branch (apply_bytes / apply_packets) never runs
there.  Each codec's routing is pinned to the device (host_cutover 1 on
its TorchBackend, ceph_tpu's TpuBackend pinned the same way), and the
port's device branch runs the plain PyTorch versions on the CPU device.
Tolerance 0: every output is a byte.
"""

import itertools
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.erasure.registry import registry as jregistry
from ceph_tpu.ops import hbm_cache as jhbm_cache
from ceph_tpu.ops import pipeline as jpipeline
from ceph_tpu_torch.erasure.interface import ErasureCodeError
from ceph_tpu_torch.erasure.registry import registry as tregistry
from ceph_tpu_torch.ops import hbm_cache
from ceph_tpu_torch.ops import pipeline as tpipeline

# (plugin, profile) of BASELINE.md configs #1-#5
CONFIGS = [
    pytest.param("jerasure", {"k": "2", "m": "1",
                              "technique": "reed_sol_van"},
                 id="1-jerasure-reed_sol_van-k2m1"),
    pytest.param("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"},
                 id="2-isa-reed_sol_van-k8m3"),
    pytest.param("jerasure", {"k": "6", "m": "3",
                              "technique": "cauchy_good",
                              "packetsize": "32"},
                 id="3-jerasure-cauchy_good-k6m3"),
    pytest.param("shec", {"k": "8", "m": "4", "c": "3"},
                 id="4-shec-k8m4c3"),
    pytest.param("lrc", {"k": "4", "m": "2", "l": "3"},
                 id="5-lrc-k4m2l3"),
]
BATCH = (4, 16 << 10)            # (stripes, chunk bytes) of a batch
STRIPE = 64 << 10                # chunk bytes of one stripe
DEVICE_MIN = 64 << 10            # TorchBackend.MIN_DEVICE_BYTES
WARM_TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _cpu_device():
    prev, threads = ceph_tpu_torch.set_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tpipeline.get().stop()
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    torch.set_num_threads(threads)
    ceph_tpu_torch.set_device(prev)


def _pinned(plugin, profile):
    """The port's codec and ceph_tpu's, each with its measured router
    pinned to the device branch; (ours, our backend, theirs, theirs')."""
    ours = tregistry.factory(plugin, dict(profile))
    theirs = jregistry.factory(plugin, dict(profile))
    be = ours.device_backend()
    jbe = theirs._backend if plugin == "lrc" else theirs.backend
    be.HOST_CUTOVER_BYTES = jbe.HOST_CUTOVER_BYTES = 1
    return ours, be, theirs, jbe


def _samples(be, path: str) -> int:
    return sum(e["n"] for (p, _b), e in list(be._perf.items()) if p == path)


def _on_device(be, call):
    """call() until the backend serves it on its device branch (a cold
    shape is served by the host while its warm-up runs)."""
    end = time.monotonic() + WARM_TIMEOUT
    while True:
        n = _samples(be, "dev")
        out = call()
        if _samples(be, "dev") > n:
            return out
        assert time.monotonic() < end, "device warm-up stuck"
        time.sleep(0.01)


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("plugin,profile", CONFIGS)
def test_encode_on_the_device_branch_matches_jax(plugin, profile):
    ours, be, theirs, jbe = _pinned(plugin, profile)
    k = ours.get_data_chunk_count()
    rng = np.random.default_rng(11)
    S, L = BATCH
    for data in (_u8(rng, (S, k, L)), _u8(rng, (k, STRIPE))):
        want = _on_device(jbe, lambda: np.asarray(theirs.encode_chunks(data)))
        got = _on_device(be, lambda: np.asarray(ours.encode_chunks(data)))
        assert got.shape == want.shape
        assert np.array_equal(got, want), data.shape
    assert _samples(be, "dev") >= 2


@pytest.mark.parametrize("plugin,profile", CONFIGS)
def test_decodes_on_the_device_branch_match_jax(plugin, profile):
    """Every one- and two-chunk erasure ceph_tpu's codec recovers (the
    port's must plan the same chunks) rebuilds ceph_tpu's chunks, on
    one stripe of the least chunk size whose k chunks reach the device
    branch.  jerasure and isa decode through the backend; shec solves,
    and lrc repairs through its host-pinned layers, on the host in both
    packages."""
    ours, be, theirs, _jbe = _pinned(plugin, profile)
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    payload = _u8(np.random.default_rng(12), DEVICE_MIN).tobytes()
    chunks = {i: np.asarray(c) for i, c in
              theirs.encode(range(n), payload).items()}
    size = len(chunks[0])
    assert {len(c) for c in chunks.values()} == {size}
    assert k * size >= DEVICE_MIN
    via_backend = plugin in ("jerasure", "isa")
    decoded = 0
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            avail = [i for i in range(n) if i not in lost]
            try:
                plan = theirs.minimum_to_decode(lost, avail)
            except Exception:
                with pytest.raises(ErasureCodeError):
                    ours.minimum_to_decode(lost, avail)
                continue
            assert ours.minimum_to_decode(lost, avail) == plan, lost
            have = {i: chunks[i] for i in avail}

            def decode():
                return ours.decode(list(lost), have, size)

            got = _on_device(be, decode) if via_backend else decode()
            for c in lost:
                assert np.array_equal(np.asarray(got[c]), chunks[c]), \
                    (lost, c)
            decoded += 1
    assert decoded >= n
    if via_backend:
        assert _samples(be, "dev") >= decoded


@pytest.mark.parametrize("plugin,profile", CONFIGS)
def test_device_shapes_are_what_the_osd_path_sends(plugin, profile):
    """Warm the codec's device_shapes (what the OSD's `ec warm` warms);
    then the OSD path's calls, the whole-object encode and the stripe
    by stripe decodes of 1..m lost chunks, ask the backend for exactly
    those shapes, all warm: none is served by the host."""
    ours, be, _theirs, _jbe = _pinned(plugin, profile)
    n, k = ours.get_chunk_count(), ours.get_data_chunk_count()
    S, L = BATCH
    shapes = ours.device_shapes([S], L)
    warmed = {(s.kind, s.matrix.shape, s.extra, s.shape) for s in shapes}
    for s in shapes:
        end = time.monotonic() + WARM_TIMEOUT
        while s.backend.device_fn_if_ready(s.kind, s.matrix, s.extra,
                                           s.shape) is None:
            assert time.monotonic() < end, "device warm-up stuck"
            time.sleep(0.01)
    asked = set()
    ready = be.device_fn_if_ready

    def spy(kind, matrix, extra, shape, device=None):
        asked.add((kind, matrix.shape, tuple(extra), tuple(shape)))
        return ready(kind, matrix, extra, shape, device)

    be.device_fn_if_ready = spy
    host = _samples(be, "host")
    stripes = _u8(np.random.default_rng(13), (S, k, L))
    allc, _crcs = ours.encode_stripes_with_crcs(stripes)
    for r in range(1, n - k + 1):
        lost = list(range(r))
        try:
            ours.minimum_to_decode(lost, range(r, n))
        except ErasureCodeError:
            continue
        for s in range(S):
            got = ours.decode_chunks(
                lost, {i: allc[s, i] for i in range(r, n)})
            for c in lost:
                assert np.array_equal(got[c], allc[s, c])
    assert asked == warmed
    assert _samples(be, "host") == host
