"""ceph_tpu_torch's EC dispatch pipeline against ceph_tpu's, on the CPU.

The port's pipeline runs here on CPU lanes (the package device is set
to "cpu"; ``device_shards`` CPU lanes stand in for the reference's
8-device CPU mesh), so its whole machinery — coalescing, shape buckets,
stagers, collectors, placement, quarantine and redrain — runs on the
plain PyTorch versions of the kernels.  Every output is an integer:
equality is exact (tolerance 0) throughout, transfer counters included.

Besides the reference's contracts (tests/test_pipeline.py) this holds
the port's own rules: a real device error that leaves no lane, a
stalled lane, a result that never comes and a failed warm-up raise —
nothing is served from the host in their place.
"""

import sys
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.erasure.registry import registry as jregistry
from ceph_tpu.ops import hbm_cache as jhbm_cache
from ceph_tpu.ops import pipeline as jpipeline
from ceph_tpu_torch.erasure import plugin_tpu
from ceph_tpu_torch.erasure.registry import registry as tregistry
from ceph_tpu_torch.ops import crc32c as crc_mod
from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf, hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.utils import faults, optracker


@pytest.fixture(autouse=True)
def _cpu_pipeline():
    prev, threads = ceph_tpu_torch.set_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    faults.get().reset(seed=0)
    yield
    faults.get().reset(seed=0)
    # no pipeline thread outlives its test, and no latch leaks on: in
    # either package (the reference's codecs start its pipeline)
    pipe = ec_pipeline.get()
    pipe.stop()
    pipe.device_shards = None
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
    while True:
        got = get_fn()
        if got is not None and got is not False:
            return got
        assert time.monotonic() - t0 < timeout, "device warm-up stuck"
        time.sleep(0.01)


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture
def jax_one_lane():
    """ceph_tpu's shared pipeline on one CPU device, so a shape warmed
    on that device serves every dispatch (the comparisons below then
    see both pipelines take the device path on the same batches)."""
    jpipeline.configure(device_shards=1)
    yield jax.devices()[0]
    jpipeline.configure(device_shards=None)


def _bytes(stats_fn):
    st = stats_fn()
    return st["bytes_h2d"], st["bytes_d2h"]


# ---------------------------------------------------------------------------
# shape buckets and padded device dispatch against ceph_tpu
# ---------------------------------------------------------------------------


def test_next_bucket_and_pad_match_jax():
    for n in (1, 2, 3, 4, 5, 9, 17, 256, 257):
        assert ec_pipeline.next_bucket(n) == jpipeline.next_bucket(n)
    arr = _rand(1, 3, 2, 4)
    assert np.array_equal(ec_pipeline.pad_batch(arr),
                          jpipeline.pad_batch(arr))
    same = np.zeros((4, 2, 4), dtype=np.uint8)
    assert ec_pipeline.pad_batch(same) is same


@pytest.mark.parametrize("B", [1, 3, 5, 9])
@pytest.mark.parametrize("L", [128, 640])
def test_padded_bucket_encode_matches_jax_pipeline(B, L, jax_one_lane):
    """The same stripes through both packages' pipelines, both on the
    device path: identical parity, CRCs, and transfer counters (the
    padded upload, the parity + CRC readback)."""
    k, m = 3, 2
    ours = tregistry.factory("tpu", _profile(k, m))
    theirs = jregistry.factory("tpu", _profile(k, m))
    stripes = _rand(B * 1000 + L, B, k, L)
    shape = (ec_pipeline.next_bucket(B), k, L)
    _wait(lambda: ours.backend.fused_fn_if_ready(ours.coding_matrix,
                                                 shape))
    _wait(lambda: theirs.backend.fused_fn_if_ready(
        theirs.coding_matrix, shape, jax_one_lane))
    t0, j0 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    allc, crcs = ours.encode_stripes_with_crcs(stripes)
    jallc, jcrcs = theirs.encode_stripes_with_crcs(stripes)
    t1, j1 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    assert ours.stat_counters()["device_stripe_passes"] == 1
    assert theirs.stat_counters()["device_stripe_passes"] == 1
    assert np.array_equal(allc, jallc) and np.array_equal(crcs, jcrcs)
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert t1[0] - t0[0] == shape[0] * k * L
    assert t1[1] - t0[1] == ec_kernels.encode_readback_bytes(
        shape[0], k, m, L)


@pytest.mark.parametrize("B", [1, 3, 5])
def test_padded_bucket_decode_matches_jax_pipeline(B, jax_one_lane):
    k, m, L = 4, 2, 4096
    ours = tregistry.factory("tpu", _profile(k, m))
    theirs = jregistry.factory("tpu", _profile(k, m))
    stripes = _rand(B, B, k, L)
    allc, _ = theirs.encode_stripes_with_crcs(stripes)
    want, present = [0, 2], [1, 3, 4, 5]
    stack = np.ascontiguousarray(allc[:, present])
    rows = ours._decode_rows(want, present)
    shape = (ec_pipeline.next_bucket(B), len(present), L)
    _wait(lambda: ours.backend.device_fn_if_ready("bytes", rows, (), shape))
    _wait(lambda: theirs.backend.device_fn_if_ready(
        "bytes", theirs._decode_rows(want, present), (), shape,
        jax_one_lane))
    t0, j0 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    out = ours.decode_batch_async(want, present, stack).result(60)
    jout = np.asarray(theirs.decode_batch_async(want, present,
                                                stack).result(60))
    t1, j1 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    assert np.array_equal(out, jout)
    assert np.array_equal(out, stripes[:, want])
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert t1[0] - t0[0] == shape[0] * len(present) * L


@pytest.mark.parametrize("rows,size", [(3, 64), (7, 4096), (1, 5000)])
def test_crc_channel_matches_jax_crc_channel(rows, size, jax_one_lane):
    arr = _rand(rows * size, rows, size)
    shape = (ec_pipeline.next_bucket(rows), size)
    cpu = torch.device("cpu")
    _wait(lambda: ec_pipeline.crc_fn_if_ready(size, shape, cpu))
    chan, jchan = ec_pipeline.crc_channel(size), jpipeline.crc_channel(size)
    jkey = (size, shape, jpipeline._device_warm_key(jax_one_lane))
    jpipeline.get().submit(jchan, arr).result(60)     # starts the warm-up
    _wait(lambda: jkey in jpipeline._crc_ready)
    t0, j0 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    path, (crcs,) = ec_pipeline.get().submit(chan, arr).result(60)
    jpath, (jcrcs,) = jpipeline.get().submit(jchan, arr).result(60)
    t1, j1 = _bytes(ec_pipeline.stats), _bytes(jpipeline.stats)
    assert path == jpath == "dev"
    assert crcs.dtype == np.uint32
    assert np.array_equal(crcs, np.asarray(jcrcs))
    assert np.array_equal(crcs, crc_mod.crc32c_batch(arr))
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])


# ---------------------------------------------------------------------------
# pipeline mechanics (tests/test_pipeline.py's cases)
# ---------------------------------------------------------------------------


def test_pipeline_coalesces_concurrent_submissions():
    calls = []

    def host_fn(batch):
        calls.append(batch.shape[0])
        return (batch,)

    chan = ec_pipeline.PipelineChannel(key=("t", 1), host_fn=host_fn)
    pipe = ec_pipeline.EcDevicePipeline(depth=1)
    try:
        futs = [pipe.submit(chan, np.full((2, 8), i, dtype=np.uint8))
                for i in range(10)]
        for i, f in enumerate(futs):
            path, (out,) = f.result(timeout=20)
            assert path == "host"
            assert out.shape == (2, 8) and (out == i).all()
        stats = pipe.stats()
        assert stats["ops"] == 10
        assert stats["stripes"] == 20
        assert stats["dispatches"] == len(calls) <= 10
        assert stats["mean_batch_size"] >= 2.0 or len(calls) == 10
    finally:
        pipe.stop()


def test_pipeline_respects_max_coalesce():
    sizes = []

    def host_fn(batch):
        sizes.append(batch.shape[0])
        return (batch,)

    chan = ec_pipeline.PipelineChannel(key=("t", 2), host_fn=host_fn,
                                       max_coalesce=3)
    pipe = ec_pipeline.EcDevicePipeline(depth=1)
    ev = threading.Event()
    try:
        slow = ec_pipeline.PipelineChannel(
            key=("t", "slow"),
            host_fn=lambda b: (ev.wait(10), (b,))[1])
        first = pipe.submit(slow, np.zeros((1, 4), dtype=np.uint8))
        futs = [pipe.submit(chan, np.zeros((2, 4), dtype=np.uint8))
                for _ in range(4)]
        ev.set()
        first.result(timeout=20)
        for f in futs:
            f.result(timeout=20)
        assert sizes and all(s <= 3 for s in sizes)
    finally:
        ev.set()
        pipe.stop()


def _ordered_channels(order, scrub_key, write_key):
    def mk(name):
        def host_fn(batch, _n=name):
            order.append(_n)
            return (batch,)
        return host_fn

    scrub = ec_pipeline.PipelineChannel(
        key=("t", scrub_key), host_fn=mk("scrub"), qos_class="scrub")
    write = ec_pipeline.PipelineChannel(
        key=("t", write_key), host_fn=mk("write"))
    return scrub, write


@pytest.mark.parametrize("weight", [0.25, 1.0])
def test_scrub_yield_and_weight_one_fifo(weight):
    """scrub_weight < 1: the (older) scrub item yields its dispatch slot
    to client-write work and qos_scrub_yields counts it; weight 1
    restores strict FIFO across classes."""
    order = []
    scrub, write = _ordered_channels(order, f"s{weight}", f"w{weight}")
    ev = threading.Event()
    slow = ec_pipeline.PipelineChannel(
        key=("t", f"slow{weight}"),
        host_fn=lambda b: (ev.wait(10), (b,))[1])
    pipe = ec_pipeline.EcDevicePipeline(depth=1, scrub_weight=weight)
    try:
        first = pipe.submit(slow, np.zeros((1, 4), dtype=np.uint8))
        time.sleep(0.1)          # dispatcher wedged inside `slow`
        fs = pipe.submit(scrub, np.zeros((1, 4), dtype=np.uint8))
        time.sleep(0.02)         # scrub item is strictly OLDER
        fw = pipe.submit(write, np.zeros((1, 4), dtype=np.uint8))
        ev.set()
        for f in (first, fs, fw):
            f.result(timeout=20)
        if weight < 1:
            assert order.index("write") < order.index("scrub")
            assert pipe.stats()["qos_scrub_yields"] >= 1
        else:
            assert order.index("scrub") < order.index("write")
            assert pipe.stats()["qos_scrub_yields"] == 0
    finally:
        ev.set()
        pipe.stop()


def test_pipeline_host_error_sets_future_exception():
    def host_fn(batch):
        raise RuntimeError("boom")

    chan = ec_pipeline.PipelineChannel(key=("t", 3), host_fn=host_fn)
    pipe = ec_pipeline.EcDevicePipeline()
    try:
        fut = pipe.submit(chan, np.zeros((1, 4), dtype=np.uint8))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=20)
    finally:
        pipe.stop()


def test_tpu_error_mid_queue_matches_pure_host_codec():
    """Injected untargeted tpu_error lands while encodes are queued:
    every result matches the pure-host codec (and ceph_tpu's) and the
    plugin degrades, not errors — the reference's rule, kept."""
    profile = _profile(3, 2)
    codec = tregistry.factory("tpu", profile)
    oracle = tregistry.factory("jerasure", {"k": "3", "m": "2",
                                            "technique": "reed_sol_van"})
    theirs = jregistry.factory("tpu", profile)
    rng = np.random.default_rng(42)
    batches = [rng.integers(0, 256, size=(B, 3, 256), dtype=np.uint8)
               for B in (1, 3, 2, 5, 1, 4, 2, 3)]
    handles = [codec.encode_stripes_with_crcs_async(b)
               for b in batches[:4]]
    faults.get().tpu_device_error(1.0)     # mid-queue
    handles += [codec.encode_stripes_with_crcs_async(b)
                for b in batches[4:]]
    for arr, h in zip(batches, handles):
        allc, crcs = h.result(timeout=60)
        allc_o, crcs_o = oracle.encode_stripes_with_crcs(arr)
        assert np.array_equal(allc, allc_o)
        assert np.array_equal(crcs, crcs_o)
        jallc, jcrcs = theirs.encode_stripes_with_crcs(arr)
        assert np.array_equal(allc, jallc) and np.array_equal(crcs, jcrcs)
    assert codec.degraded
    assert "device" in codec.degrade_reason


def test_targeted_tpu_error_redrains_to_surviving_lane():
    """`tpu_error 1.0 1` on two CPU lanes: lane 1 quarantines at
    placement, its work redrains to lane 0 bit-exact, and the codec does
    not degrade."""
    ec_pipeline.configure(device_shards=2)
    codec = tregistry.factory("tpu", _profile(3, 2))
    oracle = tregistry.factory("jerasure", {"k": "3", "m": "2",
                                            "technique": "reed_sol_van"})
    shapes = [(b, 3, 256) for b in (1, 2, 4, 8, 16)]
    for shape in shapes:
        _wait(lambda: codec.backend.fused_fn_if_ready(codec.coding_matrix,
                                                      shape))
    q0 = ec_pipeline.stats()["quarantines"]
    faults.get().tpu_device_error(1.0, device="1")
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, size=(B, 3, 256), dtype=np.uint8)
               for B in (1, 2, 3, 4, 1, 2)]
    handles = [codec.encode_stripes_with_crcs_async(b) for b in batches]
    for arr, h in zip(batches, handles):
        allc, crcs = h.result(timeout=60)
        allc_o, crcs_o = oracle.encode_stripes_with_crcs(arr)
        assert np.array_equal(allc, allc_o) and np.array_equal(crcs, crcs_o)
    st = ec_pipeline.stats()
    assert st["quarantines"] == q0 + 1
    assert st["devices"]["1"]["quarantined"]
    assert not st["devices"]["0"]["quarantined"]
    assert st["devices"]["0"]["dispatches"] >= 1
    assert st["devices"]["1"]["dispatches"] == 0
    assert not codec.degraded


def test_real_device_error_redrains_then_raises_when_no_lane_left():
    """A device fn that raises on one of two lanes: that lane
    quarantines and the batch redrains bit-exact to the other.  Once the
    last lane fails too, every affected future raises the error (naming
    the lanes and the channel) and on_error is never called."""
    L = 64
    matrix = gf.reed_sol_van_matrix(3, 2)
    fused = cuda_ec.make_encode_crc_fn(matrix, L)
    bad = {1}

    def device_fn(padded, device=None):
        # the lane's stager thread is named ec-pipeline-stage-<lane>
        lane = int(threading.current_thread().name.rsplit("-", 1)[1])
        if lane in bad:
            raise RuntimeError("gf_encode: CUDA error 700 at launch")
        return fused(padded)

    errors = []
    chan = ec_pipeline.PipelineChannel(
        key=("t", "real"), host_fn=lambda b: (b,), device_fn=device_fn,
        route=lambda n: True, on_error=errors.append)
    pipe = ec_pipeline.EcDevicePipeline(device_shards=2, split_min=64)
    try:
        rng = np.random.default_rng(3)
        for _ in range(4):
            data = rng.integers(0, 256, size=(1, 3, L), dtype=np.uint8)
            path, (parity, crcs) = pipe.submit(chan, data).result(20)
            assert path == "dev"
            assert np.array_equal(parity, gf.encode_np(matrix, data[0])[None])
        st = pipe.stats()
        assert st["quarantines"] == 1 and st["devices"]["1"]["quarantined"]
        assert st["redrained"] >= 1
        bad.add(0)
        fut = pipe.submit(chan, np.zeros((1, 3, L), dtype=np.uint8))
        with pytest.raises(RuntimeError, match="CUDA error 700") as ei:
            fut.result(20)
        assert "lane 0" in str(ei.value) and "'real'" in str(ei.value)
        # every later dispatch raises too: no host serve behind it
        with pytest.raises(RuntimeError, match="all quarantined"):
            pipe.submit(chan, np.zeros((1, 3, L),
                                       dtype=np.uint8)).result(20)
        st = pipe.stats()
        assert st["exhausted_errors"] == 2
        assert st["host_dispatches"] == 0 and not errors
    finally:
        pipe.stop()


def test_never_resolving_future_raises_timeout(monkeypatch):
    """A producer blocked past RESULT_TIMEOUT gets a TimeoutError naming
    the channel (the reference computed the encode on the host)."""
    monkeypatch.setattr(ec_pipeline, "RESULT_TIMEOUT", 0.2)
    codec = tregistry.factory("tpu", _profile(2, 1))
    stripes = _rand(11, 3, 2, 128)
    before = ec_pipeline.stats()["result_timeouts"]
    wedged = plugin_tpu._PipelinedEncode(codec, stripes, Future())
    with pytest.raises(TimeoutError, match="not resolved within"):
        wedged.result()
    rows = codec._decode_rows([0], [1, 2])
    chan = codec._decode_channel([0], [1, 2], rows, 128)
    with pytest.raises(TimeoutError, match="decode"):
        plugin_tpu._PipelinedDecode(Future(), chan).result()
    assert ec_pipeline.stats()["result_timeouts"] == before + 2
    assert codec.stat_counters()["host_stripe_passes"] == 0


def test_stalled_lane_raises_timeout(monkeypatch):
    """A device fetch that HANGS wedges the only lane's collector; once
    the window stays full past STALL_TIMEOUT, device-routed batches fail
    with TimeoutError (the reference latched to the host)."""
    monkeypatch.setattr(ec_pipeline, "STALL_TIMEOUT", 0.2)
    ev = threading.Event()

    class _Blocker:
        device = torch.device("cpu")

        def numpy(self):
            ev.wait(30)
            return np.zeros((1, 4), dtype=np.uint8)

    host_calls = []
    chan = ec_pipeline.PipelineChannel(
        key=("t", 7), host_fn=lambda b: (host_calls.append(1), (b,))[1],
        device_fn=lambda p, device: (_Blocker(),), route=lambda n: True)
    pipe = ec_pipeline.EcDevicePipeline(depth=1, coalesce_wait=0.01,
                                        device_shards=1)
    try:
        f1 = pipe.submit(chan, np.zeros((1, 4), dtype=np.uint8))
        time.sleep(0.1)     # collector picks f1 up and wedges
        f2 = pipe.submit(chan, np.zeros((1, 4), dtype=np.uint8))
        time.sleep(0.1)     # f2 dispatched into the full window
        f3 = pipe.submit(chan, np.full((1, 4), 3, dtype=np.uint8))
        with pytest.raises(TimeoutError, match="lane 0"):
            f3.result(timeout=20)
        st = pipe.stats()
        assert st["stalled"] and st["stall_errors"] >= 1
        assert not host_calls
        ev.set()
        f1.result(timeout=20)
        del f2
    finally:
        ev.set()
        pipe.stop()


def test_failed_crc_warm_up_raises(monkeypatch):
    """A scrub CRC warm-up that fails (no nvcc, no card) is kept and
    raised by every later dispatch of that shape."""
    def no_build(size, *a, **kw):
        raise RuntimeError("nvcc failed: crc32c.cu")

    monkeypatch.setattr(cuda_ec, "make_crc_fn", no_build)
    size = 4096 + 512          # a size no other test warms
    chan = ec_pipeline.crc_channel(size)
    arr = _rand(9, 2, size)
    path, (crcs,) = ec_pipeline.get().submit(chan, arr).result(20)
    assert path == "host"      # cold: the host serves while it warms
    assert np.array_equal(crcs, crc_mod.crc32c_batch(arr))
    t0 = time.monotonic()
    while True:
        try:
            ec_pipeline.get().submit(chan, arr).result(20)
        except RuntimeError as e:
            assert "scrub CRC warm-up" in str(e) and "nvcc failed" in str(e)
            break
        assert time.monotonic() - t0 < 60, "warm-up error never surfaced"
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ec_pipeline.get().submit(chan, arr).result(20)


def test_no_card_raises_instead_of_a_pseudo_lane():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ceph_tpu_torch.set_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_pipeline.DeviceSet()


def test_cpu_lanes_follow_device_shards():
    assert [l.device.type for l in ec_pipeline.DeviceSet().lanes] == ["cpu"]
    ds = ec_pipeline.DeviceSet(3)
    assert [l.index for l in ds.lanes] == [0, 1, 2]
    assert all(l.stream is None for l in ds.lanes)


# ---------------------------------------------------------------------------
# staging arenas, op tracing, launch counts
# ---------------------------------------------------------------------------


def test_arena_checkout_release_and_dropped_on_timeout(monkeypatch):
    """Encodes of ARENA_MIN_BYTES and up stage into a fresh arena (tail
    zeroed) and still equal the host codec; an arena whose producer
    timed out stays with its queued item and is never handed out
    again."""
    monkeypatch.setattr(ec_pipeline, "ARENA_MIN_BYTES", 1 << 16)
    codec = tregistry.factory("tpu", _profile(4, 2))
    sinfo = ecutil.StripeInfo(4, 4096)
    payload = _rand(4, 100_000).tobytes()
    nbytes = sinfo.stripe_count(len(payload)) * sinfo.stripe_width
    checkouts = []
    pipe = ec_pipeline.get()
    real = ec_pipeline.EcDevicePipeline.checkout_arena

    def spy(self, n, plen):
        checkouts.append(real(self, n, plen))
        return checkouts[-1]

    monkeypatch.setattr(ec_pipeline.EcDevicePipeline, "checkout_arena",
                        spy)
    shards, crcs = ecutil.encode_object(codec, sinfo, payload)
    jshards, jcrcs = ecutil.encode_object(
        tregistry.factory("jerasure", {"k": "4", "m": "2"}), sinfo, payload)
    assert crcs == jcrcs
    assert all(bytes(a) == bytes(b) for a, b in zip(shards, jshards))
    assert len(checkouts) == 1 and checkouts[0].buf.nbytes == nbytes
    assert real(pipe, nbytes, len(payload)).buf[len(payload):].sum() == 0
    assert real(pipe, (1 << 16) - 1, 0) is None
    # a never-resolved item: the producer raises, its arena stays with
    # the queued item, and the next checkout gets other memory
    monkeypatch.setattr(ec_pipeline, "RESULT_TIMEOUT", 0.1)
    arena = real(pipe, nbytes, len(payload))
    handle = ecutil.EncodeHandle(
        None, plugin_tpu._PipelinedEncode(
            codec, arena.buf.reshape(-1, 4, 4096), Future()).result_parts)
    with pytest.raises(TimeoutError):
        handle.result()
    again = real(pipe, nbytes, len(payload))
    assert again.tensor.data_ptr() != arena.tensor.data_ptr()


def test_arena_parts_upload_item_by_item():
    """A part whose items all sit in arenas uploads from the arenas, in
    row order; one item outside an arena, or a split-group part, sends
    the part through the lane's buffer."""
    def item(fill, arena=True):
        if not arena:
            return ec_pipeline._Item(np.full((3, 2, 8), fill, np.uint8))
        ar = ec_pipeline.get().checkout_arena(
            ec_pipeline.ARENA_MIN_BYTES, ec_pipeline.ARENA_MIN_BYTES)
        ar.buf[:] = fill
        return ec_pipeline._Item(ar.buf.reshape(-1, 2, 8), arena=ar)

    items = [item(1), item(2)]
    staged = ec_pipeline._Staged(None, items, [it.arr for it in items],
                                 sum(it.n for it in items))
    srcs = ec_pipeline.EcDevicePipeline._arena_pieces(staged)
    assert [int(s[0, 0, 0]) for s in srcs] == [1, 2]
    assert all(s.shape == it.arr.shape for s, it in zip(srcs, items))
    mixed = items + [item(3, arena=False)]
    assert ec_pipeline.EcDevicePipeline._arena_pieces(ec_pipeline._Staged(
        None, mixed, [it.arr for it in mixed], 0)) is None
    group = ec_pipeline._Group(None, items, 2, 0, 0.0)
    assert ec_pipeline.EcDevicePipeline._arena_pieces(ec_pipeline._Staged(
        None, [], [items[0].arr], 0, group)) is None


def _plus_one_channel(key, host_calls, route=lambda n: True):
    """An always-warm device channel whose result (rows + 1) tells it
    apart from its host fn (rows unchanged, counted in host_calls)."""
    return ec_pipeline.PipelineChannel(
        key=key, host_fn=lambda b: (host_calls.append(1), (b,))[1],
        device_fn=lambda padded, device: (padded + 1,), route=route)


def test_one_argument_device_fn_serves_on_the_device():
    """A channel whose device fn takes only the padded batch (the
    reference's older form, ``fn(padded)``) is served on the lane, not
    failed as a device error on every call."""
    host_calls = []
    chan = ec_pipeline.PipelineChannel(
        key=("t", "one-arg"),
        host_fn=lambda b: (host_calls.append(1), (b,))[1],
        device_fn=lambda padded: (padded + 1,), route=lambda n: True)
    pipe = ec_pipeline.EcDevicePipeline(device_shards=1)
    arr = np.arange(8, dtype=np.uint8).reshape(1, 8)
    try:
        path, (out,) = pipe.submit(chan, arr).result(20)
        assert path == "dev" and np.array_equal(out, arr + 1)
        st = pipe.stats()
        assert st["device_errors"] == 0 and st["quarantines"] == 0
        assert not host_calls
    finally:
        pipe.stop()


def test_unset_device_shards_builds_cpu_lanes(monkeypatch):
    """On the CPU an unset device_shards ("all") builds CPU_LANES lanes,
    the count an OSD's pipeline gets from osd_ec_device_shards=all."""
    monkeypatch.setattr(ec_pipeline, "CPU_LANES", 8)
    assert [l.index for l in ec_pipeline.DeviceSet().lanes] == list(range(8))
    assert len(ec_pipeline.DeviceSet(2).lanes) == 2
    pipe = ec_pipeline.EcDevicePipeline()
    try:
        assert pipe.start_lanes() == 8
    finally:
        pipe.stop()


def test_crc_channel_device_error_raises_and_does_not_latch(monkeypatch):
    """A device error on the scrub CRC channel fails the batch with that
    error, and the channel keeps routing to the device: the reference
    latched it to the host fold for good (``_crc_device_dead``)."""
    def broken(size, shape, device):
        def fn(padded):
            raise RuntimeError("crc32c_chain: CUDA error 700 at launch")
        return fn

    monkeypatch.setattr(ec_pipeline, "crc_fn_if_ready", broken)
    chan = ec_pipeline.crc_channel(64)
    pipe = ec_pipeline.EcDevicePipeline(device_shards=1)
    arr = _rand(9, 3, 64)
    try:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            pipe.submit(chan, arr).result(20)
        assert chan.route(64) is True
        assert not hasattr(ec_pipeline, "_crc_device_dead")
        pipe.reset_devices()
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            pipe.submit(chan, arr).result(20)
        assert pipe.stats()["host_dispatches"] == 0
    finally:
        pipe.stop()


def test_route_error_reaches_the_futures():
    """A route callback that raises fails its batch with that error: it
    does not send the batch to the host."""
    host_calls = []

    def route(nbytes):
        raise ValueError("route table gone")

    chan = _plus_one_channel(("t", "route"), host_calls, route)
    pipe = ec_pipeline.EcDevicePipeline()
    try:
        with pytest.raises(ValueError, match="route table gone"):
            pipe.submit(chan, np.zeros((1, 4), np.uint8)).result(20)
        assert not host_calls and pipe.stats()["host_dispatches"] == 0
    finally:
        pipe.stop()


def test_retired_device_set_requeues_not_host_serves(monkeypatch):
    """reset_devices racing a dispatch: the batch placed on the retired
    lanes requeues and runs on the fresh device set, never the host."""
    host_calls = []
    chan = _plus_one_channel(("t", "race"), host_calls)
    pipe = ec_pipeline.EcDevicePipeline(device_shards=1)
    arr = np.arange(8, dtype=np.uint8).reshape(1, 8)
    try:
        assert pipe.submit(chan, arr).result(20)[0] == "dev"
        stale = pipe._devset
        pipe.reset_devices()
        real, calls = pipe._ensure_devset, []

        def racy():
            calls.append(1)
            return stale if len(calls) == 1 else real()

        monkeypatch.setattr(pipe, "_ensure_devset", racy)
        path, (out,) = pipe.submit(chan, arr).result(20)
        assert path == "dev" and np.array_equal(out, arr + 1)
        assert len(calls) >= 2 and not host_calls
        assert pipe.stats()["host_dispatches"] == 0
    finally:
        pipe.stop()


def test_no_free_lane_replans_not_host_serves(monkeypatch):
    """A placement that finds no lane free puts the batch back at the
    queue front and places it again; the host never serves it."""
    host_calls = []
    chan = _plus_one_channel(("t", "replan"), host_calls)
    pipe = ec_pipeline.EcDevicePipeline(device_shards=1)
    real, calls = pipe._plan_locked, []

    def busy_once(ds, S, nbytes=0, bounds=None):
        calls.append(1)
        if len(calls) == 1:
            return [], False
        return real(ds, S, nbytes, bounds)

    monkeypatch.setattr(pipe, "_plan_locked", busy_once)
    arr = np.full((2, 8), 7, dtype=np.uint8)
    try:
        path, (out,) = pipe.submit(chan, arr).result(20)
        assert path == "dev" and np.array_equal(out, arr + 1)
        st = pipe.stats()
        assert st["replans"] == 1 and st["redrained"] == 0
        assert st["host_dispatches"] == 0 and not host_calls
    finally:
        pipe.stop()


class _Clock:
    def now(self):
        return time.monotonic()


def test_traced_write_carries_pipeline_spans():
    codec = tregistry.factory("tpu", _profile(4, 2))
    sinfo = ecutil.StripeInfo(4, 4096)
    payload = _rand(6, 3 * 4 * 4096).tobytes()
    _wait(lambda: codec.backend.fused_fn_if_ready(codec.coding_matrix,
                                                  (4, 4, 4096)))
    tracker = optracker.OpTracker(_Clock())
    op = tracker.create("ec write", trace_id="client.0:1")
    with optracker.op_context(op):
        shards, _ = ecutil.encode_object(codec, sinfo, payload)
        kept = {i: bytes(s) for i, s in enumerate(shards) if i not in (0,)}
        assert bytes(ecutil.decode_object(codec, sinfo, kept,
                                          len(payload))) == payload
    op.finish()
    names = [s["name"] for s in op.dump()["spans"]]
    for want in ("ec.coalesce", "ec.stage_h2d", "ec.device_compute",
                 "ec.d2h"):
        assert want in names, names


def test_launch_counts_are_thread_safe():
    """Lanes bump the counts from their own threads: no lost update."""
    cuda_ec.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                cuda_ec._count_launch("crc32c_chain")

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert cuda_ec.launch_counts()["crc32c_chain"] == 16 * 2000
    cuda_ec.reset_launches()
    assert set(cuda_ec.launch_counts().values()) == {0}
