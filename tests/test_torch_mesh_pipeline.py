"""ceph_tpu_torch's mesh dispatch against ceph_tpu's, on the CPU: the
port-side twin of every case of tests/test_mesh_pipeline.py.

The reference's mesh functions run on conftest's 8-device CPU platform;
the port's run on CPU members, in their plain form
(``ec_kernels.make_mesh_*``) and in the form the card runs
(``cuda_ec.mesh_encode_crc`` / ``mesh_crc`` over a ``_MeshRoute`` of CPU
members: the 4 KiB segment chain or the advance-and-XOR combine), from
the same seeded numpy inputs.  The pipeline's mesh mode runs on 8 CPU
lanes (``device_shards``).  Every output is an integer: equality is exact
throughout.

Besides the reference's contracts this holds the port's own: a mesh
failure degrades to row splits on the device lanes, never to the host,
and a pooled arena re-enters the pool only once it was resolved.
"""

import time

import jax
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import ec_kernels as jec_kernels
from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import hbm_cache as jhbm_cache
from ceph_tpu.ops import pipeline as jpipeline
from ceph_tpu_torch.erasure.registry import registry
from ceph_tpu_torch.ops import crc32c as crc_mod
from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf, hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.utils import copyaudit, faults

K, M, L = 3, 2, 256
MATRIX = gf.reed_sol_van_matrix(K, M)
WARM = 120.0
LANES = 8


@pytest.fixture(autouse=True)
def _clean():
    prev = ceph_tpu_torch.set_device("cpu")
    faults.get().reset(seed=0)
    pipe = ec_pipeline.get()
    saved = (pipe.mesh_min_bytes, pipe.device_mesh)
    ec_pipeline.configure(device_shards=LANES)
    yield
    faults.get().reset(seed=0)
    ec_pipeline.configure(mesh_min_bytes=saved[0], device_mesh=saved[1])
    pipe.stop()
    pipe.device_shards = None
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _oracle_encode_crc(matrix, batch):
    parity = np.stack([gf.encode_np(matrix, batch[b])
                       for b in range(batch.shape[0])])
    allc = np.concatenate([batch, parity], axis=1)
    B, km, length = allc.shape
    crcs = crc_mod.crc32c_batch(
        np.ascontiguousarray(allc).reshape(B * km, length)
    ).reshape(B, km).astype(np.uint32)
    return parity, crcs


def _cpu(n):
    return [torch.device("cpu")] * n


def _card_form(matrix, length, n_dp, n_ls):
    """The card's route of the mesh encode and CRC on CPU members."""
    route = cuda_ec._MeshRoute(tuple(_cpu(n_dp * n_ls)), n_dp, n_ls,
                               length)
    return route, cuda_ec.mesh_encode_crc(matrix, route), \
        cuda_ec.mesh_crc(route)


@pytest.mark.parametrize("S,length,n_dp,n_ls", [
    (1, 192, 1, 8),     # minimal batch, L divides evenly
    (5, 250, 1, 8),     # odd S, L % 8 != 0 -> front-padded shards
    (3, 100, 2, 4),     # explicit dp x ls layout, S % dp != 0 too
])
def test_mesh_kernel_bitexact_vs_single_device_and_oracle(
        S, length, n_dp, n_ls):
    """The reference's cases: the port's mesh encode (plain form) equals
    ceph_tpu's mesh encode, the port's single-device fused pass and the
    host oracle."""
    batch = _rand(S * 1000 + length, S, K, length)
    jp, jc, _ = jec_kernels.make_mesh_encode_crc_fn(
        jgf.reed_sol_van_matrix(K, M), length,
        jax.devices()[: n_dp * n_ls], n_dp, n_ls)(batch)
    run = ec_kernels.make_mesh_encode_crc_fn(MATRIX, length,
                                             _cpu(n_dp * n_ls), n_dp, n_ls)
    parity, crcs, res = run(batch)
    assert res is None
    single = cuda_ec.make_encode_crc_fn(MATRIX, length)
    padded = torch.from_numpy(ec_pipeline.pad_batch(batch))
    sp, sc = single(padded)
    hp, hc = _oracle_encode_crc(MATRIX, batch)
    np.testing.assert_array_equal(parity, np.asarray(jp))
    np.testing.assert_array_equal(crcs, np.asarray(jc))
    np.testing.assert_array_equal(parity, hp)
    np.testing.assert_array_equal(crcs, hc)
    np.testing.assert_array_equal(sp[:S].numpy(), hp)
    np.testing.assert_array_equal(
        sc[:S].view(torch.int32).numpy().view(np.uint32), hc)


@pytest.mark.parametrize("S,length,n_dp,n_ls", [
    (5, 4096, 1, 2),    # Lp 2048: slice CRCs advanced and XORed
    (5, 4096, 1, 3),    # L % 3 != 0: front pad 2
    (5, 4096, 2, 2),    # dp x ls, S % dp != 0
    (5, 8192, 1, 2),    # Lp 4096: one segment chain joins the members
    (5, 8192, 2, 2),
    (3, 5000, 1, 4),    # pad 0 but Lp 1250, under one segment
])
def test_mesh_fns_match_reference_at_k8m3(S, length, n_dp, n_ls):
    """k=8 m=3 (BASELINE.md's profile): ceph_tpu's make_mesh_encode_crc_fn
    and make_mesh_crc_fn against the port's plain form and the card's
    route on CPU members, the CRC fn on the encode's k+m chunk rows."""
    matrix = gf.reed_sol_van_matrix(8, 3)
    batch = _rand(S * 31 + length, S, 8, length)
    devs = jax.devices()[: n_dp * n_ls]
    jp, jc, _ = jec_kernels.make_mesh_encode_crc_fn(
        jgf.reed_sol_van_matrix(8, 3), length, devs, n_dp, n_ls)(batch)
    rows = np.concatenate([batch, np.asarray(jp)], axis=1).reshape(
        -1, length)
    jr = np.asarray(jec_kernels.make_mesh_crc_fn(length, devs, n_dp,
                                                 n_ls)(rows))
    route, enc, crc = _card_form(matrix, length, n_dp, n_ls)
    assert route.chain == (route.Lp % 4096 == 0)
    for fn, crc_fn in (
            (ec_kernels.make_mesh_encode_crc_fn(
                matrix, length, _cpu(n_dp * n_ls), n_dp, n_ls),
             ec_kernels.make_mesh_crc_fn(length, _cpu(n_dp * n_ls),
                                         n_dp, n_ls)),
            (enc, crc)):
        parity, crcs, _ = fn(batch)
        np.testing.assert_array_equal(parity, np.asarray(jp))
        np.testing.assert_array_equal(crcs, np.asarray(jc))
        np.testing.assert_array_equal(crc_fn(rows), jr)
    np.testing.assert_array_equal(jr, crc_mod.crc32c_batch(rows))


def test_mesh_keeps_resident_arrays_unless_donated():
    run = ec_kernels.make_mesh_encode_crc_fn(MATRIX, 250, _cpu(LANES), 1,
                                             LANES)
    batch = np.arange(2 * K * 250, dtype=np.uint64).astype(
        np.uint8).reshape(2, K, 250)
    parity, crcs, res = run(batch, keep_resident=True)
    assert res is not None
    dev_data, dev_parity, pad = res
    assert pad == run.chunk_pad and pad > 0
    # the members' slices, gathered, are the padded inputs and parity
    np.testing.assert_array_equal(dev_data.to_host()[:2, :, pad:], batch)
    np.testing.assert_array_equal(dev_parity.to_host()[:2, :, pad:],
                                  parity)
    np.testing.assert_array_equal(
        dev_data.rows(1, 2).select(2).to_host()[:, pad:], batch[1:2, 2])
    donated = ec_kernels.make_mesh_encode_crc_fn(
        MATRIX, 250, _cpu(LANES), 1, LANES, donate=True)
    _p, _c, res2 = donated(batch, keep_resident=True)
    assert res2 is None     # donated input: released after the kernels
    # the card's route keeps the same resident form
    _route, enc, _crc = _card_form(MATRIX, 250, 2, 4)
    p2, _c2, res3 = enc(batch, keep_resident=True)
    np.testing.assert_array_equal(p2, parity)
    np.testing.assert_array_equal(res3[0].to_host()[:2, :, res3[2]:],
                                  batch)


def _drive_until_mesh(codec, batch, stats_key="mesh_dispatches",
                      window=WARM):
    """Submit `batch` until the pipeline serves one via the mesh (the
    mesh runner warms up on a background thread)."""
    pipe = ec_pipeline.get()
    start = pipe.stats()[stats_key]
    end = time.time() + window
    out = None
    while time.time() < end:
        out = codec.encode_stripes_with_crcs_async(batch.copy()) \
            .result(60)
        if pipe.stats()[stats_key] > start:
            return out, pipe.stats()[stats_key] - start
        time.sleep(0.05)
    return out, pipe.stats()[stats_key] - start


class TestMeshDispatchThroughPlugin:
    def _codec(self):
        return registry.factory(
            "tpu", {"k": str(K), "m": str(M),
                    "technique": "reed_sol_van", "host_cutover": "1"})

    def _oracle(self):
        return registry.factory(
            "jerasure", {"k": str(K), "m": str(M),
                         "technique": "reed_sol_van"})

    def test_over_budget_batch_rides_mesh_bitexact(self):
        codec = self._codec()
        ec_pipeline.configure(mesh_min_bytes=1024, device_mesh="auto")
        rng = np.random.default_rng(11)
        batch = rng.integers(0, 256, size=(5, K, L), dtype=np.uint8)
        (allc, crcs), meshed = _drive_until_mesh(codec, batch)
        assert meshed >= 1, ec_pipeline.stats()
        allc_o, crcs_o = self._oracle().encode_stripes_with_crcs(batch)
        np.testing.assert_array_equal(allc, allc_o)
        np.testing.assert_array_equal(crcs, crcs_o)
        st = ec_pipeline.stats()
        assert st["mesh"] == {"dp": 1, "ls": LANES,
                              "lanes": list(range(LANES)),
                              "devices": ["cpu"] * LANES}
        # under the budget: classic lane placement, never the mesh
        small = rng.integers(0, 256, size=(1, K, 16), dtype=np.uint8)
        before = st["mesh_dispatches"]
        codec.encode_stripes_with_crcs_async(small).result(60)
        assert ec_pipeline.stats()["mesh_dispatches"] == before

    @pytest.mark.parametrize("spec,layout", [("2x4", (2, 4)),
                                             ("3", (1, 3))])
    def test_device_mesh_spec_lays_out_the_plane(self, spec, layout):
        codec = self._codec()
        ec_pipeline.configure(mesh_min_bytes=1024, device_mesh=spec)
        batch = _rand(23, 5, K, L)
        (allc, crcs), meshed = _drive_until_mesh(codec, batch)
        assert meshed >= 1
        allc_o, crcs_o = self._oracle().encode_stripes_with_crcs(batch)
        np.testing.assert_array_equal(allc, allc_o)
        np.testing.assert_array_equal(crcs, crcs_o)
        mesh = ec_pipeline.stats()["mesh"]
        assert (mesh["dp"], mesh["ls"]) == layout
        assert ec_pipeline.EcDevicePipeline._parse_mesh_spec(spec, 8) == \
            jpipeline.EcDevicePipeline._parse_mesh_spec(spec, 8)

    def test_one_mesh_member_fault_degrades_to_row_splits(self):
        codec = self._codec()
        ec_pipeline.configure(mesh_min_bytes=1024, device_mesh="auto")
        batch = _rand(13, 5, K, L)
        _out, meshed = _drive_until_mesh(codec, batch)
        assert meshed >= 1
        st0 = ec_pipeline.stats()
        faults.get().tpu_device_error(1.0, device="2")
        allc, crcs = codec.encode_stripes_with_crcs_async(
            batch.copy()).result(60)
        faults.get().reset(seed=0)
        allc_o, crcs_o = self._oracle().encode_stripes_with_crcs(batch)
        np.testing.assert_array_equal(allc, allc_o)
        np.testing.assert_array_equal(crcs, crcs_o)
        st = ec_pipeline.stats()
        assert st["mesh_degrades"] > st0["mesh_degrades"]
        assert st["quarantines"] > st0["quarantines"]
        assert st["devices"]["2"]["quarantined"]
        # the codec must NOT degrade: survivors served the batch
        assert not codec.degraded
        ec_pipeline.get().reset_devices()

    def test_mesh_failure_midflight_requeues_to_row_splits(self):
        """An exception INSIDE the mesh computation drops the plane and
        requeues the batch latched off the mesh: no lane quarantines,
        and the batch is served by the lanes' device fn, not the host
        (the port's rule)."""
        pipe = ec_pipeline.get()
        ec_pipeline.configure(mesh_min_bytes=1)
        calls, host_calls = [], []

        def host_fn(batch):
            host_calls.append(batch.shape)
            return (batch.astype(np.uint16) * 2,)

        def device_fn(padded, device=None):
            return (padded.to(torch.int32) * 2,)

        def mesh_fn(batch, plane, donate=False, keep_resident=False):
            calls.append(batch.shape)
            raise RuntimeError("mesh blew up")

        chan = ec_pipeline.PipelineChannel(
            key=("t", "meshfail"), host_fn=host_fn,
            device_fn=device_fn, route=lambda n: True, mesh_fn=mesh_fn)
        st0 = pipe.stats()
        arr = np.arange(4 * 8, dtype=np.uint64).astype(
            np.uint8).reshape(4, 8)
        path, (out,) = pipe.submit(chan, arr).result(30)
        st = pipe.stats()
        assert calls, "mesh_fn was never tried"
        assert path == "dev" and not host_calls
        np.testing.assert_array_equal(out, arr.astype(np.int32) * 2)
        assert st["mesh_degrades"] > st0["mesh_degrades"]
        assert st["quarantines"] == st0["quarantines"]
        assert st["redrained"] > st0["redrained"]

    def test_mesh_failure_with_no_lane_left_raises(self):
        """The mesh degrades to the lanes, and when their device fn
        fails on every lane the batch raises — never a host serve."""
        pipe = ec_pipeline.get()
        ec_pipeline.configure(mesh_min_bytes=1)
        host_calls = []

        def host_fn(batch):
            host_calls.append(batch.shape)
            return (batch,)

        def device_fn(padded, device=None):
            raise RuntimeError("card gone")

        def mesh_fn(batch, plane, donate=False, keep_resident=False):
            raise RuntimeError("mesh blew up")

        chan = ec_pipeline.PipelineChannel(
            key=("t", "meshdead"), host_fn=host_fn, device_fn=device_fn,
            route=lambda n: True, mesh_fn=mesh_fn)
        fut = pipe.submit(chan, np.zeros((4, 8), dtype=np.uint8))
        with pytest.raises(RuntimeError, match="all quarantined"):
            fut.result(30)
        assert not host_calls
        assert pipe.stats()["mesh_degrades"] >= 1


class TestStagingArenas:
    def test_concurrent_checkouts_never_share_and_reuse_is_zeroed(self):
        pipe = ec_pipeline.EcDevicePipeline(mesh_min_bytes=1024)
        assert pipe.checkout_arena(512) is None     # under the budget
        a1 = pipe.checkout_arena(2048, payload_bytes=2000)
        a2 = pipe.checkout_arena(2048, payload_bytes=2000)
        assert a1 is not None and a2 is not None and a1.pooled
        assert a1.tensor.data_ptr() != a2.tensor.data_ptr()
        ptr1 = a1.tensor.data_ptr()
        a1.buf[:] = 0xAB
        a1.noted = True                 # "the pipeline resolved it"
        a1.release()
        assert a1.buf is None
        a3 = pipe.checkout_arena(2048)
        assert a3.tensor.data_ptr() == ptr1     # pooled reuse...
        assert not a3.buf.any()                 # ...zeroed
        # tail-only zeroing: the caller-owned payload prefix is left for
        # the copy-in, the stripe-padding tail is zeroed
        a3.noted = True
        a3.buf[:] = 0xCD
        a3.release()
        a4 = pipe.checkout_arena(2048, payload_bytes=2000)
        assert a4.tensor.data_ptr() == ptr1
        assert not a4.buf[2000:].any()
        assert a4.buf[:2000].all()

    def test_unresolved_arena_is_dropped_not_recycled(self):
        pipe = ec_pipeline.EcDevicePipeline(mesh_min_bytes=1024)
        a1 = pipe.checkout_arena(2048, payload_bytes=2000)
        ptr1, keep = a1.tensor.data_ptr(), a1.tensor
        assert not (a1.consumed or a1.noted)
        a1.release()
        assert a1.buf is None
        a2 = pipe.checkout_arena(2048)
        assert a2.tensor.data_ptr() != ptr1
        del keep

    def test_arena_with_a_pending_upload_is_dropped(self):
        """A resolved arena whose last upload has not completed yet must
        not be handed out again (a new checkout would overwrite it)."""
        class Pending:
            def query(self):
                return False

        pipe = ec_pipeline.EcDevicePipeline(mesh_min_bytes=1024)
        a1 = pipe.checkout_arena(2048, payload_bytes=2048)
        a1.noted = True
        a1.upload_event = Pending()
        a1.release()
        assert pipe._arena_free == []

    def test_pool_keeps_at_most_arena_pool_max(self):
        pipe = ec_pipeline.EcDevicePipeline(mesh_min_bytes=1024)
        arenas = [pipe.checkout_arena(2048) for _ in range(6)]
        for a in arenas:
            a.consumed = True
            a.release()
        assert len(pipe._arena_free) == ec_pipeline.ARENA_POOL_MAX \
            == jpipeline.ARENA_POOL_MAX

    def test_donated_arena_retires_ec_stage_and_is_not_reread(self):
        codec = registry.factory(
            "tpu", {"k": str(K), "m": str(M),
                    "technique": "reed_sol_van", "host_cutover": "1"})
        ec_pipeline.configure(mesh_min_bytes=1024)
        pipe = ec_pipeline.get()
        batch = _rand(17, 5, K, L)
        end = time.time() + WARM
        donated = False
        while time.time() < end and not donated:
            arena = pipe.checkout_arena(batch.nbytes,
                                        payload_bytes=batch.nbytes)
            assert arena is not None and arena.pooled
            arena.buf[:] = batch.reshape(-1)
            stripes = arena.buf.reshape(batch.shape)
            d0 = pipe.stats()["arena_donations"]
            s0 = copyaudit.snapshot()["sites"].get(
                "ec.stage", {"copies": 0})["copies"]
            h = codec.encode_stripes_with_crcs_async(stripes,
                                                     arena=arena)
            allc, _crcs = h.result(60)
            np.testing.assert_array_equal(allc[:, :K], batch)
            if pipe.stats()["arena_donations"] > d0:
                donated = True
                s1 = copyaudit.snapshot()["sites"].get(
                    "ec.stage", {"copies": 0})["copies"]
                assert s1 == s0, \
                    "donated mesh write must not note ec.stage"
                assert arena.consumed and not arena.noted
            else:
                # not yet warm: the lane serve noted the staging copy
                assert arena.noted and not arena.consumed
            arena.release()
            time.sleep(0.05)
        assert donated, pipe.stats()

    def test_non_mesh_serve_rearms_ec_stage_accounting(self):
        pipe = ec_pipeline.EcDevicePipeline(mesh_min_bytes=64)

        def host_fn(batch):
            return (batch,)

        chan = ec_pipeline.PipelineChannel(key=("t", "rearm"),
                                           host_fn=host_fn)
        arena = pipe.checkout_arena(256, payload_bytes=200)
        arr = arena.buf.reshape(16, 16)
        snap0 = copyaudit.snapshot()
        pipe.submit(chan, arr, arena=arena).result(10)
        snap1 = copyaudit.snapshot()
        pipe.stop()
        s0 = snap0["sites"].get("ec.stage", {"copies": 0, "bytes": 0})
        s1 = snap1["sites"].get("ec.stage", {"copies": 0, "bytes": 0})
        assert s1["copies"] == s0["copies"] + 1
        assert s1["bytes"] == s0["bytes"] + 200
        assert arena.noted and not arena.consumed

    def test_ecutil_mesh_write_uses_and_returns_a_pooled_arena(self):
        """A mesh-sized encode through ecutil stages into a pooled arena,
        equals the host codec, and gives the arena back after the shard
        fan-out; smaller encodes keep the fresh unpooled arenas."""
        codec = registry.factory(
            "tpu", {"k": "4", "m": "2", "technique": "reed_sol_van",
                    "host_cutover": "1"})
        oracle = registry.factory("jerasure", {"k": "4", "m": "2"})
        sinfo = ecutil.StripeInfo(4, 4096)
        payload = _rand(29, 3 * 4 * 4096 - 100).tobytes()
        pipe = ec_pipeline.get()
        ec_pipeline.configure(mesh_min_bytes=1 << 14)
        free0 = len(pipe._arena_free)
        shards, crcs = ecutil.encode_object(codec, sinfo, payload)
        jshards, jcrcs = ecutil.encode_object(oracle, sinfo, payload)
        assert crcs == jcrcs
        assert all(bytes(a) == bytes(b) for a, b in zip(shards, jshards))
        assert len(pipe._arena_free) == free0 + 1


def test_scrub_crc_channel_rides_mesh():
    """Deep-scrub CRC folds over the lane budget ride the mesh too: the
    members' partials combine on the first member."""
    size = 2048
    pipe = ec_pipeline.get()
    ec_pipeline.configure(mesh_min_bytes=1024)
    chan = ec_pipeline.crc_channel(size)
    batch = _rand(19, 4, size)
    want = crc_mod.crc32c_batch(batch)
    start = pipe.stats()["mesh_dispatches"]
    end = time.time() + WARM
    meshed = False
    while time.time() < end and not meshed:
        _path, (out,) = pipe.submit(chan, batch.copy()).result(60)
        np.testing.assert_array_equal(out, want)
        meshed = pipe.stats()["mesh_dispatches"] > start
        time.sleep(0.05)
    assert meshed, pipe.stats()


def test_mesh_resident_cache_entries():
    """A cache-tagged mesh write keeps its stripes split across the
    members: reads unpad (noted as cache.mesh_unpad), shard fetches
    equal the host encode, a quarantine of any member drops the entry,
    and an append does not write through."""
    ec_pipeline.configure(mesh_min_bytes=1024, device_mesh="1x3",
                          hbm_cache_bytes=64 << 20)
    codec = registry.factory(
        "tpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "host_cutover": "1"})
    batch = _rand(37, 5, K, L)
    cache = hbm_cache.get()
    pipe = ec_pipeline.get()
    end = time.time() + WARM
    while time.time() < end:
        intent = hbm_cache.CacheIntent("pg_1.0", "obj", (1, 1),
                                       batch.nbytes, L)
        m0 = pipe.stats()["mesh_dispatches"]
        allc, _crcs = codec.encode_stripes_with_crcs_async(
            batch.copy(), cache=intent).result(60)
        if pipe.stats()["mesh_dispatches"] > m0:
            break
        cache.invalidate("pg_1.0", "obj")
    assert cache.commit("pg_1.0", "obj", (1, 1))
    ent = cache.lookup("pg_1.0", "obj", version=(1, 1))
    assert ent is not None and ent.lane == (0, 1, 2) and ent.pad == 2
    s0 = copyaudit.snapshot()["sites"].get("cache.mesh_unpad",
                                           {"copies": 0})["copies"]
    assert bytes(ent.data_bytes().to_bytes()) == batch.tobytes()
    assert copyaudit.snapshot()["sites"]["cache.mesh_unpad"]["copies"] \
        == s0 + 1
    for shard in range(K + M):
        assert ent.shard_bytes(shard) == \
            np.ascontiguousarray(allc[:, shard]).tobytes()
    assert not cache.append_through("pg_1.0", "obj", (1, 1), (1, 2),
                                    batch.nbytes, L, 5,
                                    batch[:0], allc[:0, K:],
                                    np.zeros((0, K + M), np.uint32))
    assert cache.lookup("pg_1.0", "obj", version=(1, 1)) is None
    codec.encode_stripes_with_crcs_async(
        batch.copy(), cache=hbm_cache.CacheIntent(
            "pg_1.0", "obj", (1, 3), batch.nbytes, L)).result(60)
    assert cache.commit("pg_1.0", "obj", (1, 3))
    cache.drop_lane(2)
    assert cache.lookup("pg_1.0", "obj", version=(1, 3)) is None
