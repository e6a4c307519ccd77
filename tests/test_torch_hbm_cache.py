"""ceph_tpu_torch's HBM stripe cache against ceph_tpu's, on the CPU.

The cases of tests/test_hbm_cache.py that do not need the mesh mode:
accounting (stage/commit/lookup, pending budget, LRU, lane drops),
store coherence (transaction op tuples built directly, in the object
store's format, since the store layer is not ported yet) and the
pipeline integration (staging at collect time, the transfer identity,
quarantine drops, cost-aware placement).  The port's entries are
tensors (CPU ones here); ``append_through`` joins the tail with
``torch.cat``.  Where both packages can take the same inputs, the same
sequence runs through ceph_tpu's cache and the results must agree.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import hbm_cache as jhbm_cache
from ceph_tpu.ops import pipeline as jpipeline
from ceph_tpu_torch.erasure.registry import registry as tregistry
from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf, hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.ops.crc32c import crc32c_batch
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.utils import faults

K, M, L = 3, 2, 256
MATRIX = gf.reed_sol_van_matrix(K, M)
VER_KEY = "_v"


@pytest.fixture(autouse=True)
def _clean():
    prev, threads = ceph_tpu_torch.set_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    faults.get().reset(seed=0)
    hbm_cache.configure(64 << 20)
    hbm_cache.get().clear()
    yield
    faults.get().reset(seed=0)
    pipe = ec_pipeline.get()
    pipe.stop()
    pipe.device_shards = None
    hbm_cache.get().clear()
    hbm_cache.configure(64 << 20)
    # the reference's pipeline and cache too: no thread or entry of
    # theirs outlives the test either
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    torch.set_num_threads(threads)
    ceph_tpu_torch.set_device(prev)


def _entry_arrays(rng, S=2):
    data = rng.integers(0, 256, size=(S, K, L), dtype=np.uint8)
    parity = np.stack([gf.encode_np(MATRIX, data[s]) for s in range(S)])
    chunks = np.concatenate([data, parity], axis=1)
    crcs = np.stack([crc32c_batch(chunks[s]) for s in range(S)]) \
        .astype(np.uint32)
    return data, parity, crcs


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.uint8))


def _stage_commit(cache, cid, oid, version, rng, S=2, lane=0):
    data, parity, crcs = _entry_arrays(rng, S)
    intent = hbm_cache.CacheIntent(cid, oid, version, S * K * L, L)
    cache.stage(intent, lane, _t(data), _t(parity), crcs)
    assert cache.commit(cid, oid, version)
    return data, parity, crcs


def _entry_bytes(S=2):
    return S * (K + M) * L + S * (K + M) * 4


class TestAccounting:
    def test_stage_commit_lookup_roundtrip(self):
        rng = np.random.default_rng(1)
        cache = hbm_cache.HbmStripeCache()
        d2h0 = hbm_cache.stats()["bytes_d2h"]
        data, parity, crcs = _stage_commit(cache, "pg_a", "obj",
                                           (1, 1), rng)
        ent = cache.lookup("pg_a", "obj", version=(1, 1))
        assert ent is not None
        assert ent.data_bytes() == data.tobytes()
        for j in range(K):
            assert ent.shard_bytes(j) == data[:, j].tobytes()
        for j in range(M):
            assert ent.shard_bytes(K + j) == parity[:, j].tobytes()
        assert np.array_equal(ent.crcs, crcs)
        assert ent.nbytes == _entry_bytes()
        st = cache.stats()
        assert st["insert"] == 1 and st["hit"] == 1
        assert st["entries"] == 1 and st["pending"] == 0
        # fetches count on the process-wide cache, as in the reference
        assert hbm_cache.stats()["bytes_d2h"] - d2h0 == \
            data.nbytes + (K + M) * 2 * L

    def test_staged_but_uncommitted_never_serves(self):
        rng = np.random.default_rng(2)
        cache = hbm_cache.HbmStripeCache()
        data, parity, crcs = _entry_arrays(rng)
        cache.stage(hbm_cache.CacheIntent("pg_a", "obj", (1, 1),
                                          2 * K * L, L),
                    0, _t(data), _t(parity), crcs)
        assert cache.lookup("pg_a", "obj") is None
        st = cache.stats()
        assert st["miss"] == 1 and st["hit"] == 0
        assert st["pending"] == 1 and st["entries"] == 0

    def test_wrong_version_lookup_misses(self):
        rng = np.random.default_rng(3)
        cache = hbm_cache.HbmStripeCache()
        _stage_commit(cache, "pg_a", "obj", (1, 1), rng)
        assert cache.lookup("pg_a", "obj", version=(1, 2)) is None
        assert cache.lookup("pg_a", "obj", version=(1, 1)) is not None

    def test_pending_entries_respect_byte_budget(self):
        rng = np.random.default_rng(6)
        cache = hbm_cache.HbmStripeCache(capacity=3 * _entry_bytes())
        for i in range(8):
            data, parity, crcs = _entry_arrays(rng)
            cache.stage(hbm_cache.CacheIntent("pg_a", f"o{i}", (1, i),
                                              2 * K * L, L),
                        0, _t(data), _t(parity), crcs)
            st = cache.stats()
            assert st["bytes"] + st["pending_bytes"] <= cache.capacity
        assert cache.stats()["pending"] == 3
        assert not cache.commit("pg_a", "o0", (1, 0))
        assert cache.commit("pg_a", "o7", (1, 7))

    def test_configure_shrink_evicts_immediately(self):
        rng = np.random.default_rng(7)
        cache = hbm_cache.configure(64 << 20)
        for i in range(4):
            _stage_commit(cache, "pg_a", f"o{i}", (1, i + 1), rng)
        big = cache.stats()["bytes"]
        hbm_cache.configure(big // 2)
        st = cache.stats()
        assert st["bytes"] + st["pending_bytes"] <= big // 2
        assert cache.lookup("pg_a", "o3") is not None

    def test_drop_lane_spares_other_lanes_entries(self):
        rng = np.random.default_rng(5)
        cache = hbm_cache.HbmStripeCache()
        data, parity, crcs = _stage_commit(cache, "pg_a", "obj", (1, 1),
                                           rng)                # lane 0
        d2, p2, c2 = _entry_arrays(rng)
        cache.stage(hbm_cache.CacheIntent("pg_a", "obj", (1, 2),
                                          2 * K * L, L),
                    1, _t(d2), _t(p2), c2)                     # lane 1
        cache.drop_lane(1)
        ent = cache.lookup("pg_a", "obj", version=(1, 1))
        assert ent is not None and ent.data_bytes() == data.tobytes()
        assert not cache.commit("pg_a", "obj", (1, 2))
        cache.stage(hbm_cache.CacheIntent("pg_a", "obj", (1, 3),
                                          2 * K * L, L),
                    1, _t(d2), _t(p2), c2)
        cache.drop_lane(0)
        assert cache.lookup("pg_a", "obj", version=(1, 1)) is None
        assert cache.commit("pg_a", "obj", (1, 3))
        ent = cache.lookup("pg_a", "obj", version=(1, 3))
        assert ent is not None and ent.data_bytes() == d2.tobytes()
        assert cache.stats()["lane_drops"] == 2

    def test_commit_wrong_version_rejected(self):
        rng = np.random.default_rng(4)
        cache = hbm_cache.HbmStripeCache()
        data, parity, crcs = _entry_arrays(rng)
        cache.stage(hbm_cache.CacheIntent("pg_a", "obj", (1, 7),
                                          2 * K * L, L),
                    0, _t(data), _t(parity), crcs)
        assert not cache.commit("pg_a", "obj", (1, 8))
        assert cache.lookup("pg_a", "obj") is None

    def test_lru_respects_capacity_and_recency(self):
        rng = np.random.default_rng(5)
        cache = hbm_cache.HbmStripeCache(capacity=3 * _entry_bytes())
        for i in range(3):
            _stage_commit(cache, "pg_a", f"obj{i}", (1, i + 1), rng)
        assert cache.lookup("pg_a", "obj0") is not None
        _stage_commit(cache, "pg_a", "obj3", (1, 4), rng)
        st = cache.stats()
        assert st["bytes"] <= 3 * _entry_bytes()
        assert st["evict"] == 1
        assert cache.lookup("pg_a", "obj1") is None
        assert cache.lookup("pg_a", "obj0") is not None
        assert cache.lookup("pg_a", "obj3") is not None

    @pytest.mark.parametrize("capacity", [16, 0])
    def test_oversized_entry_or_zero_capacity_never_stages(self, capacity):
        rng = np.random.default_rng(6)
        cache = hbm_cache.HbmStripeCache(capacity=capacity)
        data, parity, crcs = _entry_arrays(rng)
        cache.stage(hbm_cache.CacheIntent("pg_a", "big", (1, 1),
                                          2 * K * L, L),
                    0, _t(data), _t(parity), crcs)
        assert not cache.commit("pg_a", "big", (1, 1))
        assert cache.stats()["entries"] == 0

    def test_same_sequence_same_stats_as_jax_cache(self):
        """One stage/commit/lookup/evict/drop sequence through both
        packages' caches: the counters and the served bytes agree."""
        rng = np.random.default_rng(8)
        arrays = [_entry_arrays(rng) for _ in range(5)]
        ours = hbm_cache.HbmStripeCache(capacity=3 * _entry_bytes())
        theirs = jhbm_cache.HbmStripeCache(capacity=3 * _entry_bytes())
        served = {}
        for cache, wrap, tag in ((ours, _t, "t"), (theirs, np.asarray,
                                                   "j")):
            for i, (d, p, c) in enumerate(arrays):
                intent = (hbm_cache if tag == "t" else jhbm_cache) \
                    .CacheIntent("pg", f"o{i}", (1, i), 2 * K * L, L)
                cache.stage(intent, i % 2, wrap(d), wrap(p), c)
                if i != 2:
                    cache.commit("pg", f"o{i}", (1, i))
            cache.lookup("pg", "o1")
            cache.lookup("pg", "o0", version=(9, 9))
            cache.drop_lane(1)
            cache.invalidate("pg", "o4")
            served[tag] = [None if e is None else bytes(e.data_bytes())
                           for e in (cache.lookup("pg", f"o{i}")
                                     for i in range(5))]
        assert served["t"] == served["j"]
        keys = ("hit", "miss", "evict", "insert", "invalidate",
                "lane_drops", "entries", "pending", "bytes",
                "pending_bytes")
        assert {k: ours.stats()[k] for k in keys} == \
            {k: theirs.stats()[k] for k in keys}


class TestAppendThrough:
    def test_append_through_matches_fresh_encode(self):
        """The appended object's entry (resident prefix + uploaded tail,
        joined with torch.cat) equals a fresh encode of the whole
        appended object: data, every shard, the stripe CRCs."""
        cache = hbm_cache.get()
        codec = tregistry.factory("tpu", {"k": str(K), "m": str(M),
                                          "host_cutover": "1"})
        sinfo = ecutil.StripeInfo(K, L)
        rng = np.random.default_rng(31)
        old = rng.integers(0, 256, 2 * K * L, dtype=np.uint8).tobytes()
        new = old + rng.integers(0, 256, K * L + 100,
                                 dtype=np.uint8).tobytes()
        stripes = np.frombuffer(old, dtype=np.uint8).reshape(-1, K, L)
        allc, crcs = codec.encode_stripes_with_crcs(stripes)
        cache.stage(hbm_cache.CacheIntent("pg", "obj", (1, 1), len(old),
                                          L),
                    0, _t(stripes), _t(allc[:, K:]), crcs)
        assert cache.commit("pg", "obj", (1, 1))
        full_before = len(old) // sinfo.stripe_width     # 2 stripes
        buf = np.zeros(sinfo.stripe_count(len(new)) * sinfo.stripe_width,
                       dtype=np.uint8)
        buf[:len(new)] = np.frombuffer(new, dtype=np.uint8)
        tail = buf.reshape(-1, K, L)[full_before:]
        t_allc, t_crcs = codec.encode_stripes_with_crcs(tail)
        assert cache.append_through("pg", "obj", (1, 1), (1, 2), len(new),
                                    L, full_before, tail, t_allc[:, K:],
                                    t_crcs)
        assert cache.commit("pg", "obj", (1, 2))
        ent = cache.lookup("pg", "obj", version=(1, 2))
        assert cache.stats()["append_throughs"] == 1
        shards, stripe_crcs = ecutil.encode_object_async(
            codec, sinfo, new).result(60)
        assert bytes(ent.data_bytes()) == new
        for j in range(K + M):
            assert ent.shard_bytes(j) == bytes(shards[j])
        assert np.array_equal(ent.crcs, stripe_crcs)
        assert ecutil.fold_shard_crcs(ent.crcs, L) == \
            ecutil.fold_shard_crcs(stripe_crcs, L)

    def test_append_through_without_resident_entry_invalidates(self):
        rng = np.random.default_rng(32)
        cache = hbm_cache.HbmStripeCache()
        _stage_commit(cache, "pg", "obj", (1, 1), rng)
        d, p, c = _entry_arrays(rng, S=1)
        # wrong old version: no write-through, and the stale entry goes
        assert not cache.append_through("pg", "obj", (1, 0), (1, 2),
                                        3 * K * L, L, 2, d, p, c)
        assert cache.lookup("pg", "obj") is None


def _write(cid, name, off, data):
    return ("write", cid, name, off, data)


def _ver(cid, name, version):
    return ("setattr", cid, name, VER_KEY, repr(tuple(version)).encode())


class TestStoreCoherence:
    """The object-store hook: transaction ops (the store's tuple format)
    are scanned and un-attested shard-data mutations invalidate."""

    def _cached(self, cid="pg_c", oid="victim", version=(1, 1)):
        rng = np.random.default_rng(11)
        cache = hbm_cache.get()
        _stage_commit(cache, cid, oid, version, rng)
        ops = []
        for j in range(K + M):
            ops += [_write(cid, f"{oid}.s{j}", 0, b"shardbytes"),
                    _ver(cid, f"{oid}.s{j}", version)]
        hbm_cache.note_store_txn(ops)
        assert cache.lookup(cid, oid, version=version) is not None
        return cache

    @pytest.mark.parametrize("op", [
        _write("pg_c", "victim.s1", 2, b"\xbe\xef"),
        _write("pg_c", "victim.s0", 4096, b"tail"),
        ("truncate", "pg_c", "victim.s2", 1),
        ("zero", "pg_c", "victim.s1", 0, 4),
        ("remove", "pg_c", "victim.s3"),
        ("clone", "pg_c", "victim.s0", "victim.s1"),
        ("move", "pg_c", "victim.s0", "pg_c", "stash"),
    ], ids=["overwrite", "append", "truncate", "zero", "remove",
            "clone-onto", "move-away"])
    def test_unattested_mutation_invalidates(self, op):
        cache = self._cached()
        inval0 = cache.stats()["invalidate"]
        hbm_cache.note_store_txn([op])
        assert cache.lookup("pg_c", "victim") is None
        assert cache.stats()["invalidate"] == inval0 + 1

    def test_same_version_fanout_keeps_entry(self):
        cache = self._cached(version=(1, 5))
        hbm_cache.note_store_txn([_write("pg_c", "victim.s2", 0, b"same"),
                                  _ver("pg_c", "victim.s2", (1, 5))])
        assert cache.lookup("pg_c", "victim", version=(1, 5)) is not None

    def test_newer_version_write_invalidates(self):
        cache = self._cached(version=(1, 5))
        hbm_cache.note_store_txn([_write("pg_c", "victim.s2", 0, b"new"),
                                  _ver("pg_c", "victim.s2", (1, 6))])
        assert cache.lookup("pg_c", "victim") is None

    def test_rewrite_keeps_attested_fresh_pending(self):
        cache = self._cached(version=(1, 1))
        rng = np.random.default_rng(12)
        data, parity, crcs = _entry_arrays(rng)
        cache.stage(hbm_cache.CacheIntent("pg_c", "victim", (1, 2),
                                          2 * K * L, L),
                    0, _t(data), _t(parity), crcs)
        ops = []
        for j in range(K + M):
            ops += [_write("pg_c", f"victim.s{j}", 0, b"new bytes"),
                    _ver("pg_c", f"victim.s{j}", (1, 2))]
        hbm_cache.note_store_txn(ops)
        assert cache.lookup("pg_c", "victim", version=(1, 1)) is None
        assert cache.commit("pg_c", "victim", (1, 2))
        ent = cache.lookup("pg_c", "victim", version=(1, 2))
        assert ent is not None and ent.data_bytes() == data.tobytes()

    def test_stash_ops_do_not_invalidate(self):
        cache = self._cached()
        stash = "victim.s0@(1, 0)"
        hbm_cache.note_store_txn([("try_clone", "pg_c", "victim.s0",
                                   stash)])
        assert cache.lookup("pg_c", "victim") is not None
        hbm_cache.note_store_txn([("try_remove", "pg_c", stash)])
        hbm_cache.note_store_txn([_write("pg_c", stash, 0, b"old bytes")])
        assert cache.lookup("pg_c", "victim") is not None
        hbm_cache.note_store_txn([("clone", "pg_c", stash, "victim.s0")])
        assert cache.lookup("pg_c", "victim") is None

    def test_rmcoll_drops_whole_collection(self):
        cache = self._cached()
        hbm_cache.note_store_txn([("rmcoll", "pg_c")])
        assert cache.lookup("pg_c", "victim") is None

    def test_unrelated_objects_and_collections_unaffected(self):
        cache = self._cached()
        hbm_cache.note_store_txn([("mkcoll", "pg_z"),
                                  _write("pg_c", "bystander.s1", 0, b"x"),
                                  _write("pg_z", "victim.s1", 0, b"x")])
        assert cache.lookup("pg_c", "victim") is not None


def _fused_channel(bad_lanes=(), key=("hbm", "enc")):
    """An always-warm fused encode+CRC channel (the plain PyTorch
    version on CPU lanes) whose device fn fails like a dead card on
    the listed lanes."""
    fused = cuda_ec.make_encode_crc_fn(MATRIX, L)

    def device_fn(padded, device=None):
        lane = int(threading.current_thread().name.rsplit("-", 1)[1])
        if lane in bad_lanes:
            raise RuntimeError(f"lane {lane} down")
        return fused(padded)

    def host_fn(batch):
        parity = np.stack([gf.encode_np(MATRIX, batch[s])
                           for s in range(batch.shape[0])])
        chunks = np.concatenate([batch, parity], axis=1)
        crcs = np.stack([crc32c_batch(chunks[s])
                         for s in range(batch.shape[0])])
        return parity, crcs.astype(np.uint32)

    return ec_pipeline.PipelineChannel(
        key=key, host_fn=host_fn, device_fn=device_fn,
        route=lambda n: True)


def _parity(data):
    return np.stack([gf.encode_np(MATRIX, data[s])
                     for s in range(data.shape[0])])


class TestPipelineIntegration:
    def test_encode_stages_entry_and_counts_transfer(self):
        chan = _fused_channel()
        pipe = ec_pipeline.EcDevicePipeline(depth=2, split_min=64,
                                            coalesce_wait=0.001)
        cache = hbm_cache.get()
        rng = np.random.default_rng(21)
        try:
            data = rng.integers(0, 256, size=(3, K, L), dtype=np.uint8)
            intent = hbm_cache.CacheIntent("pg_p", "obj", (3, 9),
                                           3 * K * L, L)
            st0 = pipe.stats()
            path, (parity, crcs) = pipe.submit(
                chan, data, cache=intent).result(timeout=60)
            assert path == "dev"
            st1 = pipe.stats()
            S_pad = ec_pipeline.next_bucket(3)
            assert st1["bytes_h2d"] - st0["bytes_h2d"] == S_pad * K * L
            assert st1["bytes_d2h"] - st0["bytes_d2h"] == \
                ec_kernels.encode_readback_bytes(S_pad, K, M, L)
            assert cache.commit("pg_p", "obj", (3, 9))
            ent = cache.lookup("pg_p", "obj", version=(3, 9))
            assert ent.data_bytes() == data.tobytes()
            expect = _parity(data)
            for j in range(M):
                assert ent.shard_bytes(K + j) == expect[:, j].tobytes()
            assert np.array_equal(ent.crcs, np.asarray(crcs))
            assert pipe.stats()["bytes_h2d"] == st1["bytes_h2d"]
        finally:
            pipe.stop()

    def test_entry_of_a_coalesced_batch_holds_only_its_rows(self):
        """One tagged item of a three-item batch: its entry owns its
        rows' storage (no view that keeps the padded batch alive), so
        what the cache counts against its capacity is what it holds."""
        chan = _fused_channel(key=("hbm", "own"))
        ev = threading.Event()
        slow = ec_pipeline.PipelineChannel(
            key=("hbm", "slow"), host_fn=lambda b: (ev.wait(10), (b,))[1])
        pipe = ec_pipeline.EcDevicePipeline(depth=2, split_min=64,
                                            coalesce_wait=0.001)
        cache = hbm_cache.get()
        hbm_cache.configure(_entry_bytes(1))
        rng = np.random.default_rng(24)
        try:
            first = pipe.submit(slow, np.zeros((1, 4), dtype=np.uint8))
            time.sleep(0.1)         # dispatcher wedged inside `slow`
            data = [rng.integers(0, 256, size=(n, K, L), dtype=np.uint8)
                    for n in (2, 1, 2)]
            intent = hbm_cache.CacheIntent("pg_o", "obj", (1, 1), K * L, L)
            futs = [pipe.submit(chan, d, cache=intent if i == 1 else None)
                    for i, d in enumerate(data)]
            ev.set()
            first.result(timeout=20)
            for f in futs:
                assert f.result(timeout=60)[0] == "dev"
            assert pipe.stats()["dev_dispatches"] == 1     # one batch
            assert cache.commit("pg_o", "obj", (1, 1))
            ent = cache.lookup("pg_o", "obj")
            assert ent.crcs.base is None        # owns its CRC rows too
            held = sum(t.untyped_storage().nbytes()
                       for t in (ent.dev_data, ent.dev_parity))
            held += ent.crcs.nbytes
            assert held == ent.nbytes == _entry_bytes(1) <= cache.capacity
            assert ent.data_bytes() == data[1].tobytes()
            assert ent.shard_bytes(K) == _parity(data[1])[:, 0].tobytes()
        finally:
            ev.set()
            pipe.stop()

    def test_split_sized_tagged_batch_still_stages(self):
        """A cache-tagged batch big enough for the idle-lane splitter
        still stages: tagged batches split only at item boundaries."""
        chan = _fused_channel(key=("hbm", "split"))
        pipe = ec_pipeline.EcDevicePipeline(depth=2, split_min=1,
                                            coalesce_wait=0.001,
                                            device_shards=2)
        cache = hbm_cache.get()
        rng = np.random.default_rng(23)
        try:
            S = 8
            data = rng.integers(0, 256, size=(S, K, L), dtype=np.uint8)
            intent = hbm_cache.CacheIntent("pg_s", "obj", (5, 1),
                                           S * K * L, L)
            path, _ = pipe.submit(chan, data,
                                  cache=intent).result(timeout=60)
            assert path == "dev"
            assert cache.commit("pg_s", "obj", (5, 1))
            ent = cache.lookup("pg_s", "obj", version=(5, 1))
            assert ent.data_bytes() == data.tobytes()
            # untagged, the same batch splits across both idle lanes
            split0 = pipe.stats()["split_dispatches"]
            path, (parity, _c) = pipe.submit(chan, data).result(60)
            assert pipe.stats()["split_dispatches"] == split0 + 1
            assert np.array_equal(parity, _parity(data))
            d2 = [rng.integers(0, 256, size=(4, K, L), dtype=np.uint8)
                  for _ in range(2)]
            futs = [pipe.submit(chan, d2[i],
                                cache=hbm_cache.CacheIntent(
                                    "pg_s", f"o{i}", (5, 2 + i),
                                    4 * K * L, L))
                    for i in range(2)]
            for f in futs:
                f.result(timeout=60)
            for i in range(2):
                assert cache.commit("pg_s", f"o{i}", (5, 2 + i))
                e = cache.lookup("pg_s", f"o{i}")
                assert e.data_bytes() == d2[i].tobytes()
        finally:
            pipe.stop()

    def test_quarantine_drops_lane_entries_and_redrains_bitexact(self):
        cache = hbm_cache.get()
        warm = _fused_channel(key=("hbm", "warm"))
        pipe = ec_pipeline.EcDevicePipeline(depth=2, split_min=64,
                                            coalesce_wait=0.001,
                                            device_shards=2)
        rng = np.random.default_rng(22)
        try:
            data = rng.integers(0, 256, size=(1, K, L), dtype=np.uint8)
            intent = hbm_cache.CacheIntent("pg_q", "obj", (1, 1), K * L, L)
            path, _ = pipe.submit(warm, data,
                                  cache=intent).result(timeout=60)
            assert path == "dev"
            assert cache.commit("pg_q", "obj", (1, 1))
            victim = cache.lookup("pg_q", "obj").lane
            bad = _fused_channel(bad_lanes={victim}, key=("hbm", "bad"))
            drops0 = cache.stats()["lane_drops"]
            batches, results = [], []
            for _ in range(8):
                b = rng.integers(0, 256, size=(1, K, L), dtype=np.uint8)
                batches.append(b)
                results.append(pipe.submit(bad, b).result(timeout=60))
                if pipe.stats()["quarantines"]:
                    break
            st = pipe.stats()
            assert st["quarantines"] == 1, st
            for b, (path, (parity, _crcs)) in zip(batches, results):
                assert path == "dev"
                assert np.array_equal(parity, _parity(b))
            assert cache.lookup("pg_q", "obj") is None
            assert cache.stats()["lane_drops"] > drops0
        finally:
            pipe.stop()


class TestCostAwarePlacement:
    def _seed_emas(self, pipe, nbytes, fast_lane=0, fast=1e-9, slow=1e-3):
        ds = pipe._ensure_devset()
        bucket = (max(nbytes, 1) - 1).bit_length()
        for lane in ds.lanes:
            lane.spb[bucket] = {
                "spb": fast if lane.index == fast_lane else slow, "n": 5}
        return ds

    @pytest.mark.parametrize("aware", [True, False])
    def test_cost_aware_placement(self, aware):
        chan = _fused_channel(key=("hbm", f"cost{aware}"))
        pipe = ec_pipeline.EcDevicePipeline(depth=2, split_min=64,
                                            coalesce_wait=0.0,
                                            cost_aware=aware,
                                            device_shards=2)
        rng = np.random.default_rng(31)

        def one():
            pipe.submit(chan, rng.integers(0, 256, size=(1, K, L),
                                           dtype=np.uint8)).result(60)

        try:
            for _ in range(4):
                one()
            ds = self._seed_emas(pipe, K * L, fast_lane=0)
            st0 = pipe.stats()
            d0 = [l.dispatches for l in ds.lanes]
            for _ in range(8):
                one()
            st1 = pipe.stats()
            gained = [l.dispatches - d for l, d in zip(ds.lanes, d0)]
            if aware:
                assert st1["cost_placements"] > st0["cost_placements"]
                assert st1["cost_diverged"] > st0["cost_diverged"]
                assert gained == [8, 0], gained
            else:
                assert st1["cost_aware"] is False
                assert st1["cost_placements"] == 0
                assert st1["cost_diverged"] == 0
        finally:
            pipe.stop()

    def test_perf_dump_carries_cache_and_transfer_counters(self):
        st = ec_pipeline.stats()
        for key in ("bytes_h2d", "bytes_d2h", "cost_placements",
                    "cost_diverged", "cache_hit", "cache_miss",
                    "cache_evict", "cache_insert", "cache_invalidate",
                    "cache_lane_drops", "cache_bytes",
                    "cache_capacity", "cache_entries", "exhausted_errors",
                    "stall_errors", "result_timeouts"):
            assert key in st, key
        # every counter of the reference but the mesh mode's
        assert set(st) >= {k for k in jpipeline.stats()
                           if not k.startswith(("mesh", "arena_",
                                                "device_mesh"))}
