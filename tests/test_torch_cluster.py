"""A ceph_tpu_torch cluster serves EC and replicated I/O, on the CPU.

One module-scoped MiniCluster of the port (1 mon, 4 MemStore OSDs, CPU
pipeline lanes) with an EC pool k=2 m=1 and a replicated pool: put/get,
partial write, append, shards against the host oracle, degraded reads
after an OSD kill, recovery to clean, deep scrub catching a corrupted
shard, a scrub whose CRC batch times out failing instead of folding on
the host, the mon's profile check launching nothing, and the injected
device error degrading the codecs with the health warning.  The cases
run in file order: the kill and the injected fault come last.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.client import RadosError
from ceph_tpu_torch.erasure.matrix_codec import TorchBackend
from ceph_tpu_torch.ops import crc32c as crc_mod
from ceph_tpu_torch.ops import gf, hbm_cache
from ceph_tpu_torch.ops import pipeline as ec_pipeline
from ceph_tpu_torch.osd.pglog import HINFO_KEY
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.utils import denc, faults
from ceph_tpu_torch.vstart import MiniCluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, M, UNIT = 2, 1, 4096
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": K, "m": M,
           "host_cutover": 1}


@pytest.fixture(scope="module")
def cluster():
    prev = ceph_tpu_torch.set_device("cpu")
    faults.get().reset(seed=0)
    c = MiniCluster(num_mons=1, num_osds=4).start()
    r = c.client()
    r.create_pool("rep", pg_num=8)
    r.create_ec_pool("ecpool", "k2m1", PROFILE, pg_num=8)
    c.wait_for_clean(60)
    yield c
    c.stop()
    faults.get().reset(seed=0)
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


@pytest.fixture(autouse=True)
def _clean():
    from ceph_tpu.ops import hbm_cache as jhbm_cache
    from ceph_tpu.ops import pipeline as jpipeline
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    # both packages' pipelines and caches: no lane thread, quarantine
    # or entry of a case outlives it (the next submit starts afresh)
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    jpipeline.get().stop()
    jhbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)


@pytest.fixture(scope="module")
def rados(cluster):
    return cluster.client()


def _retry(cluster, fn, timeout: float = 60.0):
    end = time.time() + timeout
    while True:
        try:
            return fn()
        except RadosError:
            if time.time() > end:
                raise
            cluster.tick(0.3)


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _acting(cluster, io, oid):
    m = cluster.leader().osdmon.osdmap
    pgid = m.object_to_pg(io.pool_id, oid)
    return pgid, m.pg_to_up_acting_osds(pgid)[1]


def _check_shards(cluster, io, oid, payload, only=None):
    """Every shard file (or those in `only`) and its HashInfo against
    the host oracle: numpy GF(2^8) encode + CRC32C."""
    pgid, acting = _acting(cluster, io, oid)
    W = K * UNIT
    S = -(-len(payload) // W)
    buf = np.zeros(S * W, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    stripes = buf.reshape(S, K, UNIT)
    mat = gf.reed_sol_van_matrix(K, M)
    parity = np.stack([gf.encode_np(mat, s) for s in stripes])
    chunks = np.concatenate([stripes, parity], axis=1)
    full = len(payload) // W
    holders = {}
    for shard, holder in enumerate(acting):
        if holder < 0 or (only is not None and shard not in only):
            continue
        store = cluster.osds[holder].store
        name = f"{oid}.s{shard}"
        data = bytes(store.read(f"pg_{pgid}", name))
        want = chunks[:, shard].tobytes()
        assert data == want, (name, holder)
        hinfo = denc.loads(store.getattr(f"pg_{pgid}", name, HINFO_KEY))
        assert hinfo["crc"] == crc_mod.crc32c(0, want)
        assert hinfo["crc_prefix"] == crc_mod.crc32c(0, want[:full * UNIT])
        assert hinfo["size"] == len(payload) and hinfo["shard"] == shard
        holders[shard] = holder
    return holders


def _has_shard(cluster, io, oid, shard) -> bool:
    pgid, acting = _acting(cluster, io, oid)
    osd = cluster.osds.get(acting[shard])
    return osd is not None and \
        f"{oid}.s{shard}" in osd.store.collection_list(f"pg_{pgid}")


class TestReplicatedPool:
    def test_put_get_partial_write_and_append(self, cluster, rados):
        io = rados.open_ioctx("rep")
        io.write_full("obj1", b"hello world")
        assert io.read("obj1") == b"hello world"
        io.write_full("obj2", b"0123456789")
        io.write("obj2", b"AB", offset=3)
        assert io.read("obj2") == b"012AB56789"
        assert io.read("obj2", length=4, offset=2) == b"2AB5"
        io.append("obj2", b"xyz")
        assert io.stat("obj2")["size"] == 13
        io.remove_object("obj1")
        with pytest.raises(RadosError) as ei:
            io.read("obj1")
        assert ei.value.errno == 2


class TestECPool:
    def test_put_get_and_shards_match_the_oracle(self, cluster, rados):
        io = rados.open_ioctx("ecpool")
        for i, n in enumerate((10240, 3 * 2 * UNIT, 100_001)):
            payload = _payload(i, n)
            io.write_full(f"ec{i}", payload)
            assert io.read(f"ec{i}") == payload
            time.sleep(0.2)            # sub-writes acked; let replicas land
            assert len(_check_shards(cluster, io, f"ec{i}",
                                     payload)) == K + M

    def test_writes_ride_the_device_pass(self, cluster, rados):
        """The k=2 m=1 pool pins host_cutover=1: once its shapes are warm
        every write's stripe batch is a device dispatch (the plain
        PyTorch version on a CPU lane here)."""
        io = rados.open_ioctx("ecpool")
        payload = _payload(10, 128 << 10)

        def passes() -> int:
            return sum(c.stat_counters()["device_stripe_passes"]
                       for o in cluster.osds.values()
                       for c in o._ec_codecs.values())

        io.write_full("devobj", payload)
        end = time.time() + 60
        while passes() == 0 and time.time() < end:
            io.write_full("devobj", payload)
            time.sleep(0.05)
        assert passes() >= 1
        d0 = ec_pipeline.stats()["dev_dispatches_enc"]
        io.write_full("devobj", payload)
        assert ec_pipeline.stats()["dev_dispatches_enc"] > d0
        assert io.read("devobj") == payload
        _check_shards(cluster, io, "devobj", payload)

    def test_append_of_a_ragged_tail(self, cluster, rados):
        io = rados.open_ioctx("ecpool")
        first, delta = _payload(20, 5000), _payload(21, 7777)
        io.write_full("appendobj", first)

        def append():
            # a timed-out append may still have landed: re-check before
            # retrying (a blind retry would append twice)
            if io.read("appendobj") != first + delta:
                io.append("appendobj", delta)

        _retry(cluster, append)
        assert io.read("appendobj") == first + delta
        time.sleep(0.2)
        _check_shards(cluster, io, "appendobj", first + delta)

    def test_deep_scrub_catches_a_corrupted_shard(self, cluster, rados):
        io = rados.open_ioctx("ecpool")
        io.write_full("scrubme", _payload(30, 3 * UNIT))
        pgid, acting = _acting(cluster, io, "scrubme")
        time.sleep(0.3)
        pg = cluster.osds[acting[0]].get_pg(pgid)
        hbm_cache.get().clear()
        # the scrub CRC kernels warm in the background; the first scans
        # of a row size run on the host meanwhile
        crc0 = ec_pipeline.stats()["dev_dispatches_crc"]
        end = time.time() + 60
        while True:
            assert pg.scrub(deep=True)["inconsistent"] == []
            if ec_pipeline.stats()["dev_dispatches_crc"] > crc0:
                break
            assert time.time() < end
            time.sleep(0.1)
        store = cluster.osds[acting[1]].store
        store.apply_transaction(Transaction().write(
            f"pg_{pgid}", "scrubme.s1", 10, b"\xde"))
        dirty = pg.scrub(deep=True)["inconsistent"]
        assert dirty == [{"object": "scrubme.s1", "osd": acting[1]}]
        # repair rebuilds the shard (later cases lose another OSD: with
        # k=2 m=1 a second bad shard would leave the object undecodable)
        fixed = pg.scrub(deep=True, repair=True)
        assert fixed["repaired"] == 1 and fixed["clean_after_repair"]

    def test_scrub_crc_timeout_fails_the_scrub(self, cluster, rados,
                                               monkeypatch):
        """A CRC batch that never resolves fails the scrub with the
        timeout counted; the CRCs are never computed on the host."""
        io = rados.open_ioctx("ecpool")
        io.write_full("stuck", _payload(40, 2 * UNIT))
        pgid, acting = _acting(cluster, io, "stuck")
        time.sleep(0.3)
        pg = cluster.osds[acting[0]].get_pg(pgid)
        hbm_cache.get().clear()
        pipe = ec_pipeline.get()
        host_crcs = []
        real_batch = crc_mod.crc32c_batch
        monkeypatch.setattr(ec_pipeline, "RESULT_TIMEOUT", 0.2)
        monkeypatch.setattr(pipe, "submit", lambda *a, **k: Future())
        monkeypatch.setattr(
            crc_mod, "crc32c_batch",
            lambda *a, **k: host_crcs.append(1) or real_batch(*a, **k))
        t0 = pipe.stats()["result_timeouts"]
        with pytest.raises(TimeoutError, match="deep scrub"):
            pg.scrub(deep=True)
        assert pipe.stats()["result_timeouts"] == t0 + 1
        assert host_crcs == []

    def test_mon_profile_check_builds_a_codec_and_launches_nothing(
            self, cluster, rados, monkeypatch):
        from ceph_tpu_torch.mon import services
        built = []
        real = services.ec_registry.factory

        def factory(plugin, profile):
            codec = real(plugin, profile)
            built.append(codec)
            return codec

        monkeypatch.setattr(services.ec_registry, "factory", factory)
        d0 = ec_pipeline.stats()["dispatches"]
        rados.create_ec_pool("ecpool2", "k2m1cauchy",
                             {"plugin": "tpu", "k": 2, "m": 1,
                              "technique": "cauchy_good"}, pg_num=4)
        assert built and all(isinstance(c.backend, TorchBackend)
                             for c in built)
        for c in built:
            assert not c.backend._ready and not c.backend._warming
            assert c.stat_counters()["device_stripe_passes"] == 0
        assert ec_pipeline.stats()["dispatches"] == d0


class TestFailures:
    def test_degraded_read_then_recovery_to_clean(self, cluster, rados):
        io = rados.open_ioctx("ecpool")
        payloads = {f"deg{i}": _payload(50 + i, 3 * 2 * UNIT + 77 * i)
                    for i in range(6)}
        for oid, p in payloads.items():
            io.write_full(oid, p)
        time.sleep(0.3)
        victim = 1
        lost = {}
        for oid in payloads:
            pgid, acting = _acting(cluster, io, oid)
            if victim in acting:
                shard = acting.index(victim)
                lost[oid] = (shard, bytes(cluster.osds[victim].store.read(
                    f"pg_{pgid}", f"{oid}.s{shard}")))
        assert lost
        hbm_cache.get().clear()
        cluster.kill_osd(victim)
        cluster.mark_osd_down(victim)
        cluster.wait_for_osd_down(victim)
        for oid, p in payloads.items():
            assert _retry(cluster, lambda: io.read(oid)) == p
        cluster.mark_osd_out(victim)
        cluster.wait_for_clean(120)
        # clean is the map and the pg states: check the rebuilt files
        end = time.time() + 60
        while not all(_has_shard(cluster, io, oid, shard)
                      for oid, (shard, _d) in lost.items()):
            assert time.time() < end, "lost shards not rebuilt"
            cluster.tick(0.5)
        for oid, (shard, data) in lost.items():
            holders = _check_shards(cluster, io, oid, payloads[oid],
                                    only={shard})
            assert holders[shard] != victim
            pgid, _ = _acting(cluster, io, oid)
            new = cluster.osds[holders[shard]].store
            assert bytes(new.read(f"pg_{pgid}", f"{oid}.s{shard}")) == data
        for oid, p in payloads.items():
            assert io.read(oid) == p

    def test_injected_device_error_degrades_with_health_warning(
            self, cluster, rados):
        io = rados.open_ioctx("ecpool")
        io.write_full("pre", b"before-fault" * 100)
        faults.get().tpu_device_error(1.0)
        try:
            payload = _payload(60, 64 << 10)
            io.write_full("post", payload)
            assert io.read("post") == payload
            assert io.read("pre") == b"before-fault" * 100
            assert any(getattr(c, "degraded", False)
                       for o in cluster.osds.values()
                       for c in o._ec_codecs.values())
            end = time.time() + 60
            while True:
                rv, out, _ = rados.mon_command({"prefix": "health"})
                assert rv == 0
                if "EC device degraded" in out and "HEALTH_WARN" in out:
                    break
                assert time.time() < end, out
                cluster.tick(0.5)
        finally:
            faults.get().reset(seed=0)


def test_cluster_on_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    code = (
        "import json, os\n"
        "from ceph_tpu_torch.vstart import MiniCluster\n"
        "c = MiniCluster(num_mons=1, num_osds=1)\n"
        "try:\n"
        "    c.start(timeout=20)\n"
        "    out = 'started'\n"
        "except RuntimeError as e:\n"
        "    out = str(e)\n"
        "print(json.dumps({'err': out}), flush=True)\n"
        "os._exit(0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "no CUDA device" in got["err"], got
