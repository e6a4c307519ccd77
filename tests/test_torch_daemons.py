"""The port's standalone daemon entry points (``python -m
ceph_tpu_torch.daemons``), run as processes on the CPU.

An OSD started from the command line runs on the package device, cuda:
with no card it exits with the pipeline's error.  A caller that sets the
CPU device before ``main()`` boots an OSD that joins a monitor started
from the same command line.  The mds and rgw roles parse their command
lines and, started as processes against a CPU cluster, serve a CephFS
mount and SigV4-signed S3 requests.  A cluster of mon and OSD processes
(chip_smoke.py's launcher) survives a SIGKILLed OSD, marked down by the
mon from its peers' reports, and serves the same bytes as the same
drill against ceph_tpu's daemons; every survivor exits 0 on SIGTERM.
"""

import itertools
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.daemons import load_conf, main, monmap_from_conf
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.tools import connect_from_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_MAIN = ("import sys, ceph_tpu_torch; ceph_tpu_torch.set_device('cpu'); "
            "from ceph_tpu_torch.daemons import main; main(sys.argv[1:])")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conf(tmp_path) -> str:
    path = tmp_path / "ceph.conf"
    path.write_text("[global]\n"
                    "fsid = 5e2b3c1a-0000-4000-8000-000000000001\n"
                    f"mon host = 127.0.0.1:{_free_port()}\n"
                    "objectstore = memstore\n")
    return str(path)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable] + args, cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait_line(proc: subprocess.Popen, needle: str, timeout: float) -> str:
    end = time.time() + timeout
    while time.time() < end:
        line = proc.stdout.readline()
        if needle in line:
            return line
        if not line and proc.poll() is not None:
            break
    raise AssertionError(f"no {needle!r} line: rc={proc.poll()} "
                         f"{proc.stderr.read() if proc.poll() else ''}")


def _stop(proc: subprocess.Popen) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def test_osd_on_the_default_device_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.daemons", "osd", "--id", "0",
         "-c", _conf(tmp_path)], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert "up at" not in out.stdout


def test_command_line_mon_and_a_cpu_osd_boot(tmp_path):
    conf = _conf(tmp_path)
    mon = _spawn(["-m", "ceph_tpu_torch.daemons", "mon", "--name", "a",
                  "-c", conf])
    osd = None
    rados = None
    try:
        _wait_line(mon, "mon.a up at", 60)
        osd = _spawn(["-c", CPU_MAIN, "osd", "--id", "0", "-c", conf])
        _wait_line(osd, "osd.0 up at", 60)
        rados = Rados(monmap_from_conf(load_conf(conf)), "client.cli",
                      conf=load_conf(conf))
        rados.connect()
        end = time.time() + 60
        while True:
            rv, _out, data = rados.mon_command({"prefix": "osd dump"})
            if rv == 0 and OSDMap.decode(data).is_up(0):
                break
            assert time.time() < end, "osd.0 never marked up"
            time.sleep(0.2)
    finally:
        if rados is not None:
            rados.shutdown()
        codes = [_stop(p) for p in (osd, mon) if p is not None]
    assert codes == [0, 0]


@pytest.mark.parametrize("argv, code, needle", [
    (["mds", "--help"], 0, "--name"),
    (["rgw", "--help"], 0, "--secret-key"),
    (["mds"], 2, "--name"),
    (["rgw", "--port", "x"], 2, "--port"),
])
def test_mds_and_rgw_command_lines(argv, code, needle, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    assert ei.value.code == code
    out = capsys.readouterr()
    assert needle in out.out + out.err


def _cluster_conf(tmp_path, cluster) -> str:
    hosts = ",".join(f"{h}:{p}" for h, p in (
        cluster.monmap.addr_of(n) for n in cluster.monmap.ranks()))
    path = tmp_path / "ceph.conf"
    path.write_text(f"[global]\nfsid = {cluster.monmap.fsid}\n"
                    f"mon host = {hosts}\n")
    return str(path)


def test_command_line_mds_and_rgw_serve_a_cpu_cluster(tmp_path):
    import urllib.request
    from ceph_tpu_torch.fs import CephFS
    from ceph_tpu_torch.ops import hbm_cache
    from ceph_tpu_torch.ops import pipeline as ec_pipeline
    from ceph_tpu_torch.rgw import auth_v4
    from ceph_tpu_torch.vstart import MiniCluster
    prev = ceph_tpu_torch.set_device("cpu")
    cluster = MiniCluster(num_mons=1, num_osds=3).start()
    procs = []
    try:
        conf = _cluster_conf(tmp_path, cluster)
        mds = _spawn(["-c", CPU_MAIN, "mds", "--name", "a", "-c", conf])
        procs.append(mds)
        _wait_line(mds, "mds.a up at", 60)
        port = _free_port()
        rgw = _spawn(["-c", CPU_MAIN, "rgw", "--port", str(port),
                      "--access-key", "AKIACLI", "--secret-key", "cli",
                      "-c", conf])
        procs.append(rgw)
        _wait_line(rgw, f"rgw up at http://127.0.0.1:{port}", 60)

        def s3(method, path, data=b""):
            host = f"127.0.0.1:{port}"
            headers = auth_v4.sign_v4(method, path, "", {"host": host},
                                      data, "AKIACLI", "cli")
            headers["Host"] = host
            req = urllib.request.Request(f"http://{host}{path}",
                                         data=data or None, method=method,
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read()

        s3("PUT", "/cli")
        s3("PUT", "/cli/obj", b"through the rgw role")
        assert s3("GET", "/cli/obj") == b"through the rgw role"
        fs = CephFS(cluster.client("client.cli_fs"))
        end = time.time() + 60
        while True:
            try:
                fs.mount(timeout=10.0)
                break
            except Exception:
                assert time.time() < end, "no CephFS mount"
                cluster.tick(0.5)
        f = fs.open("/cli", "w")
        f.write(b"through the mds role")
        f.close()
        assert fs.open("/cli", "r").read() == b"through the mds role"
    finally:
        codes = [_stop(p) for p in reversed(procs)]
        cluster.stop()
        ec_pipeline.get().stop()
        hbm_cache.get().clear()
        ceph_tpu_torch.set_device(prev)
    assert codes == [0, 0]


# -- the cluster as processes (chip_smoke.py's launcher, on the CPU) -------

DRILL_SEED, DRILL_OBJECTS, DRILL_BYTES = 20261017, 6, 200_000
DRILL_WIDE = 2 << 20           # 256 stripes of 2 x 4 KiB: a new shape
DRILL_PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": "2",
                 "m": "1", "host_cutover": "1"}
DRILL_CONF = {"mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
              "osd_heartbeat_grace": 4.0, "mon_osd_min_down_reporters": 2,
              "mon_osd_down_out_interval": 1e6,
              "objecter_op_timeout": 60.0}


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _process_drill(tmp_path, main, env) -> tuple:
    """1 mon and 4 MemStore OSD processes started through `main`, a k=2
    m=1 tpu pool (every batch routed to the package device's lanes), a
    client process writing seeded objects; one OSD (drawn from the seed)
    SIGKILLed and marked down by the mon from its peers' failure
    reports; every object read back degraded by the client process;
    one write at a new batch shape, then every survivor SIGTERMed.  Returns (bytes read back, exit
    codes, {osd: perf dump} of the survivors before the SIGTERM)."""
    cs = _chip_smoke()
    cluster = cs.ProcCluster(str(tmp_path), 1, 4, DRILL_CONF, main=main,
                             env=env, mgr=False)
    clients = None
    try:
        cluster.start(timeout=120.0)
        admin = cluster.admin
        admin.create_ec_pool("drill", "k2m1", DRILL_PROFILE, pg_num=8)
        pool_id = admin.open_ioctx("drill").pool_id
        cluster.wait_clean(pool_id, 8, 120.0)
        clients = cs.ClientProcs(cluster.conf_path, "drill", 1, DRILL_SEED)
        items = [(f"obj{i}", i, DRILL_BYTES, 0)
                 for i in range(DRILL_OBJECTS)]
        clients.run("write", items)
        victim = int(np.random.default_rng(DRILL_SEED).integers(4))
        cs.kill_and_wait_down(cluster, victim,
                              DRILL_CONF["osd_heartbeat_grace"])
        clients.run("read", items)
        rados = connect_from_conf(cluster.conf_path, "client.check")
        try:
            io = rados.open_ioctx("drill")
            back = [bytes(io.read(f"obj{i}")) for i in range(DRILL_OBJECTS)]
        finally:
            rados.shutdown()
        survivors = [i for i in range(4) if i != victim]
        perf = {i: cluster.perf(f"osd.{i}") for i in survivors}
        clients.close()
        clients = None
        # one more write, at a batch shape no write has had: its primary
        # is still warming that shape up when the SIGTERMs go out
        osdmap = cluster.osdmap()
        name = next(f"wide{j}" for j in itertools.count()
                    if victim not in osdmap.pg_to_up_acting_osds(
                        osdmap.object_to_pg(pool_id, f"wide{j}"))[1])
        admin.open_ioctx("drill").write_full(name, bytes(DRILL_WIDE))
        return back, cluster.stop(), perf
    finally:
        if clients is not None:
            clients.close()
        cluster.close()


def test_process_cluster_survives_a_real_osd_death(tmp_path):
    cs = _chip_smoke()
    back, codes, perf = _process_drill(tmp_path / "port", ("-c", CPU_MAIN),
                                       _env())
    want = [cs.object_payload(DRILL_SEED, i, DRILL_BYTES)
            for i in range(DRILL_OBJECTS)]
    assert back == want
    # every survivor had its pipeline's lanes up, and the pool's
    # batches went through the pipelines
    assert all(p["ec_pipeline"]["active_devices"] >= 1
               for p in perf.values())
    assert sum(p["ec_pipeline"]["dispatches"] for p in perf.values()) > 0
    # each process's kernel launch counts ride its perf dump: none on
    # the CPU, where the wrappers run their plain versions
    from ceph_tpu_torch.ops import cuda_ec
    assert all(p["ec_pipeline"]["launches"] == dict.fromkeys(
        cuda_ec.launches, 0) for p in perf.values())
    # a SIGTERMed OSD drains its lanes and joins its kernel warm-ups
    # before the interpreter exits (else the C++ runtime aborts it)
    assert len(codes) == 4 and all(rc == 0 for rc in codes.values()), codes

    env = dict(_env(), JAX_PLATFORMS="cpu")
    ref_back, _codes, _perf = _process_drill(
        tmp_path / "reference", ("-m", "ceph_tpu.daemons"), env)
    assert ref_back == back
