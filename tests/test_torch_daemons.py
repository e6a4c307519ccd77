"""The port's standalone daemon entry points (``python -m
ceph_tpu_torch.daemons``), run as processes on the CPU.

An OSD started from the command line runs on the package device, cuda:
with no card it exits with the pipeline's error.  A caller that sets the
CPU device before ``main()`` boots an OSD that joins a monitor started
from the same command line.  The mds and rgw roles parse their command
lines and, started as processes against a CPU cluster, serve a CephFS
mount and SigV4-signed S3 requests.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.daemons import load_conf, main, monmap_from_conf
from ceph_tpu_torch.osd.osdmap import OSDMap

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
