"""The port's standalone daemon entry points (``python -m
ceph_tpu_torch.daemons``), run as processes on the CPU.

An OSD started from the command line runs on the package device, cuda:
with no card it exits with the pipeline's error.  A caller that sets the
CPU device before ``main()`` boots an OSD that joins a monitor started
from the same command line.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.daemons import load_conf, monmap_from_conf
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
