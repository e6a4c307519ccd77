"""ceph_tpu_torch stands alone: it imports neither JAX nor any ceph_tpu
module, and its default device is the card with no silent CPU fallback.

Each check runs in a fresh interpreter so no other test's imports or
device setting leak in.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ceph_tpu_torch")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _port_modules() -> list[str]:
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return sorted(mods)


def test_every_module_imports_without_jax_or_ceph_tpu():
    mods = _port_modules()
    assert "ceph_tpu_torch.ops.cuda_ec" in mods
    assert "ceph_tpu_torch.erasure.plugin_tpu" in mods
    for name in ("ops.pipeline", "ops.hbm_cache", "utils.optracker",
                 "utils.dmclock", "rgw", "rgw.auth_v4", "rgw.swift",
                 "rgw.sync", "fs", "fs.mds", "fs.messages", "rbd",
                 "rbd.mirror", "journal", "client.kv_btree",
                 "client.object_cacher", "tools.loadgen", "graft_entry",
                 "tools.authtool", "tools.ceph_cli", "tools.cephfs_shell",
                 "tools.copy_audit", "tools.counter_audit",
                 "tools.crushtool", "tools.monmaptool",
                 "tools.objectstore_tool", "tools.osdmaptool",
                 "tools.rados_cli", "tools.trace_dump"):
        assert f"ceph_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n.startswith('jaxlib')\n"
        "             or n == 'ceph_tpu' or n.startswith('ceph_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_module_set_matches_the_reference():
    """The port has every module of ceph_tpu but the Pallas kernels
    (ops/pallas_ec, whose place ops/cuda_ec and csrc/ take), plus its
    kernel probe and the twin of __graft_entry__.py."""
    def rel(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _dirs, files in os.walk(root)
                for f in files if f.endswith(".py")}

    ref, port = rel("ceph_tpu"), rel("ceph_tpu_torch")
    assert ref - port == {os.path.join("ops", "pallas_ec.py")}
    assert port - ref == {os.path.join("ops", "cuda_ec.py"),
                          os.path.join("tools", "kernel_probe.py"),
                          "graft_entry.py"}


def test_sources_name_only_port_modules():
    """No import path written as a string may point back into ceph_tpu
    (a verbatim copy of the registry table would load the JAX plugins)."""
    for mod in _port_modules():
        path = os.path.join(REPO, *mod.split("."))
        path = path + ".py" if os.path.exists(path + ".py") \
            else os.path.join(path, "__init__.py")
        for lineno, line in enumerate(open(path), 1):
            code = line.split("#", 1)[0]
            assert "import jax" not in code, (path, lineno)
            for quote in ('"', "'"):
                assert f"{quote}ceph_tpu." not in code, (path, lineno)
            assert "from ceph_tpu." not in code and \
                "import ceph_tpu." not in code, (path, lineno)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    code = (
        "import json, numpy as np\n"
        "import ceph_tpu_torch\n"
        "from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf\n"
        "out = {'device': str(ceph_tpu_torch.get_device())}\n"
        "mat = gf.reed_sol_van_matrix(4, 2)\n"
        "data = np.zeros((1, 4, 256), dtype=np.uint8)\n"
        "calls = {'fused': lambda: cuda_ec.make_encode_crc_fn(mat, 256)(data),\n"
        "         'encode': lambda: cuda_ec.make_encode_fn(mat)(data),\n"
        "         'plain': lambda: ec_kernels.make_codec_fn(mat)(data)}\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "        out[name] = 'ran'\n"
        "    except (AssertionError, RuntimeError) as e:\n"
        "        out[name] = 'raised'\n"
        "print(json.dumps(out))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"device": "cuda", "fused": "raised", "encode": "raised",
                   "plain": "raised"}


def test_codec_on_default_device_raises_without_a_card():
    """The registry's tpu codec, pinned to the device, sends its batches
    to the pipeline, whose lanes are the visible cards: with none, every
    dispatch raises (no pseudo-lane, no host run) and the codec does not
    degrade."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    code = (
        "import json, time, numpy as np\n"
        "from ceph_tpu_torch.erasure.registry import registry\n"
        "codec = registry.factory('tpu', {'k': '8', 'm': '3',\n"
        "    'technique': 'reed_sol_van', 'host_cutover': '1'})\n"
        "stripes = np.zeros((2, 8, 4096), dtype=np.uint8)\n"
        "err, t0 = None, time.monotonic()\n"
        "while err is None and time.monotonic() - t0 < 60:\n"
        "    try:\n"
        "        codec.encode_stripes_with_crcs(stripes)\n"
        "        time.sleep(0.01)\n"
        "    except RuntimeError as e:\n"
        "        err = str(e)\n"
        "print(json.dumps({'err': err, 'degraded': codec.degraded,\n"
        "    'device_passes': codec.stat_counters()"
        "['device_stripe_passes']}))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["err"] and "no CUDA device" in got["err"], got
    assert got["degraded"] is False and got["device_passes"] == 0


def test_no_silent_cpu_selection_in_the_package():
    for mod in _port_modules():
        path = os.path.join(REPO, *mod.split("."))
        path = path + ".py" if os.path.exists(path + ".py") \
            else os.path.join(path, "__init__.py")
        assert "cuda.is_available" not in open(path).read(), path


def test_set_device_round_trips():
    import ceph_tpu_torch
    prev = ceph_tpu_torch.set_device("cpu")
    try:
        assert ceph_tpu_torch.get_device() == torch.device("cpu")
    finally:
        ceph_tpu_torch.set_device(prev)
    assert ceph_tpu_torch.get_device() == prev
