"""Fixtures of the benchmark's own tests (run from the repo root:
`python -m pytest ecbench/tests -q`).  Nothing here imports JAX.

`tiny_root` is a copy of the benchmark in a temporary checkout with one
more configuration, `tiny` (k=8 m=3 at the 4 KiB unit, 128 KiB objects,
3 op threads), and its two cells, so that a whole run fits the CPU.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"object_bytes": 4 * 8 * 4096, "objects": 8, "op_threads": 3,
        "check_ops": 4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips on a machine "
        "without one")


def add_tiny(root: str) -> None:
    """Add the `tiny` configuration and cells to the checkout at root."""
    with open(os.path.join(root, "ecbench/configs/tpu_k8m3_4k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", **TINY)
    cfg["osd"]["osd_ec_pipeline_max_batch"] = 8
    with open(os.path.join(root, "ecbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny", "source": "a test size",
                         "file": "ecbench/configs/tiny.json",
                         "reduced": ["object_bytes", "objects"],
                         "why": "the CPU tests"})
    if not any(e["name"] == "degraded_read_gbs" for e in m["end_to_end"]):
        m["end_to_end"].append({"name": "degraded_read_gbs", "unit": "GB/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": []})
    for t in ("write", "degraded_read"):
        name = f"tiny.{t}"
        m["workloads"].append({"name": name, "config": "tiny",
                               "traffic": t, "chips": 1, "why": "tests"})
        for e in m["end_to_end"] + m["per_layer"]:
            e2e = {"write": "write_p50_ms", "degraded_read":
                   "degraded_read_gbs"}[t]
            if "workloads" in e and e2e in (e["name"], e.get("moves")):
                e["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(m, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "ecbench"),
                    os.path.join(root, "ecbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_tiny(root)
    return root


@pytest.fixture(scope="session")
def cpu_port():
    """The port on the CPU for this session's runs."""
    import ceph_tpu_torch
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    from ceph_tpu_torch.ops import pipeline
    pipeline.get().stop()
    ceph_tpu_torch.set_device(prev)
