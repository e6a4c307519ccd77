"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
import ceph_tpu_torch
ceph_tpu_torch.set_device("cpu")
from ecbench import run
out = run.run_cell({tiny!r}, "tiny.write", 5, 3.0, False, card=False)
assert out["correct"], out["checks"]
print(",".join(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_a_run_loads_no_jax(tiny_root):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=ROOT, tiny=tiny_root)],
                       capture_output=True, text=True, timeout=600,
                       cwd=tiny_root, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(r.stdout.strip().splitlines()[-1].split(","))
    assert not tops & {"jax", "jaxlib", "flax", "ceph_tpu"}
    assert "ceph_tpu_torch" in tops


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_only_numpy():
    for path in glob.glob(os.path.join(ROOT, "ecbench/reference/*.py")):
        for name in _imports(path):
            assert name.startswith(".") or name.split(".")[0] in (
                "numpy", "itertools", "__future__"), (path, name)


def test_no_benchmark_file_names_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "ecbench/**/*.py"),
                          recursive=True):
        if "/tests/" in path:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "ceph_tpu"), (path, name)


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "ecbench", "--workload",
                        "tpu_k8m3_1m.write", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
