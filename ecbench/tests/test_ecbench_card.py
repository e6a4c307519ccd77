"""On the card: a short run of a cell, and no result from a checkout that
holds only the benchmark.  Run on the chip with
`python3 -m pytest ecbench/tests -q -m card`."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a run measures the card only")


@pytest.mark.card
def test_a_short_cell_on_the_card():
    _need_card()
    r = subprocess.run([sys.executable, "-m", "ecbench", "--workload",
                        "tpu_k8m3_1m.write", "--seed", str((1 << 31) + 3),
                        "--seconds", "3"], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["write_p50_ms"]["value"] > 0


@pytest.mark.card
def test_the_benchmark_alone_gives_no_result(tmp_path):
    _need_card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "ecbench"), tmp_path / "ecbench")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "ecbench", "--workload",
                        "tpu_k8m3_1m.write", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
