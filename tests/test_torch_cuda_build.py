"""The kernels' build is shared by processes that start cold at once.

The OSD processes of one host (13 in chip_smoke.py's phase 14) each
build the CUDA kernels at their first use.  cuda_ec.build() takes a lock
on a file in the build directory, so one process compiles each source
and the others wait and find the library.  Here nvcc is a script that
sleeps, logs its output path and writes it.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_CALL = (
    "import json, sys\n"
    "from ceph_tpu_torch.ops import cuda_ec\n"
    "cuda_ec.BUILD_DIR = sys.argv[1]\n"
    "cuda_ec._nvcc = lambda: sys.argv[2]\n"
    "cuda_ec.build()\n"
    "print(json.dumps({n: [cuda_ec.library_path(n),\n"
    "                      open(cuda_ec.library_path(n)).read()]\n"
    "                  for n in cuda_ec.SOURCES}))\n")
FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep 1
echo "$out" >> "{log}"
echo "compiled by $$" > "$out"
"""


def test_processes_building_at_once_share_one_compile(tmp_path):
    from ceph_tpu_torch.ops import cuda_ec
    log = tmp_path / "compiles.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{log}", str(log)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CALL, str(build),
                               str(nvcc)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _o, e in outs]
    loaded = [json.loads(o.strip().splitlines()[-1]) for o, _e in outs]
    # one compile per source, and every process loads that file
    assert len(log.read_text().splitlines()) == len(cuda_ec.SOURCES)
    assert all(got == loaded[0] for got in loaded)
    assert sorted(loaded[0]) == sorted(cuda_ec.SOURCES)
    assert all(text.startswith("compiled by ")
               for _path, text in loaded[0].values())
