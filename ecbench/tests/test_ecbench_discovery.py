"""A configuration, traffic mixes, an object-path entry and a per-layer
metric added as new files, with manifest entries, are found and run
without editing any file the benchmark has."""

import hashlib
import json
import os
import shutil

from conftest import ROOT, add_tiny
from ecbench import run


UNCACHED = """
from ecbench.entries import RESULT_TIMEOUT
from ecbench.entries.write import Write


class UncachedWrite(Write):
    def op(self, i):
        idx = self.object_of(i)
        handle = self.ctx.ecutil.encode_object_async(
            self.ctx.codec, self.sinfo, memoryview(self.ctx.pool[idx]))
        shards, crcs = handle.result(RESULT_TIMEOUT)
        return self.object_bytes, (idx, shards, crcs)


ENTRY = UncachedWrite
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "ecbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_without_edits(tmp_path, cpu_port):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "ecbench"),
                    os.path.join(root, "ecbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_tiny(root)
    before = _digests(root)
    eb = os.path.join(root, "ecbench")
    with open(os.path.join(eb, "configs/tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_odd", object_bytes=3 * 8 * 4096 - 999)
    with open(os.path.join(eb, "configs/tiny_odd.json"), "w") as f:
        json.dump(cfg, f)
    # a mix of an existing entry is a data file alone; a new entry is a
    # new file under entries/, found by the name its mix gives
    with open(os.path.join(eb, "traffic/reread.json"), "w") as f:
        json.dump({"entry": "degraded_read"}, f)
    with open(os.path.join(eb, "entries/uncached_write.py"), "w") as f:
        f.write(UNCACHED)
    with open(os.path.join(eb, "traffic/uncached.json"), "w") as f:
        json.dump({"entry": "uncached_write"}, f)
    with open(os.path.join(eb, "metrics/ops_in_window.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec['ops'])\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny_odd", "source": "a test size",
                         "file": "ecbench/configs/tiny_odd.json",
                         "reduced": [], "why": "a tail stripe"})
    cells = {"tiny_odd.reread": "degraded_read_gbs",
             "tiny_odd.uncached": "write_p50_ms"}
    for name, e2e in cells.items():
        m["workloads"].append({"name": name, "config": "tiny_odd",
                               "traffic": name.split(".")[1], "chips": 1,
                               "why": "a tail stripe"})
        for e in m["end_to_end"]:
            if e["name"] == e2e:
                e["workloads"].append(name)
    for e2e in set(cells.values()):
        m["per_layer"].append({
            "name": f"ops_in_window.{e2e}", "unit": "ops",
            "better": "higher", "source": "host_clock",
            "layer": "object path (osd/ecutil.py)", "moves": e2e,
            "workloads": [n for n, r in cells.items() if r == e2e]})
    with open(path, "w") as f:
        json.dump(m, f)
    for name, e2e in cells.items():
        out = run.run_cell(root, name, 99, 3.0, True, card=False)
        assert out["correct"], out["checks"]
        assert out["metrics"][f"ops_in_window.{e2e}"]["value"] > 0
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
