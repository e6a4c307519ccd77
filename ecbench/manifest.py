"""Finding a cell's pieces by the names in BENCHMARK.json.

Every piece is a file of its own under the checkout: the configuration
at the manifest's `file`, the traffic mix at `ecbench/traffic/<traffic>.json`,
the object-path entry the mix names at `ecbench/entries/<entry>.py`, and
each metric's reader at `ecbench/metrics/<name>.py`, or, for a name with
a suffix such as `op_p95_ms.write`, at `ecbench/metrics/<op_p95_ms>.py`
when no file has the whole name.  Adding a cell, a mix, an entry or a
metric adds files and manifest entries; it edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PKG = "ecbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


def _load(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, root: str, workload: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.cell = cells[workload]
        self.name = workload
        self.chips = int(self.cell["chips"])
        configs = {c["name"]: c for c in self.manifest["configs"]}
        with open(os.path.join(root, configs[self.cell["config"]]["file"])) as f:
            self.cfg = json.load(f)
        with open(os.path.join(root, PKG, "traffic",
                               self.cell["traffic"] + ".json")) as f:
            self.mix = json.load(f)

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run: end-to-end with
        trace off, per-layer with it on.  A metric without `workloads`
        is reported wherever its `moves` metric is."""
        e2e = self.manifest["end_to_end"]
        mine = {m["name"] for m in e2e
                if self.name in m.get("workloads", [self.name])}
        if not trace:
            return [m for m in e2e if m["name"] in mine]
        return [m for m in self.manifest["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in mine]

    def reader(self, name: str):
        """The `read(record)` function of metric `name`."""
        base = os.path.join(self.root, PKG, "metrics")
        for stem in (name, name.split(".")[0]):
            path = os.path.join(base, stem + ".py")
            if os.path.exists(path):
                return _load(path, f"{PKG}_metric_{stem.replace('.', '_')}"
                             ).read
        raise FileNotFoundError(f"no reader for metric {name!r} under {base}")

    def entry(self):
        """The `ENTRY` class of the object-path entry the mix names."""
        name = self.mix["entry"]
        path = os.path.join(self.root, PKG, "entries", name + ".py")
        if not NAME.match(name) or not os.path.exists(path):
            raise FileNotFoundError(f"traffic {self.cell['traffic']!r} "
                                    f"names no entry file: {path}")
        return _load(path, f"{PKG}_entry_{name}").ENTRY
