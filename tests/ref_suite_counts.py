"""Per-wrapper case counts of a pytest run of the reference suite against
the port, from its junit report:

    python tests/ref_suite_counts.py REPORT.xml

For each tests/test_torch_*.py wrapper of a reference file (those that
call _port_reference.run_reference) it prints the reference file, the
cases the run collected, passed, failed and skipped, and the cases the
wrapper leaves out, as one JSON object per line, then a total line.
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
import xml.etree.ElementTree as ET

TESTS = os.path.dirname(os.path.abspath(__file__))


def wrappers() -> dict[str, str]:
    """{wrapper module: reference file} for every wrapper."""
    out = {}
    for f in sorted(os.listdir(TESTS)):
        if not (f.startswith("test_torch_") and f.endswith(".py")):
            continue
        src = open(os.path.join(TESTS, f)).read()
        m = re.search(r'run_reference\(globals\(\), "(test_\w+)"', src)
        if m:
            out[f[:-3]] = m[1] + ".py"
    return out


def excluded(src: str) -> int:
    """The cases the wrapper's run_reference call leaves out."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "run_reference":
            for kw in node.keywords:
                if kw.arg == "exclude":
                    return len(ast.literal_eval(kw.value))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    counts: dict[str, dict] = {}
    for case in ET.parse(argv[0]).getroot().iter("testcase"):
        mod = case.get("classname", "").split(".")
        name = next((p for p in mod if p.startswith("test_torch_")), None)
        if name is None:
            continue
        c = counts.setdefault(name, {"collected": 0, "passed": 0,
                                     "failed": 0, "skipped": 0})
        c["collected"] += 1
        if case.find("failure") is not None or \
                case.find("error") is not None:
            c["failed"] += 1
        elif case.find("skipped") is not None:
            c["skipped"] += 1
        else:
            c["passed"] += 1
    total = dict.fromkeys(("collected", "passed", "failed", "skipped",
                           "excluded"), 0)
    for name, ref in wrappers().items():
        src = open(os.path.join(TESTS, name + ".py")).read()
        row = {"wrapper": name + ".py", "reference": ref,
               **counts.get(name, {"collected": 0, "passed": 0,
                                   "failed": 0, "skipped": 0}),
               "excluded": excluded(src)}
        for k in total:
            total[k] += row[k]
        print(json.dumps(row))
    print(json.dumps({"wrappers": len(wrappers()), **total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
