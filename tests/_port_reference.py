"""Run one of the reference's test files against the port, on the CPU.

A wrapper ``tests/test_torch_<name>.py`` calls
``run_reference(globals(), "test_<name>")``: the reference file's source
is read, every ``ceph_tpu`` module path in it is re-rooted at
``ceph_tpu_torch``, and the result is executed into the wrapper's
namespace, so pytest collects the reference's cases there.  The file
itself is never edited.  The wrapper also gains a module-scoped autouse
fixture that sets the port's device to the CPU before any of the
module's fixtures start a cluster, and that stops the port's dispatch
pipeline, clears its HBM cache and restores the device after the last
case.
"""

from __future__ import annotations

import ast
import os
import re

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = re.compile(r"\bceph_tpu\b")
_LEFT = re.compile(r"\bceph_tpu\b(?!_torch)")


def ported_source(name: str) -> tuple[str, str]:
    """(path, source) of tests/<name>.py with its imports re-rooted at
    the port; raises if any ``ceph_tpu`` name is left."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        src = _PACKAGE.sub("ceph_tpu_torch", f.read())
    left = [i for i, line in enumerate(src.splitlines(), 1)
            if _LEFT.search(line)]
    if left:
        raise ImportError(f"{path}: ceph_tpu left at lines {left}")
    return path, src


def _compile(path: str, src: str):
    tree = ast.parse(src, filename=path)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts
    except ImportError:          # plain asserts still fail, less verbosely
        pass
    else:
        rewrite_asserts(tree, src.encode(), path)
    return compile(tree, path, "exec")


def run_reference(namespace: dict, name: str) -> None:
    path, src = ported_source(name)
    exec(_compile(path, src), namespace)
    namespace["_port_on_the_cpu"] = _port_on_the_cpu


@pytest.fixture(scope="module", autouse=True)
def _port_on_the_cpu():
    import ceph_tpu_torch
    from ceph_tpu_torch.ops import hbm_cache
    from ceph_tpu_torch.ops import pipeline as ec_pipeline
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    ec_pipeline.get().stop()
    hbm_cache.get().clear()
    ceph_tpu_torch.set_device(prev)
