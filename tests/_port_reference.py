"""Run one of the reference's test files against the port.

A wrapper ``tests/test_torch_<name>.py`` calls
``run_reference(globals(), "test_<name>")``: the reference file's source
is read, every ``ceph_tpu`` module path in it is re-rooted at
``ceph_tpu_torch``, and the result is executed as the
module ``_ported_test_<name>``, whose names are copied into the
wrapper's namespace, so pytest collects the reference's cases there.
The file itself is never edited.  An import of a sibling test module
(``from test_msg import ...``) is re-rooted too, at the sibling's own
ported module, loaded once.

The wrapper also gains a module-scoped autouse fixture that sets the
port's device (and its CPU lane count) before any of the module's
fixtures start a cluster, and that stops the port's dispatch pipeline, clears its HBM cache and
restores the device after the last case.  The device is the CPU unless
the run was asked for the card by passing :class:`OnTheCard` to
``pytest.main(..., plugins=[OnTheCard()])``; asked for the card with
none present, the fixture raises.
"""

from __future__ import annotations

import ast
import os
import re
import sys
import threading
import time
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = re.compile(r"\bceph_tpu\b")
_LEFT = re.compile(r"\bceph_tpu\b(?!_torch)")
_FROM_SIBLING = re.compile(r"^(\s*)from\s+(test_\w+)\b", re.M)
_IMPORT_SIBLING = re.compile(r"^(\s*)import\s+(test_\w+)\s*$", re.M)
PREFIX = "_ported_"


def ported_source(name: str) -> tuple[str, str]:
    """(path, source) of tests/<name>.py with its imports re-rooted at
    the port; raises if any ``ceph_tpu`` name is left."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        src = _PACKAGE.sub("ceph_tpu_torch", f.read())
    src = _FROM_SIBLING.sub(lambda m: f"{m[1]}from {PREFIX}{m[2]}", src)
    src = _IMPORT_SIBLING.sub(
        lambda m: f"{m[1]}import {PREFIX}{m[2]} as {m[2]}", src)
    left = [i for i, line in enumerate(src.splitlines(), 1)
            if _LEFT.search(line)]
    if left:
        raise ImportError(f"{path}: ceph_tpu left at lines {left}")
    return path, src


def siblings(src: str) -> list[str]:
    """The sibling test modules a ported source imports."""
    return sorted(set(re.findall(
        rf"^\s*(?:from|import)\s+{PREFIX}(test_\w+)\b", src, re.M)))


def _compile(path: str, src: str):
    tree = ast.parse(src, filename=path)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts
    except ImportError:          # plain asserts still fail, less verbosely
        pass
    else:
        rewrite_asserts(tree, src.encode(), path)
    return compile(tree, path, "exec")


def load_ported(name: str) -> types.ModuleType:
    """tests/<name>.py, ported, as the module ``_ported_<name>``, loaded
    once: a wrapper and the files that import it as a sibling share it,
    as they share the reference module under pytest."""
    mod_name = PREFIX + name
    mod = sys.modules.get(mod_name)
    if mod is None:
        path, src = ported_source(name)
        for dep in siblings(src):
            load_ported(dep)
        mod = types.ModuleType(mod_name)
        mod.__file__ = path
        sys.modules[mod_name] = mod
        try:
            exec(_compile(path, src), mod.__dict__)
        except BaseException:
            del sys.modules[mod_name]
            raise
    return mod


def run_reference(namespace: dict, name: str, exclude=(),
                  cpu_lanes: int = 1) -> None:
    """Load the ported file and copy its names into `namespace`.
    `exclude` names the cases that cannot run against the port
    ("Class::test_x" or "test_x"); the wrapper's docstring says why for
    each.  `cpu_lanes` is the port's lane count on the CPU when a
    pipeline's device_shards is unset (the reference's conftest gives
    JAX 8 CPU devices; a file whose cases count on them asks for 8)."""
    mod = load_ported(name)
    namespace.update((k, v) for k, v in vars(mod).items()
                     if not k.startswith("__"))
    namespace["_port_device"] = _port_device
    namespace["_port_cpu_lanes"] = cpu_lanes
    namespace["_port_excluded"] = tuple(exclude)
    for case in exclude:
        cls, _sep, meth = case.rpartition("::")
        if cls:
            delattr(namespace[cls], meth)
        else:
            del namespace[meth]


class OnTheCard:
    """pytest plugin: run the wrappers with the port's device on the
    card.  It also registers the reference's ``slow`` marker, for runs
    without ``tests/conftest.py`` (which imports JAX)."""

    def __init__(self, device: str = "cuda"):
        self.ceph_port_device = device

    def pytest_configure(self, config):
        config.addinivalue_line(
            "markers", "slow: long-running tests excluded from tier-1")


def device_for(config):
    """The torch device to run the port on: the card if an
    :class:`OnTheCard` plugin asked for it, else the CPU.  Raises if the
    card was asked for and there is none (never falls back to the
    CPU)."""
    import torch
    asked = [p.ceph_port_device for p in config.pluginmanager.get_plugins()
             if hasattr(p, "ceph_port_device")]
    device = torch.device(asked[0] if asked else "cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the reference suite was asked to run on the card, and no "
            "CUDA device is present")
    return device


@pytest.fixture(scope="module", autouse=True)
def _port_device(request):
    import ceph_tpu_torch
    from ceph_tpu_torch.ops import hbm_cache
    from ceph_tpu_torch.ops import pipeline as ec_pipeline
    prev = ceph_tpu_torch.set_device(device_for(request.config))
    prev_lanes = ec_pipeline.CPU_LANES
    ec_pipeline.CPU_LANES = getattr(request.module, "_port_cpu_lanes", 1)
    _stop_shared_pipeline(ec_pipeline)   # lanes are rebuilt at first use
    yield
    _stop_shared_pipeline(ec_pipeline)
    hbm_cache.get().clear()
    _join_warm_ups()
    ec_pipeline.CPU_LANES = prev_lanes
    ceph_tpu_torch.set_device(prev)


def _stop_shared_pipeline(ec_pipeline) -> None:
    """Stop the port's shared pipeline, and drop any method an earlier
    module set on the instance: `pipe.submit = spy` then `pipe.submit =
    orig` (or a monkeypatch of the instance, which restores the same
    way) leaves the bound method as an instance attribute, and a later
    module's spy on the class never sees a call."""
    pipe = ec_pipeline.get()
    pipe.stop()
    for name in [n for n in vars(pipe)
                 if callable(getattr(type(pipe), n, None))]:
        delattr(pipe, name)


def _join_warm_ups(timeout: float = 60.0) -> None:
    """Wait for the kernels' background warm-ups (threads named
    ``ec-*-warm``): one still inside torch when the interpreter exits
    aborts the process ("terminate called without an active
    exception") after its cases passed."""
    end = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith("ec-") and t.name.endswith("-warm"):
            t.join(max(0.0, end - time.monotonic()))
