"""Whole runs on the CPU at the `tiny` size: a sound run is correct; a
run whose timed path is broken underneath, or whose control serves in
the program's place, is not.

Each fault is planted in the port where the answer is produced, as a
later change could plant it: a step that returns its state unchanged
(the parity or the rebuilt chunk never written), half of the batch left
out (only the first half of the stripes computed), and an answer
altered (one byte).  The exchange between chips has no fault here: every
cell runs on one chip.
"""

import numpy as np
import pytest

from ecbench import run

SEED = (1 << 31) + 12345


def _cell(tiny_root, traffic, **kw):
    return run.run_cell(tiny_root, f"tiny.{traffic}", SEED, 3.0, False,
                        card=False, **kw)


@pytest.mark.parametrize("traffic", ["write", "degraded_read"])
def test_a_sound_run_is_correct(tiny_root, cpu_port, traffic):
    out = _cell(tiny_root, traffic)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {"setup_s"}
    assert out["checks"]["checked_ops"]["value"] >= 4


@pytest.mark.parametrize("traffic", ["write", "degraded_read"])
def test_the_control_is_not_correct(tiny_root, cpu_port, traffic):
    out = _cell(tiny_root, traffic, control=True)
    assert not out["correct"]
    bad = {k: c["value"] for k, c in out["checks"].items() if "max" in c}
    assert sum(bad.values()) > 0


def _unchanged(a):
    a[:] = 0


def _half(a):
    a[a.shape[0] // 2:] = 0


def _one_byte(a):
    a.reshape(-1)[a.size // 3] ^= 0x5A


FAULTS = {"state_unchanged": _unchanged, "half_the_batch": _half,
          "answer_altered": _one_byte}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_encode_is_not_correct(tiny_root, cpu_port, monkeypatch,
                                        fault):
    from ceph_tpu_torch.erasure import plugin_tpu
    orig = plugin_tpu._PipelinedEncode.result_parts

    def broken(self, timeout=None):
        stripes, parity, crcs = orig(self, timeout)
        parity = np.array(parity)
        FAULTS[fault](parity)
        return stripes, parity, crcs

    monkeypatch.setattr(plugin_tpu._PipelinedEncode, "result_parts", broken)
    out = _cell(tiny_root, "write")
    assert not out["correct"]
    assert out["checks"]["bad_shard_bytes"]["value"] > 0


def test_altered_crcs_are_not_correct(tiny_root, cpu_port, monkeypatch):
    from ceph_tpu_torch.erasure import plugin_tpu
    orig = plugin_tpu._PipelinedEncode.result_parts

    def broken(self, timeout=None):
        stripes, parity, crcs = orig(self, timeout)
        crcs = np.array(crcs)
        crcs[-1, -1] ^= 1
        return stripes, parity, crcs

    monkeypatch.setattr(plugin_tpu._PipelinedEncode, "result_parts", broken)
    out = _cell(tiny_root, "write")
    assert not out["correct"]
    assert out["checks"]["bad_stripe_crcs"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_decode_is_not_correct(tiny_root, cpu_port, monkeypatch,
                                        fault):
    from ceph_tpu_torch.erasure import plugin_tpu
    orig = plugin_tpu._PipelinedDecode.result

    def broken(self, timeout=None):
        out = np.array(orig(self, timeout))
        FAULTS[fault](out)
        return out

    monkeypatch.setattr(plugin_tpu._PipelinedDecode, "result", broken)
    out = _cell(tiny_root, "degraded_read")
    assert not out["correct"]
    assert out["checks"]["bad_object_bytes"]["value"] > 0
