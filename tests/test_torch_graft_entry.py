"""ceph_tpu_torch.graft_entry against __graft_entry__, on the CPU: the
port-side twin of tests/test_multichip.py.

The reference's dry run shards its step over conftest's virtual
8-device CPU platform; the port's runs on n CPU members under
``set_device("cpu")``.  Both start from the same arange data, and their
data, parity, CRCs and matrix must be equal, byte for byte, and pass the
port's own host oracle.  The reference's fallback case
(``test_fallback_after_backend_init``: a jax backend initialised with too
few devices reruns the step in a subprocess) has no counterpart: the
port's members share the cards or the CPU there are, in process.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
import ceph_tpu_torch
from ceph_tpu_torch import graft_entry as graft


@pytest.fixture(autouse=True)
def _cpu():
    prev = ceph_tpu_torch.set_device("cpu")
    yield
    ceph_tpu_torch.set_device(prev)


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_multichip(n):
    r = graft.dryrun_multichip(n)
    assert r == {"devices": n, "oracle": True, "mode": "cpu"}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_run_sharded_matches_reference(n):
    ours = graft._run_sharded(n)
    theirs = jgraft._run_sharded(n)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_entry_matches_reference():
    fn, args = graft.entry()
    assert args[0].device == torch.device("cpu")
    parity, crcs = fn(*args)
    jfn, jargs = jgraft.entry()
    jparity, jcrcs = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(parity.numpy(), np.asarray(jparity))
    np.testing.assert_array_equal(
        crcs.view(torch.int32).numpy().view(np.uint32), np.asarray(jcrcs))


def test_members_stay_on_the_package_device():
    assert graft.members(8) == [torch.device("cpu")] * 8


def test_full_batch_oracle_equality():
    """Every stripe's parity and every chunk CRC of the sharded step
    equal the host oracle, and a corrupted parity byte is caught."""
    data, parity, crcs, matrix = graft._run_sharded(8)
    assert data.shape[0] >= 2
    graft.verify_against_oracle(data, parity, crcs, matrix)
    parity = parity.copy()
    parity[1, 2, 3] ^= 1
    with pytest.raises(AssertionError):
        graft.verify_against_oracle(data, parity, crcs, matrix)
