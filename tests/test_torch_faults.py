"""The reference's tests of the FaultSet: rule scoping, seed
determinism, the injectargs and admin-socket surface and the layer
hooks' fast paths (tests/test_faults.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_faults")
