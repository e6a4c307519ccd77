"""The reference's tests of the foundation utils: config observers,
throttle, counters and pools (tests/test_utils.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_utils")
