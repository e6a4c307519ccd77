"""The reference's tests of scrub repair: corrupt and missing copies
heal back to clean (tests/test_scrub_repair.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_scrub_repair")
