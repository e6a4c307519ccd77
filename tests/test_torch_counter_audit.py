"""The reference's tests of the counter audit (tests/test_counter_audit.py:
every perf counter ceph_tpu_torch declares or increments is named by
tests/test_observability.py, and the scanner itself), run against
ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_counter_audit")
