"""The reference's tests of the copy audit (tests/test_copy_audit.py: the
static scan of the port's hot-path files against their budgets, the
scanner, and the runtime copy counters of an EC encode), run against
ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_copy_audit")
