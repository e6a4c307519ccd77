"""The reference's tests of the device transforms against numpy ground
truth (tests/test_ec_kernels.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_ec_kernels")
