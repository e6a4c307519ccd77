"""The reference's tests of the erasure-code plugin framework
(tests/test_erasure.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_erasure")
