"""The reference's tests of EC partial-stripe appends
(tests/test_ec_append.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_ec_append")
