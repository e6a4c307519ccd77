"""The reference's tests of out-of-order sub-op handling: ordered-apply
parking and the superseded-skip heal (tests/test_superseded_heal.py),
run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_superseded_heal")
