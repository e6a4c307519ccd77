"""The reference's tests of divergent-log peering: the primary killed
mid-EC-write, the survivors converge without losing acked data
(tests/test_peering.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_peering")
