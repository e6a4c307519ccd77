"""The reference's tests of the end-to-end cluster: the minimum system
slice (tests/test_cluster.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_cluster")
