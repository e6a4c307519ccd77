"""The reference's tests of the multi-rank MDS (subtree migration, balancer) (tests/test_mds_multirank.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_mds_multirank")
