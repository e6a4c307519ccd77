"""The reference's tests of CephFS capabilities (client caching, MDS revokes) (tests/test_cephfs_caps.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_cephfs_caps")
