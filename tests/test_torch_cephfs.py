"""The reference's tests of the CephFS client and MDS metadata ops (tests/test_cephfs.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_cephfs")
