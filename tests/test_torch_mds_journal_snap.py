"""The reference's tests of MDS journaling and CephFS snapshots (tests/test_mds_journal_snap.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_mds_journal_snap")
