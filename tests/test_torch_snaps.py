"""The reference's tests of self-managed snapshots on replicated pools
(tests/test_snaps.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_snaps")
