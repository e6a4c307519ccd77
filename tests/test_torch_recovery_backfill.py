"""The reference's tests of bounded PG-log recovery and backfill
(tests/test_recovery_backfill.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_recovery_backfill")
