"""The reference's tests of PG split: pg_num raised on a loaded pool
(tests/test_pg_split.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_pg_split")
