"""The reference's tests of the PGLog units: find_best_info ordering,
divergence math, merge_log and the rewind core (tests/test_pglog.py),
run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_pglog")
