"""The reference's tests of cache tiering: writeback promote, flush,
whiteout and evict, and the mon's tiering guards
(tests/test_cache_tier.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_cache_tier")
