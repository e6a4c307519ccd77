"""The reference's tests of the distributed flat B-tree (tests/test_kv_btree.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_kv_btree")
