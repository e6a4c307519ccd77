"""The reference's tests of librbd's ObjectCacher (tests/test_object_cacher.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_object_cacher")
