"""The reference's tests of the mgr, the compressor framework and
cls_kvstore (tests/test_mgr_compressor.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_mgr_compressor")
