"""The reference's tests of stripe math and batched object encode/decode
(osd/ecutil) (tests/test_ecutil.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_ecutil")
