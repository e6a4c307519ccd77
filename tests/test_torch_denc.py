"""The reference's tests of denc, the versioned wire and disk codec
(tests/test_denc.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_denc")
