"""The reference's tests of striper extent math, aio and striped-object
I/O (tests/test_striper.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_striper")
