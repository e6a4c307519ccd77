"""The reference's tests of CRC32C: known vectors, seed chaining and the
GF(2) matrix form (tests/test_crc32c.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_crc32c")
