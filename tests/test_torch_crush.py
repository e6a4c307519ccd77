"""The reference's tests of CRUSH: bit-exact hashes, distribution
quality and stability (tests/test_crush.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_crush")
