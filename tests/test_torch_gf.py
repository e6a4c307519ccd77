"""The reference's tests of the GF(2^8) core: field axioms, matrix
constructions and bit-matrix expansion (tests/test_gf.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_gf")
