"""The reference's tests of the wire and disk format non-regression
corpus (tests/test_wire_corpus.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_wire_corpus")
