"""The reference's tests of the encode-bytes non-regression corpus
(tests/test_corpus.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_corpus")
