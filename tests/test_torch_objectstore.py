"""The reference's ObjectStore conformance suite over every backend
(tests/test_objectstore.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_objectstore")
