"""The reference's tests of watch/notify and object classes
(tests/test_watch_cls.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_watch_cls")
