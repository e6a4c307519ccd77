"""The reference's tests of serving during repair: client ops block on
recovery pulls instead of serving stale bytes
(tests/test_serve_during_repair.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_serve_during_repair")
