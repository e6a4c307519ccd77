"""The reference's tests of the Swift dialect of the gateway (TempAuth, containers) (tests/test_rgw_swift.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rgw_swift")
