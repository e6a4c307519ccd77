"""The reference's tests of the RGW multisite sync agent (tests/test_rgw_sync.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rgw_sync")
