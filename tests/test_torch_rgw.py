"""The reference's tests of the RGW S3 gateway's bucket and object REST workflow (tests/test_rgw.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rgw")
