"""The reference's tests of RBD layering and image journaling (tests/test_rbd_clone.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rbd_clone")
