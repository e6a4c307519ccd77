"""The reference's tests of RBD block images and the rbd command-line tool (tests/test_rbd.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rbd")
