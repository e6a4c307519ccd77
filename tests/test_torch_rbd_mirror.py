"""The reference's tests of the rbd-mirror journal replay daemon (tests/test_rbd_mirror.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_rbd_mirror")
