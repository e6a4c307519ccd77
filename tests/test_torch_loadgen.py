"""The reference's tests of the seeded load harness (tests/test_loadgen.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_loadgen")
