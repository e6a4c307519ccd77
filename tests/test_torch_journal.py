"""The reference's tests of the client-side journal library and the OSD journal (tests/test_journal.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_journal")
