"""The reference's tests of the BufferList rope and the CTM2
data-segment wire path (tests/test_bufferlist.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_bufferlist")
