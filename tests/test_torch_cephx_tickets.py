"""The reference's tests of the cephx ticket protocol and rotating
service keys (tests/test_cephx_tickets.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_cephx_tickets")
