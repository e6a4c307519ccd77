"""The reference's tests of the messenger: delivery, ordering, loopback,
reconnect and injection (tests/test_msg.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_msg")
