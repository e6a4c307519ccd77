"""The reference's tests of the event-loop messenger: wire identity with
the blocking stack, cephx, lossless resend, partial writes, tracing and
connection churn (tests/test_async_msgr.py), run against
ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_async_msgr")
