"""The reference's tests of the observability surface
(tests/test_observability.py: the perf counter schemas, the EC pipeline's
perf dump with its mesh keys, the copy and QoS blocks, the admin socket
and op tracking), run against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_observability")
