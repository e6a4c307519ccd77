"""The reference's tests of the op tracing plane: spans, historic and
slow rings, trace ids across daemons, slow-op health and the flight
recorder (tests/test_optracker.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_optracker")
