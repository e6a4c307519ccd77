"""The reference's tests of mon health and PGMap aggregation, paxos trim
and full sync (tests/test_mon_health.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_mon_health")
