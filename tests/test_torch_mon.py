"""The reference's tests of the monitors: election, paxos, commands and
map propagation (tests/test_mon.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_mon")
