"""The reference's tests of the AuthMonitor and LogMonitor: the
paxos-replicated keyring and cluster log (tests/test_auth_log_mon.py),
run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_auth_log_mon")
