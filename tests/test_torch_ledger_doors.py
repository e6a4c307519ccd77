"""The reference's tests of the DurabilityLedger through the CephFS and RGW doors (tests/test_ledger_doors.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_ledger_doors")
