"""The reference's tests of cluster-level fault injection through the
FaultSet registry (tests/test_chaos.py), run against ceph_tpu_torch on
8 CPU lanes, as the reference runs on 8 virtual CPU devices
(``TestTpuSingleChipQuarantine`` quarantines one of eight)."""

from _port_reference import run_reference

run_reference(globals(), "test_chaos", cpu_lanes=8)
