"""The reference's tests of the mixed front-door storm drill (tests/test_frontdoor_storm.py), run
against ceph_tpu_torch on the CPU."""

from _port_reference import run_reference

run_reference(globals(), "test_frontdoor_storm")
