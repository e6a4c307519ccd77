"""The reference's tests of model-based randomized stress: a seeded op
sequence against a live cluster, checked against a dict model
(tests/test_stress_model.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_stress_model")
