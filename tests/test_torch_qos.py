"""The reference's tests of per-pool QoS: dmClock tags, the QoS op
queue, the EC pipeline's tenant picks and the noisy-neighbor drill
(tests/test_qos.py), run against ceph_tpu_torch."""

from _port_reference import run_reference

run_reference(globals(), "test_qos")
