"""The reference's tests of the cross-op EC dispatch pipeline
(coalescing, shape-bucket padding, futures, measured-routing
amortization and degrade draining; tests/test_pipeline.py), run against
ceph_tpu_torch.

Not run here, each for reason (b): it pins a host fallback that the
port forbids by design (a real device error with no lane left, a stall
or a result timeout raises; the port never serves such work from the
host).  Each behaviour is held the port's way by the case named:

- ``test_pipeline_device_error_drains_to_host`` and
  ``test_real_device_failure_degrades_and_drains`` (a raising device fn
  re-runs on the host): ``tests/test_torch_pipeline.py::
  test_real_device_error_redrains_then_raises_when_no_lane_left``;
- ``test_stall_latch_keeps_new_work_flowing`` (a wedged lane latches
  host-only dispatch): ``test_stalled_lane_raises_timeout``;
- ``test_pipelined_encode_self_serves_on_wedged_pipeline`` (a producer
  past RESULT_TIMEOUT encodes on the host):
  ``test_never_resolving_future_raises_timeout``;
- ``test_crc_channel_latches_host_after_device_error`` (the scrub
  channel latches to the host fold): ``test_failed_crc_warm_up_raises``
  and ``test_crc_channel_device_error_raises_and_does_not_latch``.
"""

from _port_reference import run_reference

run_reference(globals(), "test_pipeline", exclude=(
    "test_pipeline_device_error_drains_to_host",
    "test_real_device_failure_degrades_and_drains",
    "test_stall_latch_keeps_new_work_flowing",
    "test_pipelined_encode_self_serves_on_wedged_pipeline",
    "test_crc_channel_latches_host_after_device_error",
))
