"""The reference's tests of multi-chip sharded EC dispatch (placement,
mega-batch splitting, per-lane quarantine and redrain;
tests/test_multichip_pipeline.py), run against ceph_tpu_torch on 8 CPU
lanes, as the reference runs on 8 virtual CPU devices.

Not run here, each for the reason named:

- (c) a JAX-only attribute: ``_ready_device_fn`` picks the failing chip
  by ``device.id``, an attribute of a JAX device that a torch.device
  lacks, so every case built on it is left out:
  ``test_sharded_split_bitexact_vs_single_device_and_oracle``,
  ``test_large_batch_splits_across_idle_lanes``,
  ``test_one_bad_chip_quarantines_lane_and_redrains`` and
  ``test_reset_devices_clears_quarantine``.  The port holds the same
  behaviour on CPU lanes in ``tests/test_torch_mesh_pipeline.py`` and
  ``tests/test_torch_pipeline.py``
  (``test_targeted_tpu_error_redrains_to_surviving_lane``,
  ``test_real_device_error_redrains_then_raises_when_no_lane_left``,
  ``test_cpu_lanes_follow_device_shards``).
- (b) and (c): ``test_all_chips_quarantined_falls_back_to_host_and_degrades``
  also reads ``device.id``, and pins the host fallback that the port
  forbids once every lane is lost; the port raises instead
  (``test_real_device_error_redrains_then_raises_when_no_lane_left``).
"""

from _port_reference import run_reference

run_reference(globals(), "test_multichip_pipeline", cpu_lanes=8, exclude=(
    "test_sharded_split_bitexact_vs_single_device_and_oracle",
    "test_large_batch_splits_across_idle_lanes",
    "test_one_bad_chip_quarantines_lane_and_redrains",
    "test_all_chips_quarantined_falls_back_to_host_and_degrades",
    "test_reset_devices_clears_quarantine",
))
