"""The reference's tests of the HBM-resident EC stripe cache and the
zero-copy transfer plane (tests/test_hbm_cache.py), run against
ceph_tpu_torch.

Not run here, each for reason (c): its channel's ``_fused_channel``
device fn picks the failing chip by ``device.id``, an attribute of a JAX
device that a torch.device lacks.  The port-side twin of each, on CPU
lanes, is in ``tests/test_torch_hbm_cache.py``:

- ``TestPipelineIntegration::test_encode_stages_entry_and_counts_transfer``:
  ``TestPipelineIntegration::test_encode_stages_entry_and_counts_transfer``;
- ``TestPipelineIntegration::test_split_sized_tagged_batch_still_stages``:
  ``TestPipelineIntegration::test_split_sized_tagged_batch_still_stages``;
- ``TestPipelineIntegration::test_quarantine_drops_lane_entries_and_redrains_bitexact``:
  ``TestPipelineIntegration::test_quarantine_drops_lane_entries_and_redrains_bitexact``;
- ``TestCostAwarePlacement::test_measured_faster_lane_overrides_least_loaded``
  and ``TestCostAwarePlacement::test_knob_off_restores_least_loaded``:
  ``TestCostAwarePlacement::test_cost_aware_placement`` (both knob
  settings).
"""

from _port_reference import run_reference

run_reference(globals(), "test_hbm_cache", exclude=(
    "TestPipelineIntegration::test_encode_stages_entry_and_counts_transfer",
    "TestPipelineIntegration::test_split_sized_tagged_batch_still_stages",
    "TestPipelineIntegration::"
    "test_quarantine_drops_lane_entries_and_redrains_bitexact",
    "TestCostAwarePlacement::test_measured_faster_lane_overrides_least_loaded",
    "TestCostAwarePlacement::test_knob_off_restores_least_loaded",
))
