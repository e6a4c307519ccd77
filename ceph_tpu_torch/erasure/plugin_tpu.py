"""The `tpu` erasure-code plugin on PyTorch — the north-star backend.

Registered under the plugin name stored pool profiles carry (``tpu``,
the default of ``ceph_tpu``'s ``osd_pool_default_erasure_code_profile``)
so existing pools resolve unchanged.  Every byte-matrix technique runs
its region math on the package device: the hand-written CUDA kernels of
``ops/cuda_ec.py`` on the card (the plain PyTorch versions on a CPU
device), behind TorchBackend's measured host/device routing.

Profile keys beyond the standard k/m/w/technique/packetsize:
  compute=int8|bf16     accumulation dtype of the plain PyTorch
                        versions (default int8); the CUDA kernels are
                        exact whatever it says
  host_cutover=N        pin routing: payloads of >= N bytes go to the
                        device, smaller ones to the host kernels
  batch_stripes=N       coalesce-size hint kept for profile
                        compatibility (validated in init())

Extras over the host plugins:
  * encode_batch / decode_batch: (B, k, L) stripe batches in one device
    pass — what the OSD's whole-object encode and rebuild feed;
  * encode_stripes_with_crcs / encode_with_crcs: fused encode +
    per-chunk CRC32C scrub checksums, chunks cross host->device once
    and only parity and CRCs come back.
Both run synchronously on TorchBackend.
"""

from __future__ import annotations

import numpy as np

from ..ops import crc32c as crc_mod
from ..ops import ec_kernels
from ..utils import faults
from ..utils.dout import DoutLogger
from .interface import ErasureCodeError
from .matrix_codec import (REP_BYTES, TECHNIQUES, MatrixErasureCode,
                           NumpyBackend, TorchBackend)
from .registry import ErasureCodePlugin


class ErasureCodeTpu(MatrixErasureCode):
    DEFAULT_K = 8
    DEFAULT_M = 3

    def __init__(self):
        super().__init__(backend=TorchBackend(), techniques=dict(TECHNIQUES))
        # device-failure degrade: an injected device error (faults
        # tpu_device_error) swaps the backend for the pure host
        # matrix-codec path (same matrices, same bytes) and raises a
        # health warning.  Sticky until the daemon restarts, like a
        # failed NIC offload.  A real kernel or device error raises.
        self.degraded = False
        self.degrade_reason = ""
        self.batch_stripes: int | None = None

    def init(self, profile):
        compute = profile.get("compute", ec_kernels.DEFAULT_COMPUTE)
        if compute not in ec_kernels._COMPUTE_DTYPES:
            raise ErasureCodeError(f"unknown compute={compute!r}")
        self.backend = TorchBackend(compute)
        if "host_cutover" in profile:
            self.backend.HOST_CUTOVER_BYTES = int(profile["host_cutover"])
        if "batch_stripes" in profile:
            n = self.profile_int(profile, "batch_stripes", 0)
            if n < 1:
                raise ErasureCodeError(
                    f"batch_stripes={profile['batch_stripes']!r} "
                    "must be an integer >= 1")
            self.batch_stripes = n
        else:
            self.batch_stripes = None
        self.degraded = False
        self.degrade_reason = ""
        super().init(profile)

    # -- device-failure degrade --------------------------------------------

    def _degrade(self, reason: str) -> None:
        if self.degraded:
            return
        self.degraded = True
        self.degrade_reason = reason
        self.backend = NumpyBackend()   # the pure matrix_codec path
        self._fast1 = self._build_fast1()   # size cap was device-tied
        self.stat_counters()["device_degraded"] = 1
        DoutLogger("erasure", "tpu").warn(
            "device error (%s): degrading to matrix-codec host path",
            reason)
        from .registry import registry as _registry
        _registry.note_degraded("tpu", reason)

    def _guarded(self, device_call, host_call):
        """Run `device_call` unless the codec is (or becomes) degraded
        by an injected device error, in which case `host_call` serves.
        An exception from the device call propagates: a kernel that
        fails to build or launch is an error, never a silent CPU run."""
        if not self.degraded and faults.get().tpu_error():
            self._degrade("injected device error")
        return host_call() if self.degraded else device_call()

    def _apply(self, matrix: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        call = lambda: super(ErasureCodeTpu, self)._apply(matrix, chunks)
        return self._guarded(call, call)

    # -- batched stripe API (device-native entry points) -------------------

    def encode_stripes_with_crcs(self, stripes) -> tuple:
        """(S, k, L) -> ((S, k+m, L) chunks, (S, k+m) uint32 crcs) in one
        fused device pass (host path while the shape warms up)."""
        call = lambda: super(ErasureCodeTpu, self).encode_stripes_with_crcs(
            stripes)
        return self._guarded(call, call)

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, L) uint8 -> (B, m, L) parity in one device pass."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ErasureCodeError(f"want (B, {self.k}, L), got {data.shape}")
        return self._apply(self.coding_matrix, data)

    def decode_batch(self, want: list[int], present: list[int],
                     chunks: np.ndarray) -> np.ndarray:
        """chunks: (B, len(present), L) surviving chunks -> (B, len(want), L)."""
        rows = self._decode_rows(list(want), list(present))
        return self._apply(rows, np.ascontiguousarray(chunks,
                                                      dtype=np.uint8))

    def encode_with_crcs(self, data: np.ndarray):
        """(B, k, L) -> (parity (B, m, L), crcs (B, k+m) uint32), fused.

        CRCs are CRC32C(seed 0) of each chunk; combine with a running
        object CRC via ceph_tpu_torch.ops.crc32c.crc32c_combine on the
        host.
        """
        if self.rep != REP_BYTES:
            raise ErasureCodeError(
                "fused encode+crc supports byte-matrix techniques only")
        data = np.asarray(data, dtype=np.uint8)
        B, k, L = data.shape

        def device():
            # the backend's fused fn: upload, one pass, parity + CRCs
            # back (counted in bytes_h2d / bytes_d2h)
            return self.backend._fn("fused", self.coding_matrix, L)(data)

        def host():
            # plain matmul + batched table CRCs, same bytes
            parity = np.asarray(self._apply(self.coding_matrix, data))
            allc = np.ascontiguousarray(
                np.concatenate([data, parity], axis=1))
            km = allc.shape[1]
            crcs = crc_mod.crc32c_batch(
                allc.reshape(B * km, L)).reshape(B, km)
            return parity, crcs

        return self._guarded(device, host)


class ErasureCodeTpuPlugin(ErasureCodePlugin):
    def factory(self, profile):
        return ErasureCodeTpu()


def __erasure_code_init__(registry, name):
    registry.add(name, ErasureCodeTpuPlugin())
