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
  batch_stripes=N       coalesce-size hint for the shared device
                        pipeline: at most N stripes fuse into one
                        dispatch for this codec's channels (validated
                        in init(); default: the pipeline's global cap)

Extras over the host plugins:
  * encode_batch / decode_batch: (B, k, L) stripe batches in one device
    pass — what the OSD's whole-object encode and rebuild feed;
  * encode_with_crcs: fused encode + per-chunk CRC32C scrub checksums,
    chunks cross host->device once and only parity and CRCs come back;
  * encode_stripes_with_crcs(_async) / decode_batch_async: routed
    through the shared cross-op pipeline (ceph_tpu_torch.ops.pipeline)
    — concurrent producers coalesce into shape-bucketed mega-batches
    that run the CUDA kernels on the lanes' streams.

A device error never turns into a host run here: only the injected
``faults`` device error degrades the codec to the host matrix path.  A
kernel or device failure that leaves no pipeline lane, a stalled lane
and a result that does not come within RESULT_TIMEOUT raise.
"""

from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from ..ops import crc32c as crc_mod
from ..ops import ec_kernels
from ..ops import pipeline as ec_pipeline
from ..utils import faults, optracker
from ..utils.dout import DoutLogger
from .interface import ErasureCodeError
from .matrix_codec import (REP_BYTES, TECHNIQUES, DeviceShape,
                           MatrixErasureCode, NumpyBackend, TorchBackend)
from .registry import ErasureCodePlugin


class _Done:
    """Already-computed result behind the async-handle interface."""

    __slots__ = ("_v",)

    def __init__(self, value):
        self._v = value

    def result(self, timeout=None):
        return self._v


def _wait(fut, what: str, chan, timeout):
    """The pipeline future's (path, outputs), or a TimeoutError naming
    the channel and the lane after `timeout` (default RESULT_TIMEOUT);
    the reference served the batch from the host instead."""
    if timeout is None:
        timeout = ec_pipeline.RESULT_TIMEOUT
    try:
        with optracker.span("ec.result_wait"):
            return fut.result(timeout)
    except FuturesTimeout:
        ec_pipeline.get().note_result_timeout()
        lane = getattr(fut, "ec_lane", "no lane yet")
        raise TimeoutError(
            f"EC pipeline {what} on channel {chan.key!r} not resolved "
            f"within {timeout:.0f}s ({lane})") from None


class _PipelinedEncode:
    """Future for one encode_stripes_with_crcs submission: resolves to
    ((S, k+m, L) chunks, (S, k+m) crcs) and bumps the codec's
    host/device pass counters by the path the batch actually took."""

    __slots__ = ("_codec", "_stripes", "_fut")

    def __init__(self, codec, stripes, fut):
        self._codec = codec
        self._stripes = stripes
        self._fut = fut

    @property
    def trace_phases(self) -> dict | None:
        """Pipeline phase stamps for the op tracer (attached to the raw
        future at resolve; None while unresolved)."""
        return getattr(self._fut, "trace_phases", None)

    def result_parts(self, timeout=None):
        """(stripes, parity, crcs) WITHOUT materializing the joined
        (S, k+m, L) array — the shard fan-out (ecutil.EncodeHandle) lays
        shards out straight from the parts."""
        chan = self._codec._encode_channel(self._stripes.shape[2])
        path, (parity, crcs) = _wait(self._fut, "encode", chan, timeout)
        key = ("device_stripe_passes" if path == "dev"
               else "host_stripe_passes")
        self._codec.stat_counters()[key] += 1
        return (self._stripes, np.asarray(parity),
                np.asarray(crcs, dtype=np.uint32))

    def result(self, timeout=None):
        stripes, parity, crcs = self.result_parts(timeout)
        return np.concatenate([stripes, parity], axis=1), crcs


class _PipelinedDecode:
    __slots__ = ("_fut", "_chan")

    def __init__(self, fut, chan):
        self._fut = fut
        self._chan = chan

    @property
    def trace_phases(self) -> dict | None:
        """The pipeline's per-item phase stamps (set at resolve)."""
        return getattr(self._fut, "trace_phases", None)

    def result(self, timeout=None):
        _path, (out,) = _wait(self._fut, "decode", self._chan, timeout)
        return np.asarray(out)


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
        # op workers, scrub and recovery threads all share one cached
        # codec: channel-cache access is locked (the eviction sweep
        # iterates while others insert)
        self._channels: dict[tuple, ec_pipeline.PipelineChannel] = {}
        self._chan_lock = threading.Lock()

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
        self._channels = {}     # matrices/geometry change under us
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

    # -- shared-pipeline channels ------------------------------------------
    #
    # One channel per (kind, chunk length): items from every producer
    # concatenate into mega-batches; the channel's callbacks carry the
    # degrade guard (route), the warm-gated per-device tensor fn
    # (device_fn — the pipeline passes the lane's device and readiness
    # is per device), the bit-identical host fn (host_fn, for cold
    # shapes and the degraded codec), the measured-routing EMA feed
    # (record), and on_error — which fires only once injected faults
    # have quarantined EVERY lane.

    def _route(self, nbytes: int) -> bool:
        if self.degraded:
            return False
        if faults.get().tpu_error():
            self._degrade("injected device error")
            return False
        b = self.backend
        return isinstance(b, TorchBackend) and b.use_device(nbytes)

    def _on_device_error(self, e: Exception) -> None:
        self._degrade(f"{type(e).__name__}: {e}")

    def _record(self, path: str, nbytes: int, secs: float,
                depth: int = 1, device=None) -> None:
        b = self.backend
        if isinstance(b, TorchBackend):
            b.record(path, nbytes, secs, depth, device=device)

    def _host_backend(self):
        return getattr(self.backend, "_host", self.backend)

    def _encode_channel(self, L: int) -> ec_pipeline.PipelineChannel:
        with self._chan_lock:
            chan = self._channels.get(("enc", L))
        if chan is not None:
            return chan
        matrix = self.coding_matrix

        def host_fn(batch):
            # CRCs fold over the data and parity shards as views
            parity = np.asarray(
                self._host_backend().apply_bytes(matrix, batch))
            B, k, CL = batch.shape
            pm = parity.shape[1]
            crcs = np.empty((B, k + pm), dtype=np.uint32)
            crcs[:, :k] = crc_mod.crc32c_batch(
                batch.reshape(B * k, CL)).reshape(B, k)
            crcs[:, k:] = crc_mod.crc32c_batch(
                parity.reshape(B * pm, CL)).reshape(B, pm)
            return parity, crcs

        def device_fn(padded, device=None):
            b = self.backend
            if self.degraded or not isinstance(b, TorchBackend):
                return None
            fn = b.fused_fn_if_ready(matrix, tuple(padded.shape), device)
            if fn is None:
                return None     # background warm-up; host serves
            return fn(padded)

        def mesh_fn(batch, plane, donate=False, keep_resident=False):
            # one mega-batch with its chunk length split over the
            # plane's devices: host outputs equal to host_fn's, or None
            # while the runner warms up (the batch then row-splits on
            # the lanes, as a cold device_fn does).  A donated input is
            # released after the kernels instead of kept resident.
            b = self.backend
            if self.degraded or not isinstance(b, TorchBackend):
                return None
            run = b.mesh_fn_if_ready(matrix, tuple(batch.shape),
                                     plane.key())
            if run is None:
                return None
            parity, crcs, resident = run(
                batch, keep_resident=keep_resident and not donate)
            return (parity, crcs), resident

        chan = ec_pipeline.PipelineChannel(
            key=("enc", id(self), L),
            host_fn=host_fn, device_fn=device_fn, route=self._route,
            on_error=self._on_device_error, record=self._record,
            max_coalesce=self.batch_stripes, mesh_fn=mesh_fn)
        with self._chan_lock:
            return self._channels.setdefault(("enc", L), chan)

    def _decode_channel(self, want: list[int], present: list[int],
                        rows: np.ndarray,
                        L: int) -> ec_pipeline.PipelineChannel:
        # id(self) in the key: two codecs with identical decode
        # geometry must not share a queue (callbacks are per codec)
        key = ("dec", id(self), tuple(want), tuple(present), L)
        with self._chan_lock:
            chan = self._channels.get(key)
        if chan is not None:
            return chan

        def host_fn(batch):
            return (np.asarray(
                self._host_backend().apply_bytes(rows, batch)),)

        def device_fn(padded, device=None):
            b = self.backend
            if self.degraded or not isinstance(b, TorchBackend):
                return None
            fn = b.device_fn_if_ready("bytes", rows, (),
                                      tuple(padded.shape), device)
            if fn is None:
                return None
            return (fn(padded),)

        chan = ec_pipeline.PipelineChannel(
            key=key, host_fn=host_fn, device_fn=device_fn,
            route=self._route, on_error=self._on_device_error,
            record=self._record, max_coalesce=self.batch_stripes)
        with self._chan_lock:
            if len(self._channels) > 128:
                # bound the decode-pattern set only
                for k in [k for k in self._channels if k[0] == "dec"]:
                    del self._channels[k]
            return self._channels.setdefault(key, chan)

    def device_shapes(self, stripes, unit: int) -> list:
        """Byte-matrix techniques: the fused encode and the rebuild
        decodes of 1..m lost chunks at each (S, k, unit) batch, through
        the pipeline's lanes.  Packet and bit-matrix techniques encode
        and decode those batches synchronously (apply_*)."""
        be = self.device_backend()
        if be is None:
            return []
        batches = [(S, self.k, unit) for S in stripes]
        decodes = [self._lost_rows(r) for r in range(1, self.m + 1)]
        if self.rep != REP_BYTES:
            return [s for mat in [self.coding_matrix, *decodes]
                    for shape in batches
                    for s in self._sync_shapes(mat, shape)]
        return [DeviceShape(be, "fused", self.coding_matrix, (unit,),
                            shape, lanes=True) for shape in batches] + \
            [DeviceShape(be, "bytes", rows, (), shape, lanes=True)
             for rows in decodes for shape in batches]

    # -- batched stripe API (device-native entry points) -------------------

    def encode_stripes_with_crcs_async(self, stripes, cache=None,
                                       qos=None, arena=None):
        """Submit an (S, k, L) stripe batch to the shared pipeline.

        Returns a handle whose .result() yields ((S, k+m, L) chunks,
        (S, k+m) uint32 crcs) — identical to encode_stripes_with_crcs.
        `cache` (an ops.hbm_cache.CacheIntent) keeps the batch's
        device-resident stripes in the HBM cache when the dispatch
        lands on a card; `qos` names the service class (pool) the
        dispatch-lane picker schedules it under; `arena` is the
        ops.pipeline.StagingArena the stripes were staged into."""
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        if stripes.ndim != 3 or stripes.shape[1] != self.k:
            raise ErasureCodeError(f"want (S, {self.k}, L), "
                                   f"got {stripes.shape}")
        if self.rep != REP_BYTES:
            call = lambda: super(ErasureCodeTpu, self) \
                .encode_stripes_with_crcs(stripes)
            return _Done(self._guarded(call, call))
        chan = self._encode_channel(stripes.shape[2])
        fut = ec_pipeline.get().submit(chan, stripes, cache=cache,
                                       qos=qos, arena=arena)
        return _PipelinedEncode(self, stripes, fut)

    def encode_stripes_with_crcs(self, stripes) -> tuple:
        """(S, k, L) -> ((S, k+m, L) chunks, (S, k+m) uint32 crcs) in one
        fused device pass through the pipeline (host path while the
        shape warms up)."""
        return self.encode_stripes_with_crcs_async(stripes).result()

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, L) uint8 -> (B, m, L) parity in one device pass."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ErasureCodeError(f"want (B, {self.k}, L), got {data.shape}")
        return self._apply(self.coding_matrix, data)

    def decode_batch(self, want: list[int], present: list[int],
                     chunks: np.ndarray) -> np.ndarray:
        """chunks: (B, len(present), L) surviving chunks -> (B, len(want), L)."""
        return self.decode_batch_async(want, present, chunks).result()

    def decode_batch_async(self, want: list[int], present: list[int],
                           chunks: np.ndarray, qos: str | None = None):
        """Pipeline-coalesced shard rebuild: concurrent recovery ops
        reconstructing with the same decode pattern share a dispatch.
        `qos` names the dmClock class the decode lane bills against."""
        want, present = list(want), list(present)
        rows = self._decode_rows(want, present)
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        if self.rep != REP_BYTES or chunks.ndim != 3 or \
                rows.shape[0] == 0:
            return _Done(self._apply(rows, chunks))
        chan = self._decode_channel(want, present, rows, chunks.shape[2])
        return _PipelinedDecode(
            ec_pipeline.get().submit(chan, chunks, qos=qos), chan)

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
            be = self.backend
            return be._on_host(be._fn("fused", self.coding_matrix, L))(data)

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
