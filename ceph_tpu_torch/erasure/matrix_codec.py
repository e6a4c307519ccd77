"""Shared machinery for matrix-based erasure codes (RS / Cauchy families).

The jerasure, isa and tpu plugins all reduce to: build an (m x k) coding
matrix over GF(2^8) for a named technique, encode as matrix x data, decode
by inverting the surviving generator rows.  This module holds the
technique table, the decode-matrix planner + cache, and two compute
backends over the same representation:

  * NumpyBackend — exact host reference (the correctness oracle, analog
    of the reference's gf-complete scalar path);
  * TorchBackend — batched device transforms: the hand-written CUDA
    kernels of ceph_tpu_torch.ops.cuda_ec on the card (the north-star
    device path), the plain PyTorch versions on a CPU device.

Two chunk representations, matching the reference's two code families
(src/erasure-code/jerasure/ErasureCodeJerasure.h:91-259):

  * "bytes"   — chunk byte i is a GF(2^8) symbol (reed_sol_van,
                reed_sol_r6_op, isa techniques);
  * "packets" — jerasure bitmatrix layout: chunk = super-blocks of w
                packets of `packetsize` bytes, XOR schedule over packets
                (cauchy_orig, cauchy_good).  Chunk bytes are bit-identical
                to the reference technique's packetized output.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..ops import gf
from ..ops import pipeline as ec_pipeline
from .interface import CHUNK_ALIGN, ErasureCode, ErasureCodeError

REP_BYTES = "bytes"
REP_PACKETS = "packets"
REP_BITS = "bits"        # native GF(2) bit-matrix (liberation family)


# ---------------------------------------------------------------------------
# Technique table: name -> (matrix builder, representation)
# ---------------------------------------------------------------------------

def _rs_van(k, m, w, packetsize):
    return gf.reed_sol_van_matrix(k, m)


def _rs_r6(k, m, w, packetsize):
    if m != 2:
        raise ErasureCodeError("reed_sol_r6_op requires m=2")
    return gf.reed_sol_r6_matrix(k)


def _cauchy_orig(k, m, w, packetsize):
    return gf.cauchy_orig_matrix(k, m)


def _cauchy_good(k, m, w, packetsize):
    return gf.cauchy_good_matrix(k, m)


def _isa_rs(k, m, w, packetsize):
    return gf.isa_rs_matrix(k, m)


def _isa_cauchy(k, m, w, packetsize):
    return gf.isa_cauchy_matrix(k, m)


def _liberation(k, m, w, packetsize):
    if m != 2:
        raise ErasureCodeError("liberation requires m=2")
    try:
        return gf.liberation_bitmatrix(k, w)
    except ValueError as e:
        raise ErasureCodeError(str(e))


def _blaum_roth(k, m, w, packetsize):
    if m != 2:
        raise ErasureCodeError("blaum_roth requires m=2")
    try:
        return gf.blaum_roth_bitmatrix(k, w)
    except ValueError as e:
        raise ErasureCodeError(str(e))


def _liber8tion(k, m, w, packetsize):
    if m != 2:
        raise ErasureCodeError("liber8tion requires m=2")
    if w != 8:
        raise ErasureCodeError("liber8tion requires w=8")
    try:
        return gf.liber8tion_bitmatrix(k)
    except ValueError as e:
        raise ErasureCodeError(str(e))


TECHNIQUES: dict[str, tuple] = {
    "reed_sol_van": (_rs_van, REP_BYTES),
    "reed_sol_r6_op": (_rs_r6, REP_BYTES),
    "cauchy_orig": (_cauchy_orig, REP_PACKETS),
    "cauchy_good": (_cauchy_good, REP_PACKETS),
    # minimal-density RAID-6 bit-matrix family
    # (ErasureCodeJerasure.h:176-259)
    "liberation": (_liberation, REP_BITS),
    "blaum_roth": (_blaum_roth, REP_BITS),
    "liber8tion": (_liber8tion, REP_BITS),
    # ISA-L matrix semantics exposed as techniques of the tpu plugin
    "isa_reed_sol_van": (_isa_rs, REP_BYTES),
    "isa_cauchy": (_isa_cauchy, REP_BYTES),
}

# techniques whose natural word size is not 8
TECH_DEFAULT_W = {"liberation": 7, "blaum_roth": 6, "liber8tion": 8}

# TorchBackend fn kind of each chunk representation
DEVICE_KIND = {REP_BYTES: "bytes", REP_PACKETS: "packets", REP_BITS: "bits"}


class DeviceShape(NamedTuple):
    """One device call a codec can make: warm it with
    ``backend.device_fn_if_ready(kind, matrix, extra, shape, device)``.
    `lanes`: the call goes through the dispatch pipeline, so it is
    warmed on every lane's device; otherwise it is a synchronous
    ``apply_*`` call on the backend's own device."""

    backend: "TorchBackend"
    kind: str
    matrix: np.ndarray
    extra: tuple
    shape: tuple
    lanes: bool = False


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class NumpyBackend:
    """Exact host math (native C++ region kernels when built, numpy
    otherwise); used by the jerasure/isa oracle plugins."""

    def apply_bytes(self, matrix: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        from .. import native
        if chunks.ndim == 2:
            out = native.gf_encode(matrix, chunks)
            if out is not None:
                return out
            return gf.encode_np(matrix, chunks)
        out = native.gf_encode_batch(matrix, chunks)
        if out is not None:
            return out
        return np.stack([gf.encode_np(matrix, c) for c in chunks])

    def apply_packets(self, matrix: np.ndarray, chunks: np.ndarray,
                      w: int, packetsize: int) -> np.ndarray:
        return self.apply_bits(gf.expand_bitmatrix(matrix, w), chunks,
                               w, packetsize)

    def apply_bits(self, bits: np.ndarray, chunks: np.ndarray,
                   w: int, packetsize: int) -> np.ndarray:
        from .. import native

        def one(c):
            out = native.bitmatrix_encode(bits, c, w, packetsize)
            if out is None:
                out = gf.bitmatrix_encode_np(bits, c, w, packetsize)
            return out

        if chunks.ndim == 3:
            return np.stack([one(c) for c in chunks])
        return one(chunks)


class TorchBackend:
    """Batched device transforms on the package device; one callable
    per (matrix, kind) cached.

    On a CUDA device the byte transform and the fused encode+CRC pass
    launch the hand-written kernels of ``ops/cuda_ec.py``; the packet
    and bit-matrix transforms run the plain PyTorch versions of
    ``ops/ec_kernels.py`` on the device.  The fns (``device_fn_if_ready``,
    ``fused_fn_if_ready``) are tensor-level: a uint8 tensor on the device
    in, tensors on that device out — what the dispatch pipeline's lanes
    launch on their streams.  The synchronous numpy paths
    (``apply_bytes`` and friends) wrap them with ``_on_host``: chunks
    upload to the device, and only the outputs come back (parity and
    CRCs, never the data shards), counted in ``bytes_h2d`` /
    ``bytes_d2h``.

    Host/device routing is MEASURED, not hardcoded: per size bucket
    (power of two of payload bytes) the backend keeps an EMA of observed
    seconds-per-byte for each path, routes to the faster one, and
    occasionally re-probes the loser so the decision tracks reality.
    A profile can still pin a fixed threshold via host_cutover
    (HOST_CUTOVER_BYTES).
    """

    # fixed-threshold fallback when measurement is disabled by profile
    HOST_CUTOVER_BYTES: int | None = None
    # never dispatch tiny payloads: a device round-trip costs tens of
    # microseconds while the native host kernel finishes a 4KiB-class
    # stripe in ~1.5us — and even the periodic re-probe of the losing
    # path would dominate at these sizes
    MIN_DEVICE_BYTES = 1 << 16
    PROBE_EVERY = 64

    def __init__(self, compute: str | None = None, device=None):
        import threading

        from .. import get_device
        from ..ops import cuda_ec, ec_kernels
        self._ek = ec_kernels
        self._cuda = cuda_ec
        self.compute = compute or ec_kernels.DEFAULT_COMPUTE
        self.device = torch.device(device) if device is not None \
            else get_device()
        self._fns: dict[tuple, object] = {}
        self._host = NumpyBackend()
        # bytes crossing host<->device (the fused pass fetches parity
        # and CRCs only: ec_kernels.encode_readback_bytes)
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        # (path, bucket) -> {"spb": ema sec/byte, "n": samples}
        self._perf: dict[tuple[str, int], dict] = {}
        # (bucket, lane index) -> per-lane service-time EMA (fed by the
        # pipeline's collect path; cost-aware placement signal)
        self._dev_perf: dict[tuple[int, int], dict] = {}
        self._calls = 0
        # a (kind, matrix dims, batch shape) is servable only after the
        # kernel library is built and one launch at that shape
        # succeeded.  Warm-ups run
        # on a background thread so an OSD op never blocks on an nvcc
        # build — until ready the call is served by the host kernels.
        # A failed warm-up is kept per shape and raised by every later
        # dispatch of that shape: a broken card never turns into a
        # silent host path.
        self._ready: set = set()
        self._warming: set = set()
        self._warm_failed: dict[tuple, Exception] = {}
        self._warm_lock = threading.Lock()

    def _upload(self, arr) -> torch.Tensor:
        t = self._ek.as_u8(arr, self.device)
        self.bytes_h2d += t.numel()
        return t

    def _on_host(self, fn):
        """numpy in -> device fn -> numpy out (tuples element-wise)."""

        def call(arr):
            out = fn(self._upload(arr))
            outs = out if isinstance(out, tuple) else (out,)
            host = tuple(o.cpu().numpy() for o in outs)
            self.bytes_d2h += sum(h.nbytes for h in host)
            return host if isinstance(out, tuple) else host[0]

        return call

    def _fn(self, kind: str, matrix: np.ndarray, *extra):
        key = (kind, matrix.tobytes(), matrix.shape, *extra)
        fn = self._fns.get(key)
        if fn is None:
            if kind == "bytes":
                fn = self._cuda.make_encode_fn(matrix, compute=self.compute)
            elif kind == "fused":
                (length,) = extra
                fn = self._cuda.make_encode_crc_fn(matrix, length,
                                                   self.compute)
            elif kind == "mesh":
                # the fused encode + CRC with the chunk length split over
                # a plane of devices: host batch in, host outputs out
                length, devices, n_dp, n_ls = extra
                fn = self._cuda.make_mesh_encode_crc_fn(
                    matrix, length, devices, n_dp, n_ls, self.compute)
            elif kind == "bits":
                w, packetsize = extra
                fn = self._ek.make_bits_codec_fn(matrix, w, packetsize,
                                                 self.compute)
            else:
                w, packetsize = extra
                fn = self._ek.make_packet_codec_fn(matrix, w, packetsize,
                                                   self.compute)
            if len(self._fns) > 256:
                # readiness is per matrix shape, not per fn: an evicted
                # fn is rebuilt (a host-side table) on its next use
                self._fns.clear()
            self._fns[key] = fn
        return fn

    # -- measured routing --------------------------------------------------

    @staticmethod
    def _bucket(nbytes: int) -> int:
        return max(12, (max(nbytes, 1) - 1).bit_length())

    def use_device(self, nbytes: int) -> bool:
        if self.HOST_CUTOVER_BYTES is not None:
            return nbytes >= self.HOST_CUTOVER_BYTES
        if nbytes < self.MIN_DEVICE_BYTES:
            return False
        self._calls += 1
        b = self._bucket(nbytes)
        host = self._perf.get(("host", b))
        dev = self._perf.get(("dev", b))
        if host is None:
            return False                  # host sample first (cheap)
        if dev is None or dev["n"] < 2:
            return True                   # warm + sample the device path
        if self._calls % self.PROBE_EVERY == 0:
            # re-probe the currently-losing path
            return host["spb"] < dev["spb"]
        return dev["spb"] <= host["spb"]

    def record(self, path: str, nbytes: int, seconds: float,
               depth: int = 1, device=None) -> None:
        """Feed one measured sample into the per-bucket EMA.

        `seconds` is the AMORTIZED cost the caller observed: the
        pipeline reports marginal service time for overlapped device
        dispatches over the coalesced batch's bytes.  `depth`
        (dispatches in flight when the sample landed) is tracked so the
        crossover report can say at what concurrency the device path
        won.  `device` (the pipeline lane index, when known) also feeds
        per-(shape bucket, lane) EMAs."""
        key = (path, self._bucket(nbytes))
        ent = self._perf.setdefault(key, {"spb": None, "n": 0,
                                          "depth": 1.0})
        ent["n"] += 1
        spb = seconds / max(nbytes, 1)
        ent["spb"] = spb if ent["spb"] is None else (
            0.7 * ent["spb"] + 0.3 * spb)
        ent["depth"] = 0.7 * ent.get("depth", 1.0) + 0.3 * float(depth)
        if device is not None and path == "dev":
            dkey = (self._bucket(nbytes), device)
            dent = self._dev_perf.setdefault(dkey, {"spb": None,
                                                    "n": 0})
            dent["n"] += 1
            dent["spb"] = spb if dent["spb"] is None else (
                0.7 * dent["spb"] + 0.3 * spb)

    def crossover_estimate(self) -> int | None:
        """Smallest measured payload bucket where the amortized device
        sec/byte beats the host EMA; None while the host wins every
        bucket both paths have samples for."""
        perf = dict(self._perf)
        for b in sorted({b for (_p, b) in perf}):
            h = perf.get(("host", b))
            d = perf.get(("dev", b))
            if h and d and h["spb"] is not None and \
                    d["spb"] is not None and d["spb"] <= h["spb"]:
                return 1 << b
        return None

    def perf_snapshot(self) -> dict:
        """Measured-routing EMAs keyed 'path:2^bucket', plus the
        per-lane view keyed 'dev@<lane>:2^bucket' (perf dump)."""
        out = {}
        for (path, b), ent in sorted(dict(self._perf).items()):
            spb = ent["spb"]
            if spb is not None:
                out[f"{path}:{1 << b}"] = {
                    "sec_per_byte": spb, "n": ent["n"],
                    "mean_depth": round(ent.get("depth", 1.0), 2)}
        for (b, dev), ent in sorted(dict(self._dev_perf).items()):
            if ent["spb"] is not None:
                out[f"dev@{dev}:{1 << b}"] = {
                    "sec_per_byte": ent["spb"], "n": ent["n"]}
        return out

    def device_fn_if_ready(self, kind: str, matrix: np.ndarray,
                           extra: tuple, shape: tuple, device=None):
        """The tensor-level device fn for (kind, matrix, shape) if it is
        warm on `device` (default: this backend's), else None after
        kicking off a background warm-up.

        Warm means the kernel library is built and one launch at this
        shape on that device succeeded: readiness is per device, since
        the pipeline's lanes may sit on several cards, and per matrix
        SHAPE, not per matrix: the kernels take the coefficients as a
        parameter block, so once one (r, c) matrix launched at a batch
        shape, every other one of those dimensions launches there too
        (a degraded read's decode rows depend on which peers answered
        first; each new set costs a host-side table, never a cold
        shape served from the host).  Building the fn
        ALSO stays off the caller's thread: the first use compiles the
        kernels with nvcc (seconds) and initializes the CUDA context —
        an OSD op must never pay that, so both happen on the warm
        thread and the caller serves from host meanwhile.  If the
        warm-up failed, this raises its error for every later call.
        """
        device = self.device if device is None else torch.device(device)
        rkey = ((kind, matrix.shape, *extra), tuple(shape),
                ec_pipeline.device_warm_key(device))
        if rkey in self._ready:
            return self._fn(kind, matrix, *extra)
        with self._warm_lock:
            err = self._warm_failed.get(rkey)
            if err is not None:
                raise RuntimeError(
                    f"device warm-up of {kind} at {shape} on "
                    f"{device} failed: {type(err).__name__}: "
                    f"{err}") from err
            if rkey in self._warming:
                return None
            self._warming.add(rkey)

        def warm():
            try:
                fn = self._fn(kind, matrix, *extra)
                if kind == "mesh":
                    # a host batch in; the run waits for its members
                    fn(np.zeros(shape, dtype=np.uint8))
                else:
                    fn(torch.zeros(shape, dtype=torch.uint8,
                                   device=device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                self._ready.add(rkey)
            except Exception as e:
                # kept, not retried: the next dispatch of this shape
                # raises it instead of re-running a failing build or
                # device init per EC write (without its traceback, whose
                # frames hold the warm-up batch)
                with self._warm_lock:
                    self._warm_failed[rkey] = e.with_traceback(None)
            finally:
                with self._warm_lock:
                    self._warming.discard(rkey)

        ec_pipeline.start_warm_up(warm)
        return None

    def _timed(self, path: str, nbytes: int, fn) -> np.ndarray:
        import time as _time
        t0 = _time.perf_counter()
        out = fn()
        self.record(path, nbytes, _time.perf_counter() - t0)
        return out

    # -- transforms --------------------------------------------------------

    @staticmethod
    def pad_batch(chunks: np.ndarray) -> np.ndarray:
        """Pad a (S, ...) batch to a power-of-two S so device shapes
        repeat (readiness is per shape; a stable shape set warms once
        per size bucket).  Host paths never pay this — callers pad only
        when dispatching to the device and slice the result."""
        return ec_pipeline.pad_batch(chunks)

    def sync_shapes(self, kind: str, matrix: np.ndarray, extra: tuple,
                    shape: tuple) -> list[DeviceShape]:
        """The device call apply_<kind>(matrix, chunks) makes for chunks
        of `shape`: [] under MIN_DEVICE_BYTES (always the host), else the
        one batch shape it sends (S padded as pad_batch pads it)."""
        if math.prod(shape) < self.MIN_DEVICE_BYTES:
            return []
        if len(shape) == 3:
            shape = (ec_pipeline.next_bucket(shape[0]), *shape[1:])
        return [DeviceShape(self, kind, matrix, tuple(extra), tuple(shape))]

    def apply_bytes(self, matrix: np.ndarray, chunks) -> np.ndarray:
        chunks = np.asarray(chunks, dtype=np.uint8)
        if chunks.nbytes < self.MIN_DEVICE_BYTES:
            # small-op fast path: no routing/timing bookkeeping — the
            # measurement overhead itself would rival the encode
            return self._host.apply_bytes(matrix, chunks)
        if self.use_device(chunks.nbytes):
            dev_in = self.pad_batch(chunks) if chunks.ndim == 3 else chunks
            fn = self.device_fn_if_ready("bytes", matrix, (), dev_in.shape)
            if fn is not None:
                fn = self._on_host(fn)
                return self._timed(
                    "dev", chunks.nbytes,
                    lambda: np.asarray(fn(dev_in))[: chunks.shape[0]]
                    if chunks.ndim == 3 else np.asarray(fn(dev_in)))
        return self._timed(
            "host", chunks.nbytes,
            lambda: self._host.apply_bytes(matrix, chunks))

    def apply_packets(self, matrix: np.ndarray, chunks, w: int,
                      packetsize: int) -> np.ndarray:
        chunks = np.asarray(chunks, dtype=np.uint8)
        if chunks.nbytes < self.MIN_DEVICE_BYTES:
            return self._host.apply_packets(matrix, chunks, w,
                                            packetsize)
        if self.use_device(chunks.nbytes):
            dev_in = self.pad_batch(chunks) if chunks.ndim == 3 else chunks
            fn = self.device_fn_if_ready("packets", matrix, (w, packetsize),
                                         dev_in.shape)
            if fn is not None:
                fn = self._on_host(fn)
                return self._timed(
                    "dev", chunks.nbytes,
                    lambda: np.asarray(fn(dev_in))[: chunks.shape[0]]
                    if chunks.ndim == 3 else np.asarray(fn(dev_in)))
        return self._timed(
            "host", chunks.nbytes,
            lambda: self._host.apply_packets(matrix, chunks, w, packetsize))

    def apply_bits(self, bits: np.ndarray, chunks, w: int,
                   packetsize: int) -> np.ndarray:
        chunks = np.asarray(chunks, dtype=np.uint8)
        if chunks.nbytes < self.MIN_DEVICE_BYTES:
            return self._host.apply_bits(bits, chunks, w, packetsize)
        if self.use_device(chunks.nbytes):
            dev_in = self.pad_batch(chunks) if chunks.ndim == 3 else chunks
            fn = self.device_fn_if_ready("bits", bits, (w, packetsize),
                                         dev_in.shape)
            if fn is not None:
                fn = self._on_host(fn)
                return self._timed(
                    "dev", chunks.nbytes,
                    lambda: np.asarray(fn(dev_in))[: chunks.shape[0]]
                    if chunks.ndim == 3 else np.asarray(fn(dev_in)))
        return self._timed(
            "host", chunks.nbytes,
            lambda: self._host.apply_bits(bits, chunks, w, packetsize))

    def fused_fn_if_ready(self, matrix: np.ndarray, shape: tuple,
                          device=None):
        return self.device_fn_if_ready("fused", matrix, (shape[-1],),
                                       shape, device)

    def mesh_fn_if_ready(self, matrix: np.ndarray, shape: tuple,
                         plane: tuple):
        """The mesh encode + CRC runner (``cuda_ec``'s
        make_mesh_encode_crc_fn) for (matrix, batch shape, plane) if it
        is warm, else None after starting its warm-up — the contract of
        fused_fn_if_ready, with readiness keyed by the plane, `plane`
        being (devices, n_dp, n_ls) from the pipeline's mesh plane.  The
        runner takes a host batch: run(batch, keep_resident=False) ->
        (parity, crcs, resident)."""
        devices, n_dp, n_ls = plane
        return self.device_fn_if_ready(
            "mesh", matrix, (shape[-1], tuple(devices), n_dp, n_ls),
            shape, devices[0])


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


class MatrixErasureCode(ErasureCode):
    """k+m systematic code from a technique's GF(2^8) coding matrix."""

    DEFAULT_K = 2
    DEFAULT_M = 1
    DEFAULT_W = 8
    DEFAULT_PACKETSIZE = 2048
    DEFAULT_TECHNIQUE = "reed_sol_van"

    def __init__(self, backend=None, techniques: Mapping[str, tuple] | None = None):
        self.backend = backend or NumpyBackend()
        self.techniques = dict(techniques or TECHNIQUES)
        self.technique = self.DEFAULT_TECHNIQUE
        self.w = self.DEFAULT_W
        self.packetsize = self.DEFAULT_PACKETSIZE
        self.coding_matrix: np.ndarray | None = None
        self.generator: np.ndarray | None = None
        self._decode_cache: dict[tuple[int, ...], np.ndarray] = {}
        self._fast1 = None

    # -- init -------------------------------------------------------------

    def init(self, profile: Mapping[str, str]) -> None:
        self.k = self.profile_int(profile, "k", self.DEFAULT_K)
        self.m = self.profile_int(profile, "m", self.DEFAULT_M)
        self.technique = profile.get("technique", self.DEFAULT_TECHNIQUE)
        self.w = self.profile_int(
            profile, "w", TECH_DEFAULT_W.get(self.technique,
                                             self.DEFAULT_W))
        self.packetsize = self.profile_int(
            profile, "packetsize", self.DEFAULT_PACKETSIZE)
        if self.k < 1 or self.m < 0:
            raise ErasureCodeError(f"invalid k={self.k} m={self.m}")
        if self.k + self.m > 256:
            raise ErasureCodeError("k+m must be <= 256 for w=8")
        if self.technique not in self.techniques:
            raise ErasureCodeError(
                f"unknown technique {self.technique!r}; "
                f"have {sorted(self.techniques)}")
        builder, self.rep = self.techniques[self.technique]
        if self.rep != REP_BITS and self.w != 8:
            raise ErasureCodeError(
                f"technique {self.technique} supports w=8 only")
        self.coding_matrix = np.asarray(
            builder(self.k, self.m, self.w, self.packetsize), dtype=np.uint8)
        if self.rep == REP_BITS:
            # native GF(2): generator = [identity; coding bits]
            self.generator = None
            self.gen_bits = np.vstack(
                [np.eye(self.k * self.w, dtype=np.uint8),
                 self.coding_matrix])
        else:
            self.generator = gf.systematic_generator(
                self.coding_matrix, self.k)
        self._decode_cache.clear()
        self._fast1 = self._build_fast1()

    def _build_fast1(self):
        """Pre-bound single-stripe encoder for the vstart-default
        small-write path (k=2,m=1 4KiB): one closure frame straight
        into the native extension, no routing/timing bookkeeping —
        the generic path's per-call overhead (~1.7us of asarray/
        branching) rivals the 1.2us the AVX2 kernel needs for the
        whole stripe.  Returns None (fall through to the routed path)
        for batches, big stripes, or non-canonical arrays."""
        if self.rep != REP_BYTES or self.coding_matrix.shape[0] == 0:
            return None
        from .. import native
        ext = native.get_ext()
        if ext is None:
            return None
        mat = np.ascontiguousarray(self.coding_matrix, dtype=np.uint8)
        rows, k = mat.shape
        enc = ext.gf_encode
        empty = np.empty
        u8 = np.dtype(np.uint8)
        size_cap = (TorchBackend.MIN_DEVICE_BYTES
                    if isinstance(self.backend, TorchBackend)
                    else 1 << 62)

        def fast(d: np.ndarray):
            if (d.ndim != 2 or d.dtype is not u8
                    or d.shape[0] != k or d.nbytes >= size_cap
                    or not d.flags.c_contiguous):
                return None
            L = d.shape[1]
            parity = empty((rows, L), u8)
            enc(mat, rows, k, d, parity, L)
            return parity

        return fast

    # -- geometry ---------------------------------------------------------

    def get_alignment(self) -> int:
        if self.rep in (REP_PACKETS, REP_BITS):
            # a chunk must hold whole super-blocks of w packets AND be
            # device-lane aligned; the lcm is the minimal such unit
            return self.k * math.lcm(CHUNK_ALIGN,
                                     self.w * self.packetsize)
        return self.k * CHUNK_ALIGN

    # -- encode -----------------------------------------------------------

    def _apply(self, matrix: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        if matrix.shape[0] == 0:
            return np.zeros((0, chunks.shape[-1]), dtype=np.uint8)
        if self.rep == REP_PACKETS:
            return self.backend.apply_packets(
                matrix, chunks, self.w, self.packetsize)
        if self.rep == REP_BITS:
            return self.backend.apply_bits(
                matrix, chunks, self.w, self.packetsize)
        return self.backend.apply_bytes(matrix, chunks)

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        f = self._fast1
        if f is not None and type(data_chunks) is np.ndarray:
            out = f(data_chunks)
            if out is not None:
                return out
        data_chunks = np.asarray(data_chunks, dtype=np.uint8)
        if data_chunks.shape[-2] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data_chunks.shape[-2]}")
        return self._apply(self.coding_matrix, data_chunks)

    # -- decode -----------------------------------------------------------

    def _decode_rows(self, want: Sequence[int],
                     present: Sequence[int]) -> np.ndarray:
        """(len(want) x len(present)) matrix rebuilding `want` from `present`."""
        key = (tuple(want), tuple(present))
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        if self.rep == REP_BITS:
            out = gf.bitmatrix_decode_rows(
                self.gen_bits, self.k, self.w, list(want), list(present))
            if len(self._decode_cache) > 512:
                self._decode_cache.clear()
            self._decode_cache[key] = out
            return out
        inv = gf.decode_matrix(self.generator, self.k, list(present))
        rows = []
        for c in want:
            if c < self.k:
                rows.append(inv[c])
            else:
                rows.append(gf.gf_matmul(
                    self.coding_matrix[c - self.k][None, :], inv)[0])
        out = np.stack(rows).astype(np.uint8)
        if len(self._decode_cache) > 512:
            self._decode_cache.clear()
        self._decode_cache[key] = out
        return out

    # -- device shapes -----------------------------------------------------

    def device_backend(self):
        be = self.backend
        return be if isinstance(be, TorchBackend) else None

    def _lost_rows(self, r: int) -> np.ndarray:
        """Decode rows of r lost chunks (readiness keys on their shape,
        not their values): chunks 0..r-1 from the first k others."""
        lost = list(range(r))
        return self._decode_rows(
            lost, [i for i in range(self.k + self.m) if i not in lost][:self.k])

    def _sync_shapes(self, matrix: np.ndarray, shape: tuple) -> list:
        be = self.device_backend()
        if be is None or matrix.shape[0] == 0:
            return []
        extra = () if self.rep == REP_BYTES else (self.w, self.packetsize)
        return be.sync_shapes(DEVICE_KIND[self.rep], matrix, extra, shape)

    def stripe_encode_shapes(self, unit: int) -> list:
        return self._sync_shapes(self.coding_matrix, (self.k, unit))

    def decode_shapes(self, unit: int, lost: Iterable[int]) -> list:
        return [s for r in lost
                for s in self._sync_shapes(self._lost_rows(r), (self.k, unit))]

    def device_shapes(self, stripes: Iterable[int], unit: int) -> list:
        # encode_stripes_with_crcs encodes an object in one batch;
        # ecutil.decode_object decodes it stripe by stripe
        return [s for S in stripes
                for s in self._sync_shapes(self.coding_matrix,
                                           (S, self.k, unit))] + \
            self.decode_shapes(unit, range(1, self.m + 1))

    def encode_stripes_with_crcs(self, stripes) -> tuple:
        """Batched stripes: one batched matmul for all S stripes, then
        the k+m scrub CRCs per stripe folded on the host.  The tpu
        plugin overrides this with the fused device pass through the
        dispatch pipeline."""
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        if stripes.ndim != 3 or stripes.shape[1] != self.k:
            raise ErasureCodeError(f"want (S, {self.k}, L), "
                                   f"got {stripes.shape}")
        parity = np.asarray(self._apply(self.coding_matrix, stripes))
        allc = np.concatenate([stripes, parity], axis=1)
        return self._finish_host_stripes(allc)

    def decode_chunks(self, want_to_read, chunks) -> dict[int, np.ndarray]:
        have = {int(i): np.asarray(b, dtype=np.uint8)
                for i, b in chunks.items()}
        want = list(want_to_read)
        out = {i: have[i] for i in want if i in have}
        missing = [i for i in want if i not in have]
        if not missing:
            return out
        present = self.minimum_to_decode(missing, have.keys())
        # already-present wanted chunks came straight from `have`;
        # reconstruct only the missing ones in one matmul
        stack = np.stack([have[i] for i in present])
        rows = self._decode_rows(missing, present)
        rebuilt = self._apply(rows, stack)
        for idx, c in enumerate(missing):
            out[c] = rebuilt[idx]
        return out
