"""Cross-op EC device pipeline: coalesce stripe work, amortize dispatch,
overlap host staging with the card's work, on CUDA streams.

Counterpart of ``ceph_tpu/ops/pipeline.py``.  Every EC write, scrub
batch and rebuild would otherwise pay its own serial pageable
host->device->host round trip for a stripe batch worth a fraction of a
millisecond of kernel time.  A storage daemon has exactly the
concurrency that amortizes that — many in-flight writes, scrub chunks
and recovery rebuilds are embarrassingly parallel stripes — so every
producer feeds this one dispatcher:

  * **channels** — a :class:`PipelineChannel` is one coalescable work
    class (same kernel set): whole-object encodes of one (matrix, L),
    deep-scrub CRC folds of one shard size, rebuild decodes of one
    rows-matrix.  Items on one channel concatenate along the batch axis
    into a mega-batch.
  * **shape buckets** — mega-batches pad to a power-of-two stripe count
    (:func:`pad_batch`), so the kernels see a small repeating shape set
    and readiness (warm-up) is per bucket.
  * **device lanes** — a :class:`DeviceSet` enumerates the visible CUDA
    devices at first use (``osd_ec_device_shards`` caps it); each gets
    a lane with its OWN ``torch.cuda.Stream``, an overlap window of
    ``depth`` in-flight dispatches, a stager thread and a collector
    thread, both running under the lane's device and stream — so every
    kernel a channel's device fn launches goes onto the lane's stream.
    Placement is least-loaded with a round-robin tie-break.  On a CPU
    package device the lanes are ``device_shards`` CPU lanes (default
    :data:`CPU_LANES`) without streams: the tests drive the whole
    machinery there.
  * **mega-batch splitting** — a large coalesced batch splits across
    idle lanes (``split_min`` stripes per part); each part pads to its
    own bucket and the parts re-assemble in submit order.
  * **futures** — :meth:`EcDevicePipeline.submit` returns a
    ``concurrent.futures.Future`` resolving to ``(path, outputs)``.
  * **pinned staging** — each lane's stager copies a part's stripes
    (and the bucket's zero padding) into one of two pinned host buffers
    and uploads it with ``copy_(non_blocking=True)`` on the lane
    stream; a buffer is refilled only after the CUDA event of its last
    upload fired, so the host stages batch N+1 while the card works on
    batch N.  A large encode is staged by its producer into a pinned
    :class:`StagingArena`; a part made of such encodes uploads them
    straight from their arenas.  Readback is parity-only: per encode
    dispatch exactly ``S_pad * k * L`` bytes go up and ``S_pad * (m * L + 4 * (k + m))``
    come down, into fresh pinned tensors (``bytes_h2d`` / ``bytes_d2h``).
  * **HBM stripe cache** — an encode tagged with a
    :class:`~ceph_tpu_torch.ops.hbm_cache.CacheIntent` leaves its
    uploaded data and computed parity on the card (tensor slices, no
    extra transfer), so scrub folds and recovery of that object skip the
    re-upload.  A quarantined lane's entries drop with it.
  * **quarantine + redrain** — a device error on ONE lane (a real
    launch/fetch failure, or an injected ``tpu_error`` targeted at that
    lane index) quarantines that lane: the failed batch and everything
    queued redrains onto the surviving lanes, bit-identically.
  * **scrub QoS and tenants** — deep-scrub CRC channels yield to
    client-write channels under contention (``scrub_weight``), and
    per-pool dmClock tags order tenants (:func:`configure_qos`).
  * **cost-aware placement** — per-lane, per-shape-bucket EMAs of the
    marginal service time override least-loaded when a measured-faster
    lane would win by ``COST_MARGIN``.
  * **mesh dispatch** — ONE coalesced batch whose staged bytes reach
    ``mesh_min_bytes`` (conf ``osd_ec_mesh_min_bytes``) is served by the
    channel's ``mesh_fn`` with its chunk length split across a plane of
    the active lanes' devices (``device_mesh``, conf
    ``osd_ec_device_mesh``: "auto" = every active lane on the
    chunk-length axis, "N" = at most N, "AxB" = dp x ls) instead of
    splitting into independent per-lane row batches.  A plane needs two
    live lanes, so one card never forms one.  A fault of a member rolled
    at placement quarantines that lane and drops the plane; a mesh
    computation that fails drops the plane and requeues the batch
    latched off the mesh: row splits on the surviving lanes serve it
    (``mesh_dispatches`` / ``mesh_degrades``).
  * **pooled staging arenas** — an encode of ``mesh_min_bytes`` and up
    stages into a pinned arena from a free pool of at most
    ``ARENA_POOL_MAX`` (:meth:`EcDevicePipeline.checkout_arena`).  On the
    mesh path with nothing to keep resident, the arena is DONATED: its
    pinned memory uploads straight into the members' slices and the
    device input is released after the kernels, so the staging copy is
    the upload and ``ec.stage`` retires for that write
    (``arena_donations``); any other serve notes ``ec.stage`` at
    resolve.  An arena re-enters the pool only once it was resolved and
    the CUDA event of its last upload fired; one that was never resolved
    is dropped.

Where this differs from the reference: it never hides a failure of the
card behind the host.  A real device error with no lane left, a lane
stall past ``STALL_TIMEOUT`` and a failed warm-up raise to every
affected future (naming the lane and the channel, counted in
:meth:`~EcDevicePipeline.stats`); the codec does not degrade on them.
The host still serves a batch whose kernels are warming up (first use
of a shape), a channel the owner routes to the host, and injected
faults, as in the reference.  A mesh failure degrades to row splits on
the device lanes, never to the host.

Every thread's work and waits are :func:`~ceph_tpu_torch.utils.optracker.span`
spans (``ec.window_full`` and ``ec.pick`` on the dispatcher, ``ec.pin_wait``,
``ec.stage_h2d`` and ``ec.launch`` on a stager, ``ec.event_wait``, ``ec.d2h``,
``ec.cache_stage`` and ``ec.resolve`` on a collector, ``ec.host_encode``
wherever the host serves): :meth:`~EcDevicePipeline.stats` reports each
thread's work, wait and CPU seconds (``threads``) and the spans' totals
(``span_s``), and each item's phase stamps are totalled per channel kind
once the item resolves (``phase_s``; the op thread adds ``ec.tail``
through :meth:`~EcDevicePipeline.note_returned`).

Host batches run inline on the dispatcher thread — single-threaded host
execution is itself the coalescing backpressure.  Timing recorded per
dispatch is the *marginal* service time per lane (now minus the later
of dispatch-issue and that lane's previous fetch-completion).
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import get_device
from ..utils import copyaudit, faults, optracker
from . import hbm_cache

# defaults; daemons override via configure() from their conf
# (osd_ec_pipeline_depth / _coalesce_ms / _max_batch /
#  osd_ec_device_shards / osd_ec_pipeline_scrub_weight /
#  osd_ec_cost_aware_placement / osd_ec_hbm_cache_bytes /
#  osd_ec_mesh_min_bytes / osd_ec_device_mesh /
#  osd_qos_cost_bytes_unit)
DEFAULT_DEPTH = 2
DEFAULT_COALESCE_WAIT = 0.002
DEFAULT_MAX_BATCH = 256
DEFAULT_SPLIT_MIN = 4       # min stripes per per-lane part of a split
DEFAULT_SCRUB_WEIGHT = 0.25
DEFAULT_COST_AWARE = True
# a single lane's staging budget: a coalesced batch of this many bytes
# and up dispatches across the mesh plane when one forms
DEFAULT_MESH_MIN_BYTES = 256 << 20
DEFAULT_DEVICE_MESH = "auto"
# dmClock cost normalization for the dispatch-lane tenant picker
# (mirrors the op queue's osd_qos_cost_bytes_unit; 0 = cost 1/pick)
DEFAULT_QOS_COST_UNIT = 4096
STAGING_BUFFERS = 2         # pinned upload buffers per lane
ARENA_POOL_MAX = 4          # free mesh-sized staging arenas kept for reuse
# staged bytes from which an encode stages into its own pinned arena
# (checkout_arena).  A part whose items all sit in arenas uploads them
# straight from there, one copy each, instead of copying their rows
# into the lane's staging buffer first: the arena trades that host copy
# for one more copy issue per item, which pays at this size and up.
ARENA_MIN_BYTES = 1 << 20
# a measured-cost pick must beat the least-loaded pick by this factor
# to override it (unprobed lanes have no EMA and keep their turn)
COST_MARGIN = 1.25

_UNSET = object()

# liveness bounds: a lane whose collector or stager sits inside one
# fetch/upload longer than STALL_TIMEOUT is skipped by placement; when
# every usable lane's window has been full for STALL_TIMEOUT the
# pipeline latches stalled and device-routed batches fail with
# TimeoutError; a producer blocked RESULT_TIMEOUT in result() gets a
# TimeoutError (plugin_tpu).  Nothing is served from the host instead.
STALL_TIMEOUT = 60.0
# CPU lanes when device_shards is unset ("all") on a CPU package device:
# the port's counterpart of the virtual CPU device count XLA is given
CPU_LANES = 1
RESULT_TIMEOUT = 120.0


def next_bucket(n: int) -> int:
    """Power-of-two shape bucket for a batch of n stripes."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def pad_batch(batch: np.ndarray) -> np.ndarray:
    """Zero-pad axis 0 to the next power of two so device shapes
    repeat.  Callers slice the result back to the true count; host
    paths never pay the padding."""
    S = batch.shape[0]
    S_pad = next_bucket(S)
    if S_pad == S:
        return batch
    return np.concatenate(
        [batch, np.zeros((S_pad - S,) + batch.shape[1:], dtype=np.uint8)])


def device_warm_key(device) -> tuple | None:
    """Readiness key of a device: a warm shape on one card says nothing
    about another.  ``cuda`` without an index is the current card."""
    if device is None:
        return None
    device = torch.device(device)
    index = device.index
    if device.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return (device.type, index)


def _no_record(path, nbytes, secs, depth=1, device=None) -> None:
    return None


def _wrap_device_fn(device_fn):
    """Accept both fn(padded) and fn(padded, device), as the reference
    does; wrapping once at construction keeps the dispatch path free of
    per-call signature probing."""
    if device_fn is None:
        return None
    try:
        params = list(inspect.signature(device_fn).parameters.values())
    except (TypeError, ValueError):
        return device_fn
    if len(params) >= 2 or any(
            p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params):
        return device_fn

    def wrapped(padded, device=None, _fn=device_fn):
        return _fn(padded)

    return wrapped


class PipelineChannel:
    """One coalescable work class.

    host_fn(batch) -> tuple of np arrays, each with leading dim ==
    batch.shape[0].  device_fn(padded, device) (or device_fn(padded))
    takes the padded batch as
    a uint8 tensor on the lane's device and returns the same tuple as
    tensors on that device (launched on the current stream, which the
    pipeline sets to the lane's), or None when its kernels are not warm
    yet on that device (the batch then runs on host while a background
    warm-up proceeds).  An exception from device_fn is a device error on
    that lane.  route(nbytes) -> True to try the device for a coalesced
    batch of that size.  on_error(exc) fires when injected faults have
    quarantined every lane (the tpu plugin degrades there).
    record(path, nbytes, secs, depth, device) feeds the owner's
    measured-routing EMA.  qos_class "scrub" marks channels that yield
    to "write" channels under contention.

    mesh_fn(batch, plane, donate=False, keep_resident=False) is the
    optional mesh entry: serve one whole host batch with its chunk
    length split across `plane`'s devices, returning (outputs, resident)
    — outputs equal to host_fn(batch), resident the members' tensors for
    the HBM cache or None — or None while it warms up (the batch then
    row-splits on the lanes)."""

    __slots__ = ("key", "host_fn", "device_fn", "route", "on_error",
                 "record", "max_coalesce", "qos_class", "mesh_fn")

    def __init__(self, key, host_fn, device_fn=None, route=None,
                 on_error=None, record=None, max_coalesce=None,
                 qos_class="write", mesh_fn=None):
        self.key = key
        self.host_fn = host_fn
        self.device_fn = _wrap_device_fn(device_fn)
        self.route = route if route is not None else \
            (lambda nbytes: device_fn is not None)
        self.on_error = on_error or (lambda e: None)
        self.record = record or _no_record
        self.max_coalesce = max_coalesce
        self.qos_class = qos_class
        self.mesh_fn = mesh_fn


class StagingArena:
    """The staging buffer of one large encode
    (:meth:`EcDevicePipeline.checkout_arena`): `tensor` is pinned host
    memory on a CUDA package device, and `buf` its numpy view, which the
    producer stages its stripes into.  A lane's stager uploads the
    stripes straight from `tensor` instead of copying them into the
    lane's own pinned buffer first, and a mesh dispatch uploads each
    member's slice straight from it.

    An arena of ``mesh_min_bytes`` and up comes from the pipeline's free
    pool and goes back there on :meth:`release`, which the last reader
    (the shard fan-out) calls — but only once the pipeline resolved its
    item (``consumed``: a donated mesh upload was the staging copy;
    ``noted``: ``ec.stage`` was noted) and the CUDA event of its last
    upload fired.  An arena that was never resolved (its producer timed
    out, and the queued item still views `buf`) or whose upload is still
    pending is dropped instead: its memory goes back to the allocator
    with its last view.  A smaller arena is fresh from the allocator and
    never pooled."""

    __slots__ = ("tensor", "buf", "payload_bytes", "consumed", "noted",
                 "upload_event", "_pool")

    def __init__(self, tensor: torch.Tensor, payload_bytes: int,
                 pool=None):
        self.tensor = tensor
        self.buf = tensor.numpy()
        self.payload_bytes = int(payload_bytes)
        self.consumed = False
        self.noted = False
        self.upload_event = None     # CUDA event of the last upload
        self._pool = pool

    @property
    def pooled(self) -> bool:
        return self._pool is not None

    def release(self) -> None:
        pool, self._pool = self._pool, None
        if pool is None:
            return
        ev = self.upload_event
        if (self.consumed or self.noted) and (ev is None or ev.query()):
            pool._return_arena(self)
        else:
            self.tensor = self.buf = None


class _MeshPlane:
    """The dp x ls plane a mesh dispatch splits a batch across: a
    snapshot of active lanes.  Dropped when any member lane quarantines
    or the lanes are rebuilt."""

    __slots__ = ("lanes", "lane_indices", "devices", "n_dp", "n_ls")

    def __init__(self, lanes: list, n_dp: int, n_ls: int):
        self.lanes = lanes
        self.lane_indices = tuple(l.index for l in lanes)
        self.devices = tuple(l.device for l in lanes)
        self.n_dp = n_dp
        self.n_ls = n_ls

    def key(self) -> tuple:
        return (self.devices, self.n_dp, self.n_ls)


class _Item:
    __slots__ = ("arr", "n", "fut", "t", "cache", "tag", "arena",
                 "no_mesh", "ph", "kind")

    def __init__(self, arr: np.ndarray, cache=None, tag=None,
                 arena=None, kind=None):
        self.arr = arr
        self.n = arr.shape[0]
        self.fut: Future = Future()
        self.t = time.monotonic()
        self.cache = cache          # hbm_cache.CacheIntent | None
        self.tag = tag              # QoS service class (pool name)
        self.arena = arena          # StagingArena | None
        self.no_mesh = False        # fell off the mesh: row splits only
        self.kind = kind            # channel kind: the key's first field
        # op-tracing phase stamps (time.monotonic — the span timebase):
        # submit -> picked (coalesce wait) -> queued (handed to a lane's
        # staging queue) -> stage0/1 (pinned staging and upload issue)
        # -> issue -> collect0 (the lane's stream reached the end of the
        # compute: upload + kernels) -> done (D2H), or host0/host1 for
        # the host drain; requeues counts redrains.  Attached to the
        # future as `trace_phases` at resolve; the op thread adds
        # `returned` (optracker.phase_spans reads them).
        self.ph: dict = {"submit": self.t}


class _Lane:
    """One device's dispatch lane: its stream, its overlap window (a
    deque of in-flight dispatches bounded by the pipeline depth), a
    stager thread + staging queue with the lane's double-buffered pinned
    upload buffers, its own collector thread, transfer accounting, and
    per-shape-bucket marginal service-time EMAs for cost-aware
    placement."""

    __slots__ = ("device", "index", "stream", "inflight", "stage_q",
                 "staging", "pinned", "pin_events", "pin_next", "zeros",
                 "quarantined", "quarantine_reason", "injected", "alive",
                 "collect_started", "stage_started", "last_fetch_done",
                 "dispatches", "stripes", "nbytes", "errors",
                 "bytes_h2d", "bytes_d2h", "spb")

    def __init__(self, device: torch.device, index: int):
        self.device = device
        self.index = index
        self.stream = torch.cuda.Stream(device=device) \
            if device.type == "cuda" else None
        self.inflight: deque = deque()
        self.stage_q: deque = deque()
        self.staging = 0             # parts popped, not yet in flight
        # stager-thread-only state: pinned upload buffers and the event
        # of each one's last upload; pinned zeros for arena parts' padding
        self.pinned: list = [None] * STAGING_BUFFERS
        self.pin_events: list = [None] * STAGING_BUFFERS
        self.pin_next = 0
        self.zeros: torch.Tensor | None = None
        self.quarantined = False
        self.quarantine_reason = ""
        self.injected = False        # quarantined by an injected fault
        self.alive = True            # False once the devset is rebuilt
        self.collect_started: float | None = None
        self.stage_started: float | None = None
        self.last_fetch_done = 0.0
        self.dispatches = 0
        self.stripes = 0
        self.nbytes = 0
        self.errors = 0
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.spb: dict[int, dict] = {}

    def name(self) -> str:
        return f"lane {self.index} ({self.device})"

    def context(self):
        """The lane's device and stream as the calling thread's current
        ones (a no-op for a CPU lane)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def load(self) -> int:
        """Occupancy the overlap window bounds: dispatched + staged +
        mid-staging parts (a part being uploaded is claimed work)."""
        return len(self.inflight) + len(self.stage_q) + self.staging

    def note_service(self, nbytes: int, secs: float) -> None:
        b = (max(nbytes, 1) - 1).bit_length()
        ent = self.spb.setdefault(b, {"spb": None, "n": 0})
        ent["n"] += 1
        spb = secs / max(nbytes, 1)
        ent["spb"] = spb if ent["spb"] is None else (
            0.7 * ent["spb"] + 0.3 * spb)

    def predict(self, nbytes: int) -> float | None:
        """Predicted marginal seconds to serve nbytes more on this
        lane (None until the shape bucket has enough samples)."""
        ent = self.spb.get((max(nbytes, 1) - 1).bit_length())
        if ent is None or ent["n"] < 3 or ent["spb"] is None:
            return None
        return ent["spb"] * nbytes * (self.load() + 1)

    def stuck(self, now: float) -> bool:
        for started in (self.collect_started, self.stage_started):
            if started is not None and now - started > STALL_TIMEOUT:
                return True
        return False

    def dump(self) -> dict:
        return {"device": str(self.device),
                "dispatches": self.dispatches, "stripes": self.stripes,
                "bytes": self.nbytes, "errors": self.errors,
                "inflight": len(self.inflight),
                "staged": len(self.stage_q) + self.staging,
                "bytes_h2d": self.bytes_h2d,
                "bytes_d2h": self.bytes_d2h,
                "quarantined": self.quarantined,
                "quarantine_reason": self.quarantine_reason}


class DeviceSet:
    """The lanes, built at first device dispatch from the package
    device: every visible CUDA device for ``cuda`` (``shards`` caps the
    count), or ``shards`` CPU lanes (default :data:`CPU_LANES`) for
    ``cpu``.  A ``cuda``
    package device with no card raises: there is no pseudo-lane."""

    def __init__(self, shards: int | None = None):
        dev = get_device()
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError(
                    "EC pipeline: the package device is cuda but no CUDA "
                    "device is visible (set_device('cpu') for the plain "
                    "PyTorch path)")
            devices = [torch.device("cuda", i) for i in range(count)]
            if shards is not None:
                devices = devices[: max(1, int(shards))]
        elif dev.type == "cpu":
            devices = [torch.device("cpu")] * max(
                1, int(shards or CPU_LANES))
        else:
            raise ValueError(f"EC pipeline: unsupported device {dev}")
        self.lanes = [_Lane(d, i) for i, d in enumerate(devices)]

    def active(self) -> list:
        return [l for l in self.lanes if not l.quarantined]


class _Group:
    """One mega-batch split across lanes: parts collect independently
    and the futures resolve once every part landed, in original row
    order.  A failed part marks the whole group failed; its items
    requeue exactly once and surviving parts' outputs are discarded."""

    __slots__ = ("chan", "items", "nparts", "pending", "outs",
                 "failed", "nbytes", "t0")

    def __init__(self, chan, items, nparts, nbytes, t0):
        self.chan = chan
        self.items = items
        self.nparts = nparts
        self.pending = nparts
        self.outs: dict[int, tuple] = {}
        self.failed = False
        self.nbytes = nbytes
        self.t0 = t0


class _Staged:
    """One planned part waiting on (or inside) its lane's stager.
    `pieces` are host arrays whose row concatenation is the part (the
    items' own arrays for a whole batch: the stager writes them straight
    into the pinned buffer, with no host concatenation first)."""

    __slots__ = ("chan", "items", "pieces", "S", "group", "gidx")

    def __init__(self, chan, items, pieces, S, group=None, gidx=0):
        self.chan = chan
        self.items = items          # [] for split-group parts
        self.pieces = pieces
        self.S = S
        self.group = group
        self.gidx = gidx

    def all_items(self) -> list:
        return self.items if self.group is None else self.group.items


class _Dispatch:
    __slots__ = ("chan", "items", "S", "out", "t0", "nbytes", "lane",
                 "group", "gidx", "dev_in", "event")

    def __init__(self, chan, items, S, out, t0, nbytes, lane,
                 group=None, gidx=0, dev_in=None, event=None):
        self.chan = chan
        self.items = items
        self.S = S
        self.out = out
        self.t0 = t0
        self.nbytes = nbytes
        self.lane = lane
        self.group = group
        self.gidx = gidx
        self.dev_in = dev_in        # device-resident input (HBM cache)
        self.event = event          # end of the compute on the stream

    def all_items(self) -> list:
        return self.items if self.group is None else self.group.items


def _cat(pieces: list) -> np.ndarray:
    """Reassemble one contiguous batch from row pieces."""
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)


def _cat_items(items: list) -> np.ndarray:
    return _cat([it.arr for it in items])


def _owned(t: torch.Tensor) -> torch.Tensor:
    """`t` if it spans its whole storage, else a compact copy of it (on
    the current stream), so that holding it holds only its own bytes."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _fill(dst: np.ndarray, pieces: list) -> None:
    """Write the pieces' rows into dst and zero the bucket's padding."""
    off = 0
    for p in pieces:
        dst[off: off + p.shape[0]] = p
        off += p.shape[0]
    dst[off:] = 0


class EcDevicePipeline:
    def __init__(self, depth: int = DEFAULT_DEPTH,
                 coalesce_wait: float = DEFAULT_COALESCE_WAIT,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 device_shards: int | None = None,
                 split_min: int = DEFAULT_SPLIT_MIN,
                 scrub_weight: float = DEFAULT_SCRUB_WEIGHT,
                 cost_aware: bool = DEFAULT_COST_AWARE,
                 mesh_min_bytes: int = DEFAULT_MESH_MIN_BYTES,
                 device_mesh: str = DEFAULT_DEVICE_MESH,
                 qos_cost_unit: int = DEFAULT_QOS_COST_UNIT):
        self.depth = max(1, int(depth))
        self.coalesce_wait = float(coalesce_wait)
        self.max_batch = max(1, int(max_batch))
        self.device_shards = device_shards
        self.split_min = max(1, int(split_min))
        self.scrub_weight = float(scrub_weight)
        self.cost_aware = bool(cost_aware)
        self.mesh_min_bytes = int(mesh_min_bytes)
        self.device_mesh = str(device_mesh)
        self.qos_cost_unit = max(0, int(qos_cost_unit))
        self._mesh: _MeshPlane | None = None
        self._arena_lock = threading.Lock()
        self._arena_free: list[torch.Tensor] = []
        self._lock = threading.Lock()
        # three predicates, one lock: queued work (dispatcher waits),
        # in-flight dispatches (lane stagers/collectors wait), freed
        # overlap slots (dispatcher waits)
        self._work_cv = threading.Condition(self._lock)
        self._inflight_cv = threading.Condition(self._lock)
        self._fetch_cv = threading.Condition(self._lock)
        # queues are keyed (chan.key, qos_tag): one coalescing stream
        # per (work class, tenant) — a mega-batch never mixes tenants
        self._queues: dict = {}            # (chan.key, tag) -> deque
        self._chans: dict = {}             # chan.key -> PipelineChannel
        from ..utils.dmclock import DmClockState
        self._qos = DmClockState()
        self._qos_enabled = False
        self._qos_wake = 0.0
        self._devset: DeviceSet | None = None
        self._rr = 0                       # placement tie-break rotor
        self._qos_contended = 0            # contended-pick counters
        self._qos_scrub = 0
        self._busy = 0                     # dispatches being processed
        self._stalled = False              # lanes wedged: device batches fail
        self._running = False
        self._threads: list = []
        self._holders = 0                  # daemons holding the lanes
        # tracing totals, behind their own lock: each pipeline thread's
        # work / wait / CPU seconds by thread name, and the items' phase
        # seconds by channel kind, folded in batches from the phase
        # stamps of resolved items and returned tails (appended without
        # a lock, as optracker's span totals are)
        self._tlock = threading.Lock()
        # name -> [(thread or None, its counter)]: None holds the sums of
        # the name's threads that have ended
        self._thread_totals: dict[str, list] = {}
        self._phase_s: dict[str, dict] = {}
        self._phases_closed: deque = deque()   # (kind, ph, tail only)
        self._c = {
            "dispatches": 0, "dev_dispatches": 0, "host_dispatches": 0,
            # device dispatches per channel kind (its key's first
            # field): each launches that kind's kernels exactly once
            "dev_dispatches_enc": 0, "dev_dispatches_dec": 0,
            "dev_dispatches_crc": 0,
            "ops": 0, "stripes": 0, "coalesce_waits": 0,
            "device_errors": 0, "drained_to_host": 0,
            "max_queue_depth": 0, "quarantines": 0,
            "split_dispatches": 0, "redrained": 0,
            "qos_scrub_yields": 0, "qos_cost_picks": 0,
            "bytes_h2d": 0, "bytes_d2h": 0,
            "cost_placements": 0, "cost_diverged": 0,
            # the port's raise-not-host-serve rules, in items failed
            "exhausted_errors": 0, "stall_errors": 0,
            "result_timeouts": 0,
            # batches placed again because no lane could take them
            # (the reference served those from the host)
            "replans": 0,
            # parts uploaded straight from their pinned arena
            "arena_uploads": 0,
            # mesh dispatches (counted in dev_dispatches, not in the
            # per-kind counts: a mesh launches its kind's kernels once
            # per member), planes dropped by a member fault or a failed
            # mesh computation, and donated arena uploads
            "mesh_dispatches": 0, "mesh_degrades": 0,
            "arena_donations": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def _ensure_threads(self) -> None:
        if self._running:
            return
        self._running = True
        t = threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="ec-pipeline-dispatch")
        t.start()
        self._threads.append(t)

    def _ensure_devset(self) -> DeviceSet:
        """Build the device set lazily (at the first dispatch, or at
        an OSD's boot through start_lanes; raises when the package
        device has no card)."""
        ds = self._devset
        if ds is not None:
            return ds
        ds = DeviceSet(self.device_shards)
        with self._lock:
            if self._devset is None:
                self._devset = ds
                # collectors/stagers of retired device sets have exited
                self._threads = [t for t in self._threads
                                 if t.is_alive()]
                for lane in ds.lanes:
                    for target, tag in ((self._collect_loop, "collect"),
                                        (self._stage_loop, "stage")):
                        t = threading.Thread(
                            target=target, args=(lane,), daemon=True,
                            name=f"ec-pipeline-{tag}-{lane.index}")
                        t.start()
                        self._threads.append(t)
            return self._devset

    def start_lanes(self) -> int:
        """Start the dispatcher and build the lanes now rather than at
        the first submit (an OSD at boot); returns the lane count.
        Raises when the package device is cuda and no card is
        visible.  The caller holds the lanes until release_lanes()."""
        with self._lock:
            self._ensure_threads()
        n = len(self._ensure_devset().lanes)
        with self._lock:
            self._holders += 1
        return n

    def lane_devices(self) -> list:
        """The devices of the live lanes, each once; builds the lanes
        if none are up yet."""
        devices: list = []
        for lane in self._ensure_devset().active():
            if lane.device not in devices:
                devices.append(lane.device)
        return devices

    def release_lanes(self, timeout: float = 30.0) -> None:
        """A daemon that held the lanes shuts down.  The last holder in
        the process drains the queued and in-flight work, joins the
        kernel warm-ups and stops the pipeline: an OSD process must not
        reach interpreter exit with a thread inside torch (the C++
        runtime then aborts it, SIGABRT instead of exit 0)."""
        with self._lock:
            self._holders = max(0, self._holders - 1)
            if self._holders:
                return
        end = time.monotonic() + timeout
        self.flush(timeout)
        join_warm_ups(max(0.0, end - time.monotonic()))
        self.stop()

    def reset_devices(self, device_shards=_UNSET) -> None:
        """Rebuild the device set on next dispatch: clears quarantine
        and stall latches and (optionally) re-caps the lane count."""
        self.flush(timeout=10.0)
        with self._lock:
            if device_shards is not _UNSET:
                self.device_shards = device_shards
            ds, self._devset = self._devset, None
            if ds is not None:
                for lane in ds.lanes:
                    lane.alive = False
            self._mesh = None
            self._stalled = False
            self._inflight_cv.notify_all()
        # lane indices renumber with the topology: entries pinned to
        # the old lanes are no longer attributable
        hbm_cache.get().clear()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop and join every pipeline thread; the next submit starts
        afresh (new lanes, latches cleared)."""
        with self._lock:
            self._running = False
            ds, self._devset = self._devset, None
            if ds is not None:
                for lane in ds.lanes:
                    lane.alive = False
            self._mesh = None
            self._stalled = False
            self._work_cv.notify_all()
            self._inflight_cv.notify_all()
            self._fetch_cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        hbm_cache.get().clear()

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until every queued + staged + in-flight item resolved."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                ds = self._devset
                inflight = sum(l.load() for l in ds.lanes) \
                    if ds else 0
                if not inflight and not self._busy and \
                        not any(self._queues.values()):
                    return True
            time.sleep(0.005)
        return False

    # -- tracing totals ----------------------------------------------------

    def _bind_thread(self) -> optracker.ThreadTotals:
        """Count the calling pipeline thread's spans in a counter of its
        own, reported under its name: a rebuilt lane's threads take the
        names of the retired lane's, which may still be draining.  The
        counters of the name's ended threads fold into one."""
        me = threading.current_thread()
        tt = optracker.ThreadTotals()
        with self._tlock:
            ents = self._thread_totals.get(me.name, [])
            live = [(t, c) for t, c in ents
                    if t is not None and t.is_alive()]
            ended = [c for t, c in ents if t is None or not t.is_alive()]
            if ended:
                live.insert(0, (None, optracker.ThreadTotals.sum(ended)))
            live.append((me, tt))
            self._thread_totals[me.name] = live
        optracker.bind_thread_totals(tt)
        return tt

    def _close_phases(self, kind, ph: dict, tail: bool) -> None:
        """Total an item's phases once (`tail` False, at resolve: every
        phase but the tail) or its tail (`tail` True)."""
        self._phases_closed.append((kind, ph, tail))
        if len(self._phases_closed) > optracker.FOLD_AT:
            self._fold_phases()

    def _fold_phases(self) -> None:
        with self._tlock:
            while self._phases_closed:
                kind, ph, tail = self._phases_closed.popleft()
                ent = self._phase_s.setdefault(kind, {"items": 0})
                if not tail:
                    ent["items"] += 1
                for name, t0, t1 in optracker.phase_spans(ph):
                    if (name == "ec.tail") != tail:
                        continue
                    tot = ent.get(name)
                    if tot is None:
                        ent[name] = {"avgcount": 1, "sum": t1 - t0}
                    else:
                        tot["avgcount"] += 1
                        tot["sum"] += t1 - t0

    def note_returned(self, kind: str, ph: dict | None) -> None:
        """The op thread has its answer: stamp `returned` into the
        item's phases (the future's ``trace_phases``) and total its
        ``ec.tail`` under channel kind `kind`."""
        if not ph:
            return
        ph["returned"] = time.monotonic()
        self._close_phases(kind, ph, True)

    # -- producer side -----------------------------------------------------

    def checkout_arena(self, nbytes: int,
                       payload_bytes: int | None = None
                       ) -> StagingArena | None:
        """A staging arena of `nbytes` for an encode, or None under
        ARENA_MIN_BYTES (the caller then stages into a plain buffer).
        Pinned host memory on a CUDA package device, exclusively the
        caller's until release().  From `mesh_min_bytes` up it comes
        from the free pool (see :class:`StagingArena`).  The stripe tail
        past `payload_bytes` comes back zeroed; the first `payload_bytes`
        are the caller's to overwrite entirely, so a pooled reuse zeroes
        only the tail."""
        zero_from = 0 if payload_bytes is None \
            else min(int(payload_bytes), nbytes)
        pooled = 0 < self.mesh_min_bytes <= nbytes
        if not pooled and nbytes < ARENA_MIN_BYTES:
            return None
        tensor = None
        if pooled:
            with self._arena_lock:
                for i, t in enumerate(self._arena_free):
                    if t.numel() == nbytes:
                        tensor = self._arena_free.pop(i)
                        break
        if tensor is None:
            tensor = torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=get_device().type == "cuda")
        tensor[zero_from:].zero_()
        return StagingArena(tensor, nbytes if payload_bytes is None
                            else payload_bytes, self if pooled else None)

    def _return_arena(self, arena: StagingArena) -> None:
        tensor, arena.tensor, arena.buf = arena.tensor, None, None
        if tensor is None:
            return
        with self._arena_lock:
            if len(self._arena_free) < ARENA_POOL_MAX:
                self._arena_free.append(tensor)

    def submit(self, chan: PipelineChannel, arr: np.ndarray,
               cache=None, qos: str | None = None,
               arena=None) -> Future:
        """Queue a (B, ...) uint8 batch on `chan`.  The future resolves
        to (path, outputs) with path in {"dev", "host"} and outputs the
        channel fn's tuple as numpy arrays, sliced to this submission's
        B rows.

        `cache` (an hbm_cache.CacheIntent) asks the plane to keep this
        submission's device-resident inputs/outputs in the HBM stripe
        cache when the dispatch runs on a device (encode channels
        only — the fn's outputs must be (parity, crcs)).  `qos` names
        the submission's service class (configure_qos).  `arena` is the
        StagingArena the stripes were staged into."""
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        if arr.ndim < 1 or arr.shape[0] == 0:
            raise ValueError(f"empty pipeline submission {arr.shape}")
        item = _Item(arr, cache=cache, tag=qos, arena=arena,
                     kind=chan.key[0])
        with self._lock:
            self._ensure_threads()
            self._chans[chan.key] = chan
            self._queues.setdefault((chan.key, qos),
                                    deque()).append(item)
            self._c["ops"] += 1
            self._c["stripes"] += item.n
            qd = sum(len(q) for q in self._queues.values())
            if qd > self._c["max_queue_depth"]:
                self._c["max_queue_depth"] = qd
            self._work_cv.notify()
        return item.fut

    def note_result_timeout(self) -> None:
        """A producer gave up waiting on a future (plugin_tpu)."""
        with self._lock:
            self._c["result_timeouts"] += 1

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["queue_depth"] = sum(len(q) for q in
                                     self._queues.values())
            ds = self._devset
            out["inflight"] = sum(len(l.inflight) for l in ds.lanes) \
                if ds else 0
            out["staged"] = sum(len(l.stage_q) + l.staging
                                for l in ds.lanes) if ds else 0
            out["stalled"] = self._stalled
            out["devices"] = {str(l.index): l.dump()
                              for l in ds.lanes} if ds else {}
            out["active_devices"] = len(ds.active()) if ds else 0
            mp = self._mesh
            # which lanes the mesh plane spans and how dp x ls map
            # onto them
            out["mesh"] = ({"dp": mp.n_dp, "ls": mp.n_ls,
                            "lanes": list(mp.lane_indices),
                            "devices": [str(d) for d in mp.devices]}
                           if mp is not None else None)
        self._fold_phases()
        with self._tlock:
            out["threads"] = {
                name: optracker.ThreadTotals.sum(c for _t, c in ents).dump()
                for name, ents in self._thread_totals.items()}
            out["phase_s"] = {kind: {k: dict(v) if isinstance(v, dict)
                                     else v for k, v in ent.items()}
                              for kind, ent in self._phase_s.items()}
        out["span_s"] = optracker.span_totals()
        out["depth"] = self.depth
        out["device_shards"] = self.device_shards or "all"
        out["scrub_weight"] = self.scrub_weight
        out["cost_aware"] = self.cost_aware
        out["mesh_min_bytes"] = self.mesh_min_bytes
        out["device_mesh"] = self.device_mesh
        out["qos_cost_unit"] = self.qos_cost_unit
        d = out["dispatches"]
        out["mean_batch_size"] = (out["stripes"] / d) if d else 0.0
        # HBM stripe cache counters ride the same perf-dump section
        for k, v in hbm_cache.stats().items():
            out[f"cache_{k}"] = v
        return out

    # -- dispatcher --------------------------------------------------------

    def _pick_key(self):
        """The (channel, tenant) queue to dispatch next.  CLASS
        arbitration: the oldest queued item per class wins FIFO, except
        scrub yields to client-write work under contention (scrub_weight
        bounds its share of contended picks).  TENANT arbitration: among
        the write-class queue heads, a dmClock pick over the tenants'
        tags (configure_qos); exact FIFO when no class is configured."""
        best_w = best_s = None
        t_w = t_s = None
        write_heads: dict = {}
        for key, q in self._queues.items():
            if not q:
                continue
            chan = self._chans.get(key[0])
            if chan is not None and chan.qos_class == "scrub":
                if t_s is None or q[0].t < t_s:
                    best_s, t_s = key, q[0].t
            else:
                write_heads[key] = q[0].t
                if t_w is None or q[0].t < t_w:
                    best_w, t_w = key, q[0].t
        want = None
        if best_s is None:
            want = "write"
        elif best_w is None:
            return best_s
        else:
            w = self.scrub_weight
            if w >= 1.0:
                want = "scrub" if t_s < t_w else "write"
            else:
                # ratio-faithful: scrub's served fraction of contended
                # picks tracks the configured weight exactly
                self._qos_contended += 1
                if self._qos_scrub + 1 <= w * self._qos_contended:
                    self._qos_scrub += 1
                    want = "scrub"
                else:
                    if t_s < t_w:
                        self._c["qos_scrub_yields"] += 1
                    want = "write"
        if want == "scrub":
            return best_s
        if best_w is None:
            return None
        if not self._qos_enabled:
            return best_w
        return self._qos_pick_write(write_heads, best_s)

    def _qos_pick_write(self, write_heads: dict, best_s):
        """dmClock tenant pick among the write-class heads, charged
        1 + head_batch_bytes/qos_cost_unit per pick; falls back to
        scrub when every tenant is limit-throttled."""
        cands: dict = {}
        by_tag: dict = {}
        for key, t in write_heads.items():
            tag = key[1] if key[1] is not None else "_system"
            if t < cands.get(tag, float("inf")):
                cands[tag] = t
            by_tag.setdefault(tag, []).append((t, key))
        costs = None
        if self.qos_cost_unit > 0:
            costs = {}
            for tag, lst in by_tag.items():
                _t, hkey = min(lst, key=lambda e: e[0])
                head = self._queues[hkey][0]
                costs[tag] = 1.0 + head.arr.nbytes / self.qos_cost_unit
        client, _phase, wake = self._qos.pick(cands, costs=costs)
        if client is None:
            # every queued tenant over its limit: scrub may run; else
            # the dispatch loop sleeps until the earliest tag
            self._qos.note_stall()
            self._qos_wake = wake
            if best_s is not None and self.scrub_weight < 1.0:
                self._qos_scrub += 1
            return best_s
        if costs is not None:
            self._c["qos_cost_picks"] += 1
        return min(by_tag[client], key=lambda e: e[0])[1]

    def _window_full_locked(self, now: float) -> bool:
        """True while every usable lane's overlap window is full — the
        dispatcher holds off so arrivals coalesce into the next
        mega-batch.  Quarantined and stuck lanes don't count."""
        ds = self._devset
        if ds is None:
            return False
        lanes = [l for l in ds.lanes
                 if not l.quarantined and not l.stuck(now)]
        if not lanes:
            return False
        return all(l.load() >= self.depth for l in lanes)

    def _dispatch_loop(self) -> None:
        tt = self._bind_thread()
        while True:
            tt.sample()
            with self._lock:
                while self._running and \
                        not any(self._queues.values()):
                    self._work_cv.wait()
                if not self._running:
                    return
                # one ec.window_full span a hold, as coalesce_waits counts
                hold = None
                while self._running and not self._stalled and \
                        self._window_full_locked(time.monotonic()):
                    now = time.monotonic()
                    if hold is None:
                        hold = optracker.span("ec.window_full")
                        hold.__enter__()
                    elif now - hold.t0 > STALL_TIMEOUT:
                        self._latch_stall_locked(
                            "every usable lane's window stayed full")
                        break
                    self._fetch_cv.wait(self.coalesce_wait or 0.01)
                if hold is not None:
                    hold.__exit__(None, None, None)
                    self._c["coalesce_waits"] += 1
                if not self._running:
                    return
                pick = optracker.span("ec.pick")
                pick.__enter__()
                key = self._pick_key()
                if key is None:
                    pick.__exit__(None, None, None)
                    if any(self._queues.values()):
                        # every tenant limit-throttled: sleep until the
                        # earliest tag comes due
                        self._work_cv.wait(max(
                            0.001,
                            min(self._qos_wake - time.monotonic(),
                                0.1)))
                    continue
                chan = self._chans[key[0]]
                q = self._queues[key]
                cap = chan.max_coalesce or self.max_batch
                items, n = [], 0
                pick_t = time.monotonic()
                while q and (not items or n + q[0].n <= cap):
                    it = q.popleft()
                    it.ph["picked"] = pick_t    # coalesce wait ends
                    items.append(it)
                    n += it.n
                if not q:
                    # self-cleaning registry: a drained key drops its
                    # queue, and the channel once no queue needs it
                    del self._queues[key]
                    if not any(k[0] == key[0] for k in self._queues):
                        self._chans.pop(key[0], None)
                self._busy += 1
            try:
                self._dispatch(chan, items)
            except Exception as e:      # never kill the loop
                self._fail(items, e)
            finally:
                pick.__exit__(None, None, None)
                with self._lock:
                    self._busy -= 1

    # -- failures the port raises instead of serving from the host ---------

    @staticmethod
    def _fail(items: list, exc: BaseException) -> None:
        for it in items:
            if not it.fut.done():
                it.fut.set_exception(exc)

    def _latch_stall_locked(self, why: str) -> None:
        if self._stalled:
            return
        self._stalled = True
        from ..utils.dout import DoutLogger
        DoutLogger("ops", "ec-pipeline").warn(
            "EC device lanes stalled > %.0fs (%s): device-routed "
            "batches now fail until reset_devices", STALL_TIMEOUT, why)

    def _fail_stalled(self, chan: PipelineChannel, items: list) -> None:
        ds = self._devset
        now = time.monotonic()
        stuck = [l.name() for l in (ds.lanes if ds else [])
                 if not l.quarantined and l.stuck(now)] or \
            [l.name() for l in (ds.active() if ds else [])]
        with self._lock:
            self._c["stall_errors"] += len(items)
        self._fail(items, TimeoutError(
            f"EC pipeline stalled: {', '.join(stuck) or 'no lane'} made "
            f"no progress for {STALL_TIMEOUT:.0f}s; channel {chan.key!r} "
            "not served"))

    def _fail_exhausted(self, chan: PipelineChannel, items: list,
                        cause: BaseException | None = None) -> None:
        """Every lane quarantined by a real device error: the affected
        futures raise, naming the lanes and the channel."""
        ds = self._devset
        lanes = "; ".join(f"{l.name()}: {l.quarantine_reason}"
                          for l in (ds.lanes if ds else []))
        with self._lock:
            self._c["exhausted_errors"] += len(items)
        err = RuntimeError(f"EC device lanes all quarantined ({lanes}); "
                           f"channel {chan.key!r} not served")
        err.__cause__ = cause
        self._fail(items, err)

    def _exhausted_by_injection(self) -> bool:
        ds = self._devset
        return ds is not None and all(l.injected for l in ds.lanes)

    # -- placement ---------------------------------------------------------

    def _quarantine_locked(self, lane: _Lane, reason: str,
                           injected: bool = False) -> None:
        if lane.quarantined:
            return
        lane.quarantined = True
        lane.quarantine_reason = reason
        lane.injected = injected
        self._c["quarantines"] += 1
        # a mesh plane spanning this lane is gone with it: later
        # mega-batches rebuild one from the survivors
        if self._mesh is not None and \
                lane.index in self._mesh.lane_indices:
            self._mesh = None
        # the card is in an unknown state: its cache entries must never
        # serve again (redrain re-uploads from host)
        hbm_cache.get().drop_lane(lane.index)

    def _log_quarantine(self, lane: _Lane, active_left: int) -> None:
        from ..utils.dout import DoutLogger
        DoutLogger("ops", "ec-pipeline").warn(
            "EC device %s quarantined (%s): redraining its work onto %d "
            "surviving lane(s)%s", lane.name(), lane.quarantine_reason,
            active_left, "" if active_left else " — none left")

    def _plan_locked(self, ds: DeviceSet, S: int, nbytes: int = 0,
                     bounds: list | None = None) -> tuple[list, bool]:
        """Place a coalesced S-stripe batch on `ds`: (plan, exhausted).

        plan is [(lane, row_start, row_count), ...] — one entry for a
        whole-batch dispatch, several when the batch splits across
        idle lanes; empty when no lane can take it right now.
        exhausted=True means every lane is quarantined.  Injected
        per-lane faults (``tpu_error <prob> <lane>``) are rolled here,
        at placement.  `bounds` (interior item-boundary row offsets)
        marks a CACHE-TAGGED batch: splits cut only at item boundaries
        so every tagged item's rows land whole on one lane and can stay
        in its cache.  Whole-batch picks are cost-aware.  A `ds` that
        reset_devices retired meanwhile still plans: :meth:`_issue`
        finds its lanes dead and requeues the batch for the new set."""
        now = time.monotonic()
        fs = faults.get()
        for lane in ds.lanes:
            if lane.quarantined or lane.stuck(now):
                continue
            if fs.tpu_error(device=lane.index):
                self._quarantine_locked(lane, "injected device error",
                                        injected=True)
                self._c["device_errors"] += 1
                lane.errors += 1
        active = ds.active()
        if not active:
            return [], True
        cands = [lane for lane in active
                 if not lane.stuck(now) and lane.load() < self.depth]
        if not cands:
            if all(lane.stuck(now) for lane in active):
                self._latch_stall_locked(
                    f"all {len(active)} active lanes stuck")
            return [], False
        n = len(cands)
        rot = self._rr
        self._rr += 1
        cands.sort(key=lambda l: (l.load(), (l.index - rot) % n))
        idle = [l for l in cands if not l.load()]
        nparts = min(len(idle), S // self.split_min)
        if nparts >= 2:
            if bounds is not None:
                cuts = self._aligned_cuts(bounds, S, nparts)
                if cuts:
                    edges = [0] + cuts + [S]
                    return [(idle[i], edges[i], edges[i + 1] - edges[i])
                            for i in range(len(edges) - 1)], False
                # single tagged item: fall through to whole-batch
            else:
                base, rem = divmod(S, nparts)
                plan, r0 = [], 0
                for i in range(nparts):
                    rn = base + (1 if i < rem else 0)
                    plan.append((idle[i], r0, rn))
                    r0 += rn
                return plan, False
        pick = cands[0]
        if self.cost_aware and nbytes and len(cands) > 1:
            p_least = pick.predict(nbytes)
            if p_least is not None:
                self._c["cost_placements"] += 1
                best, p_best = pick, p_least
                for lane in cands[1:]:
                    p = lane.predict(nbytes)
                    if p is not None and p < p_best:
                        best, p_best = lane, p
                if best is not pick and p_best * COST_MARGIN < p_least:
                    pick = best
                    self._c["cost_diverged"] += 1
        return [(pick, 0, S)], False

    @staticmethod
    def _aligned_cuts(bounds: list, S: int, nparts: int) -> list:
        """Up to nparts-1 strictly-increasing cut points drawn from the
        item boundaries, each nearest the even-split ideal."""
        cuts: list = []
        last = 0
        remaining = nparts
        avail = [b for b in bounds if 0 < b < S]
        while remaining > 1 and avail:
            want = last + max(1, round((S - last) / remaining))
            best = min(avail, key=lambda b: abs(b - want))
            cuts.append(best)
            last = best
            avail = [b for b in avail if b > best]
            remaining -= 1
        return cuts

    def _requeue_locked(self, chan: PipelineChannel, items: list,
                        redrain: bool = True) -> None:
        """Push redrained items back to the FRONT of their channel
        queue (they were submitted first; FIFO fairness holds)."""
        self._chans[chan.key] = chan
        tag = items[0].tag if items else None
        q = self._queues.setdefault((chan.key, tag), deque())
        if redrain:
            for it in items:
                it.ph["requeues"] = it.ph.get("requeues", 0) + 1
            self._c["redrained"] += len(items)
        q.extendleft(reversed(items))
        self._work_cv.notify()

    def _requeue_staged_locked(self, staged) -> None:
        """Requeue a part's items once (a split group's first failing
        part requeues the whole group; later parts discard)."""
        already = staged.group is not None and staged.group.failed
        if staged.group is not None:
            staged.group.failed = True
        if not already:
            self._requeue_locked(staged.chan, staged.all_items())

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, chan: PipelineChannel, items: list) -> None:
        S = sum(it.n for it in items)
        nbytes = sum(it.arr.nbytes for it in items)
        # a route that raises fails the batch (the dispatch loop hands
        # the error to the futures)
        if chan.device_fn is not None and chan.route(nbytes):
            ds = self._ensure_devset()
            if self._stalled:
                self._fail_stalled(chan, items)
                return
            if self._mesh_eligible(chan, items, nbytes) and \
                    self._dispatch_mesh(chan, items):
                return
            bounds = None
            if hbm_cache.get().capacity > 0 and \
                    any(it.cache is not None for it in items):
                bounds, r = [], 0
                for it in items[:-1]:
                    r += it.n
                    bounds.append(r)
            with self._lock:
                plan, exhausted = self._plan_locked(ds, S, nbytes, bounds)
            if exhausted:
                if not self._exhausted_by_injection():
                    self._fail_exhausted(chan, items)
                    return
                # injected faults took every lane: the channel owner
                # degrades (tpu plugin -> host matrix codec), as in the
                # reference, and this batch drains to the host fn
                with self._lock:
                    self._c["drained_to_host"] += len(items)
                chan.on_error(RuntimeError(
                    "all EC device lanes quarantined by injected faults"))
            elif plan:
                parts_items = None
                if len(plan) > 1 and bounds is not None:
                    # item-aligned split: each part is an independent
                    # dispatch carrying its own items
                    parts_items, it_iter = [], iter(items)
                    for _lane, _r0, rn in plan:
                        sub, acc = [], 0
                        while acc < rn:
                            nxt = next(it_iter)
                            sub.append(nxt)
                            acc += nxt.n
                        parts_items.append(sub)
                self._issue(chan, items, plan, parts_items)
                return
            elif self._stalled:
                self._fail_stalled(chan, items)
                return
            else:
                # no lane free right now (one went stuck or full since
                # the window check): back to the queue front; the
                # dispatcher waits for a slot, or latches the stall
                with self._lock:
                    self._c["replans"] += 1
                    self._requeue_locked(chan, items, redrain=False)
                return
        self._run_host(chan, items, _cat_items(items))

    def _issue(self, chan: PipelineChannel, items: list, plan: list,
               parts_items: list | None = None) -> None:
        """Hand the placed (possibly split) batch to its lanes' stagers.
        The dispatcher never touches the device: staging, uploads and
        kernel launches run on the per-lane stager threads."""
        group = None
        batch = None
        if len(plan) > 1:
            if parts_items is None:
                batch = _cat_items(items)
                group = _Group(chan, items, len(plan), batch.nbytes,
                               time.perf_counter())
            with self._lock:
                self._c["split_dispatches"] += 1
        for gidx, (lane, r0, rn) in enumerate(plan):
            if parts_items is not None:
                p_items = parts_items[gidx]
                pieces = [it.arr for it in p_items]
            elif group is not None:
                p_items, pieces = [], [batch[r0: r0 + rn]]
            else:
                p_items, pieces = items, [it.arr for it in items]
            staged = _Staged(chan, p_items, pieces, rn, group, gidx)
            with self._lock:
                if not lane.alive or lane.quarantined:
                    # placement raced a devset rebuild or quarantine:
                    # requeue for a healthy lane.  Item-aligned parts
                    # already staged are independent dispatches; only
                    # the rest requeue.
                    if parts_items is not None:
                        self._requeue_locked(
                            chan, [it for sub in parts_items[gidx:]
                                   for it in sub])
                    else:
                        self._requeue_staged_locked(
                            _Staged(chan, items, [], 0, group))
                    return
                t_q = time.monotonic()
                for it in staged.all_items():
                    it.ph["queued"] = t_q
                lane.stage_q.append(staged)
                self._inflight_cv.notify_all()

    # -- mesh dispatch (one batch across the plane's devices) --------------

    def _mesh_eligible(self, chan: PipelineChannel, items: list,
                       nbytes: int) -> bool:
        """Mesh mode is chosen when the channel has a mesh entry, the
        coalesced batch reaches a single lane's budget, and no item fell
        off the mesh before (such a batch finishes on row splits)."""
        return (chan.mesh_fn is not None and self.mesh_min_bytes > 0
                and nbytes >= self.mesh_min_bytes
                and not any(it.no_mesh for it in items))

    @staticmethod
    def _parse_mesh_spec(spec: str, avail: int) -> tuple | None:
        """osd_ec_device_mesh -> (n_dp, n_ls): "auto" spans every active
        lane on the chunk-length axis, an integer caps the member count,
        "AxB" lays out dp x ls (None when `avail` lanes cannot)."""
        s = str(spec or "auto").strip().lower()
        if "x" in s:
            try:
                a, b = s.split("x", 1)
                n_dp, n_ls = max(1, int(a)), max(1, int(b))
            except ValueError:
                return None
            if n_dp * n_ls > avail:
                return None
            return n_dp, n_ls
        if s.isdigit():
            n = min(int(s), avail)
            return (1, n) if n >= 2 else None
        return 1, avail

    def _mesh_plane(self) -> _MeshPlane | None:
        """The current mesh plane, built from the active lanes when it
        is first needed (at least two live lanes).  Injected per-lane
        faults are rolled on every member here, at placement: a hit
        quarantines that lane and drops the plane, and the dispatch
        falls through to row splits on the survivors."""
        now = time.monotonic()
        fs = faults.get()
        with self._lock:
            plane = self._mesh
            if plane is None:
                ds = self._devset
                if ds is None:
                    return None
                lanes = [l for l in ds.lanes
                         if not l.quarantined and not l.stuck(now)]
                if len(lanes) < 2:
                    return None
                parsed = self._parse_mesh_spec(self.device_mesh,
                                               len(lanes))
                if parsed is None or parsed[0] * parsed[1] < 2:
                    return None
                n_dp, n_ls = parsed
                plane = _MeshPlane(lanes[: n_dp * n_ls], n_dp, n_ls)
                self._mesh = plane
            for lane in plane.lanes:
                if lane.quarantined or fs.tpu_error(device=lane.index):
                    if not lane.quarantined:
                        self._quarantine_locked(
                            lane, "injected device error", injected=True)
                        self._c["device_errors"] += 1
                        lane.errors += 1
                    self._c["mesh_degrades"] += 1
                    self._mesh = None
                    return None
        return plane

    def _dispatch_mesh(self, chan: PipelineChannel, items: list) -> bool:
        """Serve one coalesced batch across the mesh plane.  True when
        it was handled (served, or requeued off the mesh by a failure);
        False to fall through to row-split placement (no plane, the
        mesh runner still warming up, or a member fault at placement).
        Runs inline on the dispatcher thread: the dispatch IS the
        backpressure that coalesces the queue behind it."""
        plane = self._mesh_plane()
        if plane is None:
            return False
        batch = _cat_items(items)
        arena = items[0].arena if len(items) == 1 else None
        donate = arena is not None and arena.pooled and \
            items[0].cache is None
        keep = hbm_cache.get().capacity > 0 and \
            any(it.cache is not None for it in items)
        t0 = time.perf_counter()
        t_m0 = time.monotonic()
        try:
            res = chan.mesh_fn(batch, plane, donate=donate,
                               keep_resident=keep)
        except Exception as e:
            self._mesh_failed(chan, items, e)
            return True
        if res is None:
            return False
        outs, resident = res
        secs = max(time.perf_counter() - t0, 1e-9)
        t_m1 = time.monotonic()
        name = f"mesh {plane.n_dp}x{plane.n_ls} lanes " \
               f"{list(plane.lane_indices)}"
        for it in items:
            # upload, kernels and readback run inline: one window
            it.ph["issue"] = t_m0
            it.ph["collect0"] = t_m1
            it.ph["done"] = t_m1
            it.fut.ec_lane = name
        outs = tuple(np.asarray(o) for o in outs)
        with self._lock:
            self._c["dispatches"] += 1
            self._c["dev_dispatches"] += 1
            self._c["mesh_dispatches"] += 1
            self._c["bytes_h2d"] += batch.nbytes
            self._c["bytes_d2h"] += sum(int(o.nbytes) for o in outs)
            if arena is not None and arena.pooled:
                # the upload from the arena WAS the staging copy
                # (donated, or kept resident for the cache): ec.stage
                # retires for this write
                arena.consumed = True
                if donate:
                    self._c["arena_donations"] += 1
        try:
            chan.record("dev", batch.nbytes, secs, len(plane.lanes))
        except Exception:
            pass
        if resident is not None:
            self._stage_mesh_cache(items, plane, outs, resident)
        self._resolve(items, "dev", outs)
        return True

    def _mesh_failed(self, chan: PipelineChannel, items: list,
                     e: Exception) -> None:
        """A mesh computation failed.  The error is not pinned on one
        lane, so none quarantines here: the plane drops and the batch
        requeues latched off the mesh, so row splits on the device
        lanes serve it (a lane that is really bad then fails its part
        and quarantines through the single-lane ladder)."""
        with self._lock:
            self._c["device_errors"] += 1
            self._c["mesh_degrades"] += 1
            self._mesh = None
            for it in items:
                it.no_mesh = True
            self._requeue_locked(chan, items)
        from ..utils.dout import DoutLogger
        DoutLogger("ops", "ec-pipeline").warn(
            "EC mesh dispatch failed (%s: %s): degrading the batch to "
            "row splits on the lanes", type(e).__name__, e)

    @staticmethod
    def _stage_mesh_cache(items: list, plane: _MeshPlane, outs: tuple,
                          resident: tuple) -> None:
        """Mesh-resident cache entries: each tagged item's rows of the
        members' inputs and parity, pinned to every member lane (a
        quarantine of any one drops the entry) with the chunk pad."""
        dev_data, dev_parity, pad = resident
        off = 0
        for it in items:
            if it.cache is not None:
                hbm_cache.get().stage(
                    it.cache, plane.lane_indices,
                    dev_data.rows(off, off + it.n),
                    dev_parity.rows(off, off + it.n),
                    outs[1][off: off + it.n].copy(), pad=pad)
            off += it.n

    # -- stagers (one thread per lane: the H2D half of the plane) ----------

    def _stage_loop(self, lane: _Lane) -> None:
        tt = self._bind_thread()
        with lane.context():
            while True:
                tt.sample()
                with self._lock:
                    while self._running and lane.alive and \
                            not lane.stage_q:
                        self._inflight_cv.wait()
                    if not self._running or not lane.alive:
                        # a retired lane must not strand queued parts:
                        # requeue them for the fresh device set
                        while lane.stage_q:
                            self._requeue_staged_locked(
                                lane.stage_q.popleft())
                        return
                    staged = lane.stage_q.popleft()
                    if lane.quarantined:
                        # quarantined after staging: redrain
                        self._requeue_staged_locked(staged)
                        continue
                    lane.staging += 1
                    lane.stage_started = time.monotonic()
                    self._busy += 1
                try:
                    self._stage_one(staged, lane)
                except Exception as e:
                    self._fail(staged.all_items(), e)
                finally:
                    with self._lock:
                        lane.staging -= 1
                        lane.stage_started = None
                        self._busy -= 1
                        self._fetch_cv.notify_all()

    @staticmethod
    def _arena_pieces(staged: _Staged) -> list | None:
        """The arena tensors of a part's items, in row order, when every
        item of the part was staged into a :class:`StagingArena` (None
        otherwise: the rows then go through the lane's buffer)."""
        if staged.group is not None or not staged.items:
            return None
        out = []
        for it in staged.items:
            ar = it.arena
            if ar is None or ar.tensor.numel() != it.arr.nbytes or \
                    ar.tensor.data_ptr() != it.arr.ctypes.data:
                return None
            out.append(ar.tensor.view(it.arr.shape))
        return out

    def _to_device(self, staged: _Staged, S_pad: int,
                   lane: _Lane) -> torch.Tensor:
        """Stage one part onto `lane`'s device, padded to S_pad rows
        (runs on the lane's stager thread, under its stream).  On a
        card: a part whose items all sit in pinned arenas uploads each
        item straight from its arena and the padding rows from the
        lane's pinned zero buffer; any other part's rows and padding are
        written into one of the lane's two pinned buffers — the one
        whose previous upload has completed — and uploaded from there.
        All are non-blocking copies on the lane stream.  Every byte that
        crosses is accounted."""
        pieces = staged.pieces
        shape = (S_pad,) + pieces[0].shape[1:]
        nbytes = int(np.prod(shape))
        if lane.stream is None:
            dev = torch.empty(shape, dtype=torch.uint8)
            _fill(dev.numpy(), pieces)
        else:
            dev = torch.empty(shape, dtype=torch.uint8, device=lane.device)
            srcs = self._arena_pieces(staged)
            if srcs is not None:
                off = 0
                for src in srcs:
                    dev[off: off + src.shape[0]].copy_(src,
                                                       non_blocking=True)
                    off += src.shape[0]
                pad = (S_pad - off) * (nbytes // S_pad)
                if pad:
                    if lane.zeros is None or lane.zeros.numel() < pad:
                        # never written again, so uploads need no event
                        lane.zeros = torch.zeros(pad, dtype=torch.uint8,
                                                 pin_memory=True)
                    dev[off:].copy_(lane.zeros[:pad].view(dev[off:].shape),
                                    non_blocking=True)
                # a pooled arena may be handed out again only after this
                ev = torch.cuda.Event()
                ev.record(lane.stream)
                for it in staged.items:
                    it.arena.upload_event = ev
                with self._lock:
                    self._c["arena_uploads"] += 1
            else:
                slot = lane.pin_next
                lane.pin_next = (slot + 1) % STAGING_BUFFERS
                done = lane.pin_events[slot]
                if done is not None:
                    with optracker.span("ec.pin_wait"):
                        done.synchronize()
                buf = lane.pinned[slot]
                if buf is None or buf.numel() < nbytes:
                    buf = lane.pinned[slot] = torch.empty(
                        nbytes, dtype=torch.uint8, pin_memory=True)
                host = buf[:nbytes].view(shape)
                _fill(host.numpy(), pieces)
                dev.copy_(host, non_blocking=True)
                ev = lane.pin_events[slot] = torch.cuda.Event()
                ev.record(lane.stream)
        with self._lock:
            lane.bytes_h2d += nbytes
            self._c["bytes_h2d"] += nbytes
        return dev

    def _stage_one(self, staged: _Staged, lane: _Lane) -> None:
        """Stage one part and launch its device fn on the lane stream."""
        chan = staged.chan
        its = staged.all_items()
        with optracker.span("ec.stage_h2d") as sp:
            dev_arr = self._to_device(staged, next_bucket(staged.S), lane)
        t_s0, t_s1 = sp.t0, sp.t1
        for it in its:
            # split-group parts stage concurrently; the per-item
            # stamps keep the widest window (min start, max end)
            it.ph["stage0"] = min(it.ph.get("stage0", t_s0), t_s0)
            it.ph["stage1"] = max(it.ph.get("stage1", t_s1), t_s1)
            it.ph["issue"] = it.ph["stage1"]
            it.fut.ec_lane = lane.name()
        t0 = time.perf_counter()
        try:
            with optracker.span("ec.launch"):
                out = chan.device_fn(dev_arr, lane.device)
                event = None
                if out is not None and lane.stream is not None:
                    event = torch.cuda.Event()
                    event.record(lane.stream)
        except Exception as e:
            self._device_failed(chan, lane, staged, e)
            return
        if out is None:
            # not warm on this device yet (background warm-up kicked
            # off): host serves the whole batch.  For a split group only
            # the FIRST cold part host-serves.
            if staged.group is not None:
                with self._lock:
                    serve = not staged.group.failed
                    staged.group.failed = True
                if serve:
                    items = staged.group.items
                    self._run_host(chan, items, _cat_items(items))
            else:
                self._run_host(chan, staged.items, _cat(staged.pieces))
            return
        nbytes = sum(p.nbytes for p in staged.pieces)
        disp = _Dispatch(chan, staged.items, staged.S, out, t0, nbytes,
                         lane, staged.group, staged.gidx, dev_in=dev_arr,
                         event=event)
        with self._lock:
            if not lane.alive:
                # reset_devices retired this lane mid-upload: its
                # collector may be gone — requeue instead
                self._requeue_staged_locked(staged)
                return
            lane.inflight.append(disp)
            self._inflight_cv.notify_all()

    def _device_failed(self, chan, lane, part, e: Exception) -> None:
        """A launch (stager) or fetch (collector) failed on `lane`:
        quarantine it and redrain the part's items onto survivors.  A
        split group's failed latch requeues its items exactly once.
        With no lane left the items' futures raise."""
        with self._lock:
            self._c["device_errors"] += 1
            lane.errors += 1
            self._quarantine_locked(lane, f"{type(e).__name__}: {e}")
            already = part.group is not None and part.group.failed
            if part.group is not None:
                part.group.failed = True
            ds = self._devset
            # devset mid-rebuild counts as having survivors
            active_left = len(ds.active()) if ds is not None else 1
        self._log_quarantine(lane, active_left)
        if already:
            return
        if active_left:
            with self._lock:
                self._requeue_locked(chan, part.all_items())
            return
        self._fail_exhausted(chan, part.all_items(), cause=e)

    # -- collectors (one thread per lane) ----------------------------------

    def _collect_loop(self, lane: _Lane) -> None:
        tt = self._bind_thread()
        with lane.context():
            while True:
                tt.sample()
                with self._lock:
                    while self._running and lane.alive and \
                            not lane.inflight:
                        self._inflight_cv.wait()
                    if not self._running or not lane.inflight:
                        return          # stopped, or retired + drained
                    disp = lane.inflight.popleft()
                    lane.collect_started = time.monotonic()
                    self._busy += 1
                try:
                    self._collect_one(disp)
                except Exception as e:
                    # never kill the loop: a dead collector would leak
                    # _busy and wedge every producer blocked in result()
                    self._fail(disp.all_items(), e)
                finally:
                    with self._lock:
                        lane.collect_started = None
                        self._busy -= 1
                        self._fetch_cv.notify_all()

    def _collect_one(self, disp: _Dispatch) -> None:
        lane = disp.lane
        try:
            if disp.event is not None:
                with optracker.span("ec.event_wait"):
                    disp.event.synchronize()
            # parity-only readback: exactly the channel fn's outputs
            # cross D2H, into fresh pinned tensors on the lane stream
            with optracker.span("ec.d2h") as sp:
                outs = hbm_cache.to_host(disp.out)
            t_c0, t_c1 = sp.t0, sp.t1
        except Exception as e:
            self._device_failed(disp.chan, lane, disp, e)
            return
        for it in disp.all_items():
            it.ph["collect0"] = min(it.ph.get("collect0", t_c0), t_c0)
            it.ph["done"] = max(it.ph.get("done", t_c1), t_c1)
        d2h = sum(int(o.nbytes) for o in outs)
        now = time.perf_counter()
        # marginal service time PER LANE: overlap with this lane's
        # previous fetch does not double-bill
        start = max(disp.t0, lane.last_fetch_done)
        lane.last_fetch_done = now
        secs = max(now - start, 1e-9)
        with self._lock:
            depth = len(lane.inflight) + 1
            self._c["dispatches"] += 1
            self._c["dev_dispatches"] += 1
            kind = f"dev_dispatches_{disp.chan.key[0]}"
            if kind in self._c:
                self._c[kind] += 1
            self._c["bytes_d2h"] += d2h
            lane.dispatches += 1
            lane.stripes += disp.S
            lane.nbytes += disp.nbytes
            lane.bytes_d2h += d2h
            lane.note_service(disp.nbytes, secs)
        try:
            disp.chan.record("dev", disp.nbytes, secs, depth,
                             device=lane.index)
        except Exception:
            pass
        if disp.group is None:
            self._stage_cache(disp, outs)
        outs = tuple(o[: disp.S] for o in outs)
        if disp.group is None:
            self._resolve(disp.items, "dev", outs)
        else:
            self._group_part_done(disp, outs)

    def _stage_cache(self, disp: _Dispatch, outs: tuple) -> None:
        """Keep cache-tagged items' stripes on the card: the item's rows
        of the already-uploaded input and the already-computed parity —
        zero extra host transfer.  A slice that is not its whole tensor
        is copied on the card (on the lane stream): a view would keep
        the whole padded batch resident while the cache counts only the
        item's rows against its budget.  Row-split group parts skip (an
        item's rows straddle parts there)."""
        if disp.dev_in is None or len(disp.out) < 2 or \
                not any(it.cache is not None for it in disp.items):
            return
        off = 0
        with optracker.span("ec.cache_stage"):
            for it in disp.items:
                if it.cache is not None:
                    rows = slice(off, off + it.n)
                    hbm_cache.get().stage(
                        it.cache, disp.lane.index,
                        _owned(disp.dev_in[rows]),
                        _owned(disp.out[0][rows]),
                        outs[1][rows].copy(), stream=disp.lane.stream)
                off += it.n

    def _group_part_done(self, disp: _Dispatch, outs: tuple) -> None:
        g = disp.group
        with self._lock:
            if g.failed:
                return                 # another part failed; the items
            g.outs[disp.gidx] = outs   # were already requeued
            g.pending -= 1
            done = g.pending == 0
        if done:
            try:
                g.chan.record(
                    "dev", g.nbytes,
                    max(time.perf_counter() - g.t0, 1e-9), g.nparts)
            except Exception:
                pass
            width = len(g.outs[0])
            cat = tuple(
                np.concatenate([g.outs[i][j] for i in range(g.nparts)])
                for j in range(width))
            self._resolve(g.items, "dev", cat)

    # -- shared ------------------------------------------------------------

    def _run_host(self, chan: PipelineChannel, items: list,
                  batch: np.ndarray) -> None:
        t0 = time.perf_counter()
        try:
            with optracker.span("ec.host_encode") as sp:
                outs = tuple(np.asarray(o) for o in chan.host_fn(batch))
        except Exception as e:
            self._fail(items, e)
            return
        t_h0, t_h1 = sp.t0, sp.t1
        for it in items:
            it.ph["host0"] = t_h0
            it.ph["host1"] = t_h1
        with self._lock:
            self._c["dispatches"] += 1
            self._c["host_dispatches"] += 1
        try:
            chan.record("host", batch.nbytes,
                        max(time.perf_counter() - t0, 1e-9), 1)
        except Exception:
            pass
        self._resolve(items, "host", outs)

    def _resolve(self, items: list, path: str, outs: tuple) -> None:
        with optracker.span("ec.resolve"):
            off = 0
            for it in items:
                ar = it.arena
                if ar is not None and not ar.consumed and not ar.noted:
                    # a pooled arena that no donated mesh upload subsumed
                    # (host, lane or row-split serve): its staging copy
                    # is a host copy after all, noted where a plain
                    # buffer's is
                    ar.noted = True
                    copyaudit.note("ec.stage", ar.payload_bytes)
                sl = tuple(o[off: off + it.n] for o in outs)
                off += it.n
                if not it.fut.done():
                    # phase stamps ride the future itself: the
                    # producer's op thread turns them into TrackedOp
                    # spans; their totals count here, once an item
                    # (it.ph is final: the future gets a copy)
                    self._close_phases(it.kind, it.ph, False)
                    it.fut.trace_phases = dict(it.ph)
                    it.fut.set_result((path, sl))


# ---------------------------------------------------------------------------
# Process-wide singleton (all producers in a process share one queue —
# that IS the cross-op coalescing) + plugin-agnostic channels.
# ---------------------------------------------------------------------------

_global: EcDevicePipeline | None = None
_glock = threading.Lock()


_warm_threads: list[threading.Thread] = []


def start_warm_up(target, args: tuple = (), name: str = "ec-kernel-warm"
                  ) -> None:
    """Run a kernel warm-up (a first launch at a new shape) on a daemon
    thread that release_lanes() joins."""
    t = threading.Thread(target=target, args=args, daemon=True, name=name)
    with _glock:
        _warm_threads[:] = [w for w in _warm_threads if w.is_alive()]
        _warm_threads.append(t)
    t.start()


def join_warm_ups(timeout: float) -> None:
    """Wait up to `timeout` seconds for the running warm-ups."""
    end = time.monotonic() + timeout
    with _glock:
        threads = list(_warm_threads)
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))


def get() -> EcDevicePipeline:
    global _global
    if _global is None:
        with _glock:
            if _global is None:
                _global = EcDevicePipeline()
    return _global


def configure(depth: int | None = None,
              coalesce_wait: float | None = None,
              max_batch: int | None = None,
              device_shards=_UNSET,
              scrub_weight: float | None = None,
              split_min: int | None = None,
              cost_aware: bool | None = None,
              hbm_cache_bytes: int | None = None,
              mesh_min_bytes: int | None = None,
              device_mesh: str | None = None,
              qos_cost_unit: int | None = None) -> EcDevicePipeline:
    """Tune the shared pipeline (daemon startup applies its conf)."""
    p = get()
    if depth is not None:
        p.depth = max(1, int(depth))
    if coalesce_wait is not None:
        p.coalesce_wait = max(0.0, float(coalesce_wait))
    if max_batch is not None:
        p.max_batch = max(1, int(max_batch))
    if scrub_weight is not None:
        p.scrub_weight = max(0.01, float(scrub_weight))
    if split_min is not None:
        p.split_min = max(1, int(split_min))
    if cost_aware is not None:
        p.cost_aware = bool(cost_aware)
    if hbm_cache_bytes is not None:
        hbm_cache.configure(hbm_cache_bytes)
    if mesh_min_bytes is not None:
        p.mesh_min_bytes = int(mesh_min_bytes)
    if device_mesh is not None and device_mesh != p.device_mesh:
        p.device_mesh = str(device_mesh)
        with p._lock:
            p._mesh = None      # a layout change rebuilds the plane
    if qos_cost_unit is not None:
        p.qos_cost_unit = max(0, int(qos_cost_unit))
    if device_shards is not _UNSET and \
            device_shards != p.device_shards:
        # a lane-count change rebuilds the device set (and clears any
        # quarantine latches with it)
        if p._devset is not None:
            p.reset_devices(device_shards)
        else:
            p.device_shards = device_shards
    return p


def stats() -> dict:
    return get().stats()


def configure_qos(specs: dict, cost_unit: int | None = None) -> None:
    """Install per-pool dmClock service classes ({pool: QosSpec}) on
    the dispatch-lane picker.  Rates apply at DISPATCH-pick
    granularity, bytes-weighted: each pick is charged
    1 + head_batch_bytes/cost_unit."""
    p = get()
    if cost_unit is not None:
        p.qos_cost_unit = max(0, int(cost_unit))
    with p._lock:
        p._qos.configure(dict(specs))
        p._qos_enabled = bool(specs)


def qos_stats() -> dict:
    """The dispatch-lane half of the perf-dump `qos` block."""
    return get()._qos.stats()


# -- deep-scrub CRC channels -------------------------------------------------
#
# Keyed per row size; the device fn is cuda_ec.make_crc_fn (crc32c.cu's
# segment pass + chain pass on a card, the plain version on a CPU lane),
# warmed on a background thread per (size, padded shape, lane device)
# like TorchBackend's codec fns, so the dispatcher never blocks on a
# first-use kernel build.  A failed warm-up is kept and raised by every
# later dispatch of that key (the reference served those from the host
# and latched the channel to the host on a device failure).

_crc_channels: dict[int, PipelineChannel] = {}
_crc_fns: dict = {}
_crc_warming: set = set()
_crc_warm_failed: dict = {}
_crc_lock = threading.Lock()


def crc_fn_if_ready(size: int, shape: tuple, device):
    """The scrub CRC fn for rows of `size` bytes at the padded `shape`
    if it is warm on `device`, else None after starting its warm-up.
    Raises the error of a failed warm-up."""
    key = (size, tuple(shape), device_warm_key(device))
    with _crc_lock:
        fn = _crc_fns.get(key)
        if fn is not None:
            return fn
        err = _crc_warm_failed.get(key)
        if err is not None:
            raise RuntimeError(
                f"scrub CRC warm-up at {tuple(shape)} on {device} failed: "
                f"{type(err).__name__}: {err}") from err
        if key not in _crc_warming:
            _crc_warming.add(key)
            start_warm_up(_warm_crc, (size, tuple(shape), device),
                          "ec-crc-warm")
        return None


def _crc_device_fn(size: int):
    def device_fn(padded: torch.Tensor, device=None):
        fn = crc_fn_if_ready(size, padded.shape, device)
        return None if fn is None else (fn(padded),)

    return device_fn


def _warm_crc(size: int, shape: tuple, device) -> None:
    from . import cuda_ec
    key = (size, shape, device_warm_key(device))
    fn, err = None, None
    try:
        fn = cuda_ec.make_crc_fn(size)
        probe = torch.zeros(shape, dtype=torch.uint8, device=device)
        fn(probe)
        if probe.device.type == "cuda":
            torch.cuda.synchronize(probe.device)
    except Exception as e:
        fn, err = None, e.with_traceback(None)
    finally:
        with _crc_lock:
            _crc_warming.discard(key)
            if fn is not None:
                if len(_crc_fns) > 256:
                    _crc_fns.clear()
                _crc_fns[key] = fn
            else:
                _crc_warm_failed[key] = err


# mesh scrub folds: one mega CRC batch with its row length split across
# the mesh plane, the partials combined on the first member
# (cuda_ec.make_mesh_crc_fn).  Warmed like the lane fns, per (size,
# rows, plane); a cold key row-splits meanwhile, and a failed warm-up is
# raised by every later mesh dispatch of that key (the dispatch then
# degrades the batch to row splits).
_crc_mesh_fns: dict = {}
_crc_mesh_warming: set = set()
_crc_mesh_failed: dict = {}


def _crc_mesh_fn(size: int):
    def mesh_fn(batch, plane, donate=False, keep_resident=False):
        key = (size, batch.shape[0], plane.key())
        with _crc_lock:
            fn = _crc_mesh_fns.get(key)
            if fn is None:
                err = _crc_mesh_failed.get(key)
                if err is not None:
                    raise RuntimeError(
                        f"mesh scrub CRC warm-up at {key[:2]} failed: "
                        f"{type(err).__name__}: {err}") from err
                if key not in _crc_mesh_warming:
                    _crc_mesh_warming.add(key)
                    start_warm_up(_warm_crc_mesh, key,
                                  "ec-crc-mesh-warm")
                return None
        return (fn(batch),), None

    return mesh_fn


def _warm_crc_mesh(size: int, B: int, plane_key: tuple) -> None:
    from . import cuda_ec
    key = (size, B, plane_key)
    fn, err = None, None
    try:
        devices, n_dp, n_ls = plane_key
        fn = cuda_ec.make_mesh_crc_fn(size, devices, n_dp, n_ls)
        fn(np.zeros((B, size), dtype=np.uint8))
    except Exception as e:
        fn, err = None, e.with_traceback(None)
    finally:
        with _crc_lock:
            _crc_mesh_warming.discard(key)
            if fn is not None:
                if len(_crc_mesh_fns) > 64:
                    _crc_mesh_fns.clear()
                _crc_mesh_fns[key] = fn
            else:
                _crc_mesh_failed[key] = err


def crc_channel(size: int,
                max_coalesce: int | None = None) -> PipelineChannel:
    """Shared channel computing CRC32C(seed 0) per row of (B, size)
    batches; future outputs are ((B,) uint32,).  `max_coalesce` bounds
    rows per dispatch (the scrubber passes its
    osd_deep_scrub_stripe_batch).  Scrub-class QoS: these channels
    yield dispatch slots to client-write encodes under contention."""
    with _crc_lock:
        chan = _crc_channels.get(size)
        if chan is None:
            from . import crc32c as crc_mod

            def host_fn(batch):
                return (crc_mod.crc32c_batch(batch),)

            def route(nbytes):
                # an injected untargeted device fault serves the host,
                # as in the reference
                return not faults.get().tpu_error()

            chan = PipelineChannel(
                key=("crc", size), host_fn=host_fn,
                device_fn=_crc_device_fn(size), route=route,
                max_coalesce=max_coalesce, qos_class="scrub",
                mesh_fn=_crc_mesh_fn(size))
            _crc_channels[size] = chan
        elif max_coalesce is not None:
            # several daemons share this in-process registry: honor
            # the STRICTEST per-dispatch cap any of them configured
            chan.max_coalesce = max_coalesce if chan.max_coalesce \
                is None else min(chan.max_coalesce, max_coalesce)
        return chan
