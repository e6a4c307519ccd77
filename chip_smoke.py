"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives ceph_tpu_torch's EC write, scrub-CRC and rebuild path on the card
at BASELINE.md config #2 (reed_sol_van k=8 m=3, 1 MiB chunks, 32-stripe
batches: 256 MiB of data, 96 MiB of parity on the device):

  1. device and build: the card's name and power limit, the kernels
     built from ceph_tpu_torch/csrc with nvcc;
  2. each CUDA kernel entry point (gf_encode.cu plain and fused modes,
     crc32c.cu's segment and chain passes), the row CRC, the fused
     encode+CRC pass and the rebuild decode against their plain PyTorch
     versions on the same device tensors (byte-exact), at the main-path
     shape, at the 4 KiB stripe unit's (2048, 8, 4096) and at a ragged
     one, with CUDA-event times at the first two beside the bound, the
     plain version and a device-to-device copy of the bound's bytes, and
     the fused pass's device-bytes model; then the encode, fused pass and
     decode of the k=2 m=1, k=4 m=2 and k=12 m=4 profiles, byte-exact;
  3. the codec through the registry (plugin "tpu", host_cutover pinned
     to the device): fused encode+CRC (a first call, then the counted
     one) and a three-erasure rebuild,
     checked against the host oracle (native GF + CRC32C);
  4. the object path: ecutil.encode_object / decode_object of a seeded
     64 MiB payload at 1 MiB and at the default 4 KiB stripe unit.

Phases 3-4 already run through the dispatch pipeline (ops/pipeline.py:
one lane per card, its own CUDA stream, pinned staging).  Phases 5-8
drive it under load at config #2 with pipeline depth 2, max_batch 256
and a 4 GiB HBM stripe cache, at the 1 MiB and the 4 KiB stripe unit:

  5. pipelined writes: 8 producer threads write 64 seeded 16 MiB objects
     through ecutil.encode_object_async with a CacheIntent each, every
     shape warm first; every shard and stripe CRC against the host
     oracle; write GB/s on the host clock, dispatches, stripes per
     dispatch, the H2D/D2H identities, and the card's busy share from a
     torch.profiler trace; gf_encode_crc and crc32c_chain launches equal
     the device dispatches;
  6. pipelined rebuilds: concurrent decodes of every object with 3
     chunks lost, bit-exact; gf_encode launches equal the dispatches;
  7. deep scrub: every shard as a row through crc_channel(2 MiB,
     max_coalesce=64), CRCs equal the host's, one corrupted row flagged,
     crc32c_segments = crc32c_chain = CRC dispatches; the committed
     cache entries' scrub folds equal the shard CRCs with no H2D, their
     shard_bytes/data_bytes are bit-exact, and one append_through equals
     a fresh encode of the appended object;
  8. traces: one traced write carries the ec.coalesce, ec.stage_h2d,
     ec.device_compute and ec.d2h spans.

Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.  Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.tools.kernel_probe import time_ms

SEED = 20261016
K, M, L_MAIN, B_MAIN = 8, 3, 1 << 20, 32
STRIPE_UNIT = (2048, 4096)           # (B, L) at the 4 KiB stripe unit
RAGGED = (3, 1000)                   # (B, L)
ERASED = (0, 4, 9)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
NONTENSOR_OPS_PER_S = 67e12          # H100 SXM outside the tensor cores
PROFILES = ((2, 1), (4, 2), (12, 4))  # (k, m) checked beside k=8 m=3
PROFILE_SHAPE = (64, 1 << 16)        # (B, L)
SEG = 4096                           # bytes per CRC segment
TIMED_RUNS = 10
PLAIN_RUNS = 3
WARM_TIMEOUT_S = 300.0
OBJECT_BYTES = 64 << 20


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_u8(shape, gen, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                         device=device)


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    a, b = (t.view(torch.int32).to(torch.int64) if t.dtype == torch.uint32
            else t.to(torch.int64) for t in (a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a - b).abs().max().item()) if a.numel() else 0


def copy_ms(nbytes: int, device) -> float:
    """Device-to-device copy that moves `nbytes` in all (reads half,
    writes half): the bandwidth yardstick."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    return time_ms(lambda s: dst.copy_(s), [src] * TIMED_RUNS)["ms"]


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    by_bytes = bytes_bound_ms(nbytes)
    by_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def fused_device_bytes(B: int, L: int) -> dict:
    """Device traffic of one fused encode+CRC pass, by design: the data
    read once, the parity written once, the segment CRCs written and read
    back by the chain pass, the row CRCs written; beside it a two-launch
    composition (encode, then CRC launches that re-read data and parity)
    and the bound's bytes."""
    nseg = -(-L // SEG)
    crcs = 4 * B * (K + M)
    return {"model": B * K * L + B * M * L + 2 * crcs * nseg + crcs,
            "two_launch_model": 2 * (B * K * L + B * M * L)
            + 2 * crcs * nseg + crcs,
            "bound": B * (K + M) * L + crcs}


def rebuild_matrix(gf, coding, k, m, erased):
    """Decode rows for the erased data chunks, and the chunks read."""
    present = [i for i in range(k + m) if i not in erased][:k]
    want = [i for i in erased if i < k]
    inv = gf.decode_matrix(gf.systematic_generator(coding, k), k, present)
    return inv[want], present, want


def phase_kernels(device, gen, cuda_ec, ec_kernels, gf):
    """Every kernel entry point and composite against its plain version at
    the main-path shape, the 4 KiB stripe unit's and a ragged one;
    returns per-kernel timing rows per timed shape."""
    coding = gf.reed_sol_van_matrix(K, M)
    dmat, present, want = rebuild_matrix(gf, coding, K, M, ERASED)
    W = len(want)
    rows = {}
    for B, L in ((B_MAIN, L_MAIN), STRIPE_UNIT, RAGGED):
        timed = (B, L) != RAGGED
        inputs = [rand_u8((B, K, L), gen, device)
                  for _ in range(TIMED_RUNS if timed else 2)]
        x = inputs[0]
        N, NC, nseg = B * K, B * (K + M), -(-L // SEG)
        enc = cuda_ec.make_encode_fn(coding, L)
        plain_enc = ec_kernels.make_codec_fn(coding)

        def plain_enc_seg(t):
            p = plain_enc(t)
            return p, ec_kernels.segment_crcs(torch.cat([t, p], 1), SEG)

        flats = [t.view(N, L) for t in inputs]
        surv = [torch.cat([t, enc(t)], 1)[:, present].contiguous()
                for t in inputs]
        segs = [cuda_ec.gf_encode_segment_crcs(coding, t)[1].view(NC, nseg)
                for t in inputs]
        fb = fused_device_bytes(B, L)
        gf_ops, crc_ops = B * M * K * L, B * (K + M) * L
        work = {
            # name: (kernel fn, plain fn, inputs, bytes, ops)
            "gf_encode": (enc, plain_enc, inputs, B * (K + M) * L, gf_ops),
            "gf_encode_crc": (
                lambda t: cuda_ec.gf_encode_segment_crcs(coding, t),
                plain_enc_seg, inputs, B * (K + M) * L + 4 * NC * nseg,
                gf_ops + crc_ops),
            "crc32c_segments": (
                cuda_ec.crc32c_segments,
                lambda r: ec_kernels.segment_crcs(r, SEG), flats,
                N * L + 4 * N * nseg, N * L),
            # an advance is 8 table lookups and 8 XORs
            "crc32c_chain": (
                cuda_ec.crc32c_chain,
                lambda s: ec_kernels.chain_crcs(s, SEG), segs,
                4 * NC * nseg + 4 * NC, 16 * NC * nseg),
            "crc32c": (cuda_ec.make_crc_fn(L), ec_kernels.make_crc_fn(L),
                       flats, N * L + 4 * N, N * L),
            "encode_crc": (cuda_ec.make_encode_crc_fn(coding, L),
                           ec_kernels.make_encode_crc_fn(coding, L),
                           inputs, fb["bound"], gf_ops + crc_ops),
            "gf_decode": (cuda_ec.make_encode_fn(dmat, L),
                          ec_kernels.make_codec_fn(dmat), surv,
                          B * (K + W) * L, B * W * K * L),
        }
        errs = {name: max_abs_err(fn(xs[0]), plain(xs[0]))
                for name, (fn, plain, xs, _, _) in work.items()}
        if not torch.equal(work["gf_decode"][0](surv[0]), x[:, want]):
            raise AssertionError(f"rebuild of {want} at {(B, L)} is wrong")
        torch.cuda.synchronize()
        bad = {n: e for n, e in errs.items() if e}
        if bad:
            raise AssertionError(f"kernel != plain at {(B, L)}: {bad}")
        emit("kernels_vs_plain", shape=[B, K, L], tolerance=0,
             max_abs_err=errs)
        if not timed:
            continue

        shape_rows = rows[(B, L)] = {}
        for name, (fn, plain, xs, nbytes, ops) in work.items():
            b_ms, b_by = bound(nbytes, ops)
            t = time_ms(fn, xs)
            shape_rows[name] = {
                "ms": t["ms"], "b2b_ms": t["b2b_ms"],
                "plain_ms": time_ms(plain, xs[:PLAIN_RUNS])["ms"],
                "copy_ms": copy_ms(nbytes, device),
                "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": errs[name],
            }
            emit("kernel_time", name=name, shape=[B, K, L],
                 **shape_rows[name])
        emit("fused_bytes", shape=[B, K, L],
             device_bytes_model=fb["model"],
             device_mib_model=fb["model"] / 2**20,
             two_launch_mib_model=fb["two_launch_model"] / 2**20,
             bound_mib=fb["bound"] / 2**20,
             bound_ms=bytes_bound_ms(fb["bound"]),
             ms=shape_rows["encode_crc"]["ms"])
        del inputs, flats, surv, segs, x, work
    return rows


def phase_profiles(device, gen, cuda_ec, ec_kernels, gf):
    """The encode, the fused pass and a rebuild of as many data chunks as
    there are parity chunks, for the other profiles (one row and column
    group, and the generic kernels past 8 columns), byte-exact."""
    for k, m in PROFILES:
        coding = gf.reed_sol_van_matrix(k, m)
        dmat, present, want = rebuild_matrix(gf, coding, k, m,
                                             tuple(range(m)))
        for B, L in (PROFILE_SHAPE, RAGGED):
            x = rand_u8((B, k, L), gen, device)
            parity = cuda_ec.make_encode_fn(coding, L)(x)
            surv = torch.cat([x, parity], 1)[:, present].contiguous()
            errs = {
                "gf_encode": max_abs_err(
                    parity, ec_kernels.make_codec_fn(coding)(x)),
                "encode_crc": max_abs_err(
                    cuda_ec.make_encode_crc_fn(coding, L)(x),
                    ec_kernels.make_encode_crc_fn(coding, L)(x)),
                "gf_decode": max_abs_err(
                    cuda_ec.make_encode_fn(dmat, L)(surv), x[:, want]),
            }
            torch.cuda.synchronize()
            if any(errs.values()):
                raise AssertionError(f"k={k} m={m} at {(B, L)}: {errs}")
            emit("profile_vs_plain", k=k, m=m, shape=[B, k, L],
                 tolerance=0, max_abs_err=errs)


def wait_warm(get_fn, what: str):
    t0 = time.monotonic()
    while True:
        fn = get_fn()
        if fn is not None:
            return time.monotonic() - t0
        if time.monotonic() - t0 > WARM_TIMEOUT_S:
            raise TimeoutError(f"device warm-up of {what} not ready after "
                               f"{WARM_TIMEOUT_S:.0f}s")
        time.sleep(0.05)


# per fused encode: gf_encode.cu once (fused mode), crc32c.cu once (chain)
ENCODE_LAUNCHES = {"gf_encode": 0, "gf_encode_crc": 1, "crc32c_segments": 0,
                   "crc32c_chain": 1}
DECODE_LAUNCHES = {"gf_encode": 1, "gf_encode_crc": 0, "crc32c_segments": 0,
                   "crc32c_chain": 0}


def counted(cuda_ec, tally, expect, what, fn):
    """Run one main-path op with every launch count set to 0 just before
    it; the counts read just after must be exactly `expect` (so the op
    went through the kernels, and only once).  Adds them to `tally`."""
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = cuda_ec.launch_counts()
    if got != expect:
        raise AssertionError(f"{what}: kernel launches {got}, want {expect}")
    for name, n in got.items():
        tally[name] += n
    return out


def host_oracle(coding, stripes, native, crc_mod):
    parity = native.gf_encode_batch(coding, stripes)
    if parity is None:
        raise RuntimeError("native host GF kernels unavailable")
    allc = np.concatenate([stripes, parity], axis=1)
    S, km, L = allc.shape
    return allc, crc_mod.crc32c_batch(allc.reshape(S * km, L)).reshape(S, km)


def phase_codec(rng, registry, native, crc_mod, cuda_ec, ec_pipeline,
                tally):
    codec = registry.factory("tpu", {"k": str(K), "m": str(M),
                                     "technique": "reed_sol_van",
                                     "host_cutover": "1"})
    be = codec.backend
    stripes = rng.integers(0, 256, (B_MAIN, K, L_MAIN), dtype=np.uint8)
    present = codec.minimum_to_decode(
        [i for i in ERASED if i < K],
        [i for i in range(K + M) if i not in ERASED])
    want = [i for i in ERASED if i < K]
    rows = codec._decode_rows(want, present)
    warm_s = wait_warm(lambda: be.fused_fn_if_ready(
        codec.coding_matrix, stripes.shape), "fused encode+crc")
    shape = (B_MAIN, len(present), L_MAIN)
    warm_s += wait_warm(lambda: be.device_fn_if_ready(
        "bytes", rows, (), shape), "rebuild decode")

    # the lane's first dispatch of a size allocates its pinned staging
    # and readback buffers; the counted call after it is the steady state
    t0 = time.perf_counter()
    codec.encode_stripes_with_crcs(stripes)
    first_s = time.perf_counter() - t0
    d2h0 = ec_pipeline.stats()["bytes_d2h"]
    t0 = time.perf_counter()
    allc, crcs = counted(cuda_ec, tally, ENCODE_LAUNCHES, "codec encode",
                         lambda: codec.encode_stripes_with_crcs(stripes))
    enc_s = time.perf_counter() - t0
    d2h = ec_pipeline.stats()["bytes_d2h"] - d2h0
    want_d2h = B_MAIN * M * L_MAIN + 4 * B_MAIN * (K + M)
    if d2h != want_d2h:
        raise AssertionError(f"fused pass fetched {d2h} B, want {want_d2h}")
    ref_allc, ref_crcs = host_oracle(codec.coding_matrix, stripes, native,
                                     crc_mod)
    if not (np.array_equal(allc, ref_allc)
            and np.array_equal(crcs, ref_crcs)):
        raise AssertionError("device encode+crc != host oracle")

    surv = np.ascontiguousarray(allc[:, present])
    t0 = time.perf_counter()
    rebuilt = counted(cuda_ec, tally, DECODE_LAUNCHES, "codec decode",
                      lambda: codec.decode_batch(want, present, surv))
    dec_s = time.perf_counter() - t0
    if not np.array_equal(rebuilt, stripes[:, want]):
        raise AssertionError("device rebuild != original chunks")
    stats = codec.stat_counters()
    if stats["device_stripe_passes"] < 1 or codec.degraded:
        raise AssertionError(f"device path not taken: {stats}, "
                             f"degraded={codec.degraded}")
    emit("codec", warm_s=warm_s, stats=dict(stats), d2h_bytes=d2h,
         first_encode_gbs=stripes.nbytes / first_s / 1e9,
         encode_gbs=stripes.nbytes / enc_s / 1e9,
         decode_gbs=surv.nbytes / dec_s / 1e9,
         note="host clock through the pipeline, includes H2D of inputs "
         "and D2H of outputs; first_encode_gbs includes pinned-buffer "
         "allocation")
    return codec


def phase_objects(rng, codec, ecutil, crc_mod, cuda_ec, tally):
    payload = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
    be = codec.backend
    dropped = (1, 5, 10)
    for unit in (1 << 20, ecutil.DEFAULT_STRIPE_UNIT):
        sinfo = ecutil.StripeInfo(K, unit)
        S = sinfo.stripe_count(len(payload))
        shape = (be.pad_batch(np.empty((S, 1, 1), np.uint8)).shape[0], K,
                 sinfo.chunk_size)
        want = [i for i in dropped if i < K]
        present = codec.minimum_to_decode(
            want, [i for i in range(K + M) if i not in dropped])
        rows = codec._decode_rows(want, present)
        warm_s = wait_warm(lambda: be.fused_fn_if_ready(
            codec.coding_matrix, shape), f"encode at {shape}")
        warm_s += wait_warm(lambda: be.device_fn_if_ready(
            "bytes", rows, (), shape), f"decode at {shape}")
        passes0 = codec.stat_counters()["device_stripe_passes"]
        t0 = time.perf_counter()
        shards, shard_crcs = counted(
            cuda_ec, tally, ENCODE_LAUNCHES, f"object encode at {unit} B",
            lambda: ecutil.encode_object(codec, sinfo, payload))
        enc_s = time.perf_counter() - t0
        if codec.stat_counters()["device_stripe_passes"] != passes0 + 1:
            raise AssertionError(f"object encode at {unit} B missed the "
                                 "device")
        for c, shard in enumerate(shards):
            if shard_crcs[c] != crc_mod.crc32c(0, bytes(shard)):
                raise AssertionError(f"shard {c} crc mismatch at {unit} B")
        kept = {i: bytes(s) for i, s in enumerate(shards)
                if i not in dropped}
        t0 = time.perf_counter()
        back = bytes(counted(
            cuda_ec, tally, DECODE_LAUNCHES, f"object decode at {unit} B",
            lambda: ecutil.decode_object(codec, sinfo, kept, len(payload))))
        dec_s = time.perf_counter() - t0
        if back != payload:
            raise AssertionError(f"decode_object at {unit} B not bit-exact")
        emit("object", stripe_unit=unit, stripes=S, warm_s=warm_s,
             encode_gbs=len(payload) / enc_s / 1e9,
             decode_gbs=len(payload) / dec_s / 1e9,
             note="host clock, whole ecutil call")


# -- phases 5-8: the dispatch pipeline under load ---------------------------

PIPE_DEPTH, PIPE_MAX_BATCH = 2, 256       # osd_ec_pipeline_depth/_max_batch
HBM_CACHE_BYTES = 4 << 30
PIPE_OBJECTS, PIPE_OBJECT_BYTES, PRODUCERS = 64, 16 << 20, 8
SCRUB_BATCH = 64                          # osd_deep_scrub_stripe_batch
PIPE_UNITS = (1 << 20, 4096)              # stripe units written
LOST = (1, 5, 10)
APPEND_BYTES = (1 << 20) + 12345


class _Clock:
    def now(self):
        return time.monotonic()


def pipe_delta(ec_pipeline, before: dict) -> dict:
    after = ec_pipeline.stats()
    return {k: after[k] - before[k] for k in
            ("dispatches", "dev_dispatches", "host_dispatches", "stripes",
             "bytes_h2d", "bytes_d2h", "device_errors", "quarantines",
             "arena_uploads", "replans")}


def launches_must_equal(cuda_ec, tally, expect: dict, what: str) -> dict:
    """Counts read just after a counted window (zeroed just before it)."""
    got = cuda_ec.launch_counts()
    if got != expect:
        raise AssertionError(f"{what}: kernel launches {got}, want {expect}")
    for name, n in got.items():
        tally[name] += n
    return got


def run_producers(fn, n: int) -> list:
    """fn(i) for i < n on PRODUCERS threads; results in order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(PRODUCERS) as pool:
        return list(pool.map(fn, range(n)))


def device_busy_share(prof, wall_s: float):
    """Kernel + memcpy time on the card over the wall time of the traced
    window: the union of the trace's CUDA activity intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return None, 0
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return busy / 1e6 / wall_s, len(spans)


def warm_buckets(S: int) -> list:
    """Padded stripe counts a coalesced batch of whole S-stripe items
    can reach with PRODUCERS items in flight."""
    out = {S_pad for S_pad in (1 << (j * S - 1).bit_length()
                               for j in range(1, PRODUCERS + 1)
                               if j == 1 or j * S <= PIPE_MAX_BATCH)}
    return sorted(out)


def phase_pipelined_writes(payloads, codec, ecutil, hbm_cache, ec_pipeline,
                           optracker, native, crc_mod, cuda_ec, device,
                           tally):
    be = codec.backend
    written = {}
    for unit in PIPE_UNITS:
        sinfo = ecutil.StripeInfo(K, unit)
        S = sinfo.stripe_count(PIPE_OBJECT_BYTES)
        L = sinfo.chunk_size
        warm_s = 0.0
        for S_pad in warm_buckets(S):
            warm_s += wait_warm(lambda: be.fused_fn_if_ready(
                codec.coding_matrix, (S_pad, K, L), device),
                f"encode at {(S_pad, K, L)}")
        cid = f"pg_{unit}"
        tracker = optracker.OpTracker(_Clock(), history_size=PIPE_OBJECTS)
        spans: dict = {}
        durations = []

        def write(i, cached=True):
            intent = hbm_cache.CacheIntent(cid, f"obj{i}", (1, i),
                                           PIPE_OBJECT_BYTES, L) \
                if cached else None
            op = tracker.create(f"write obj{i}")
            with optracker.op_context(op):
                out = ecutil.encode_object_async(
                    codec, sinfo, memoryview(payloads[i]),
                    cache=intent).result(60)
            op.finish()
            if cached:
                doc = op.dump()
                durations.append(doc["duration"])
                for sp in doc["spans"]:
                    spans.setdefault(sp["name"], []).append(
                        sp["t1"] - sp["t0"])
            return out

        def window(fn, what):
            torch.cuda.synchronize()
            cuda_ec.reset_launches()
            before = ec_pipeline.stats()
            t0 = time.perf_counter()
            out = run_producers(fn, PIPE_OBJECTS)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            d = pipe_delta(ec_pipeline, before)
            launches_must_equal(cuda_ec, tally, {
                "gf_encode": 0, "gf_encode_crc": d["dev_dispatches"],
                "crc32c_segments": 0, "crc32c_chain": d["dev_dispatches"]},
                f"{what} at {unit} B")
            if d["host_dispatches"] or not d["dev_dispatches"]:
                raise AssertionError(f"{what} at {unit} B left the card: "
                                     f"{d}")
            # every object is over ARENA_MIN_BYTES: each dispatch uploads
            # its items straight from their pinned arenas
            if device.type == "cuda" and \
                    d["arena_uploads"] != d["dev_dispatches"]:
                raise AssertionError(f"{what} at {unit} B: dispatches "
                                     f"bypassed the arenas: {d}")
            return out, wall, d

        # pass 1, under the profiler: the card's busy share; pass 2,
        # profiler off: write GB/s, the checks and the cache entries
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            _, prof_wall, _ = window(lambda i: write(i, cached=False),
                                     "profiled writes")
        results, wall, d = window(write, "pipelined writes")
        # parity-only readback: per dispatch S_pad*K*L up,
        # S_pad*(M*L + 4*(K+M)) down
        per_stripe_up, per_stripe_down = K * L, M * L + 4 * (K + M)
        if d["bytes_h2d"] % per_stripe_up or \
                d["bytes_d2h"] * per_stripe_up != \
                d["bytes_h2d"] * per_stripe_down or \
                d["bytes_h2d"] < PIPE_OBJECTS * S * per_stripe_up:
            raise AssertionError(f"transfer identity broken at {unit}: {d}")
        for i, (shards, stripe_crcs) in enumerate(results):
            stripes = payloads[i].reshape(S, K, L)
            allc, crcs = host_oracle(codec.coding_matrix, stripes, native,
                                     crc_mod)
            if not np.array_equal(stripe_crcs, crcs):
                raise AssertionError(f"object {i} CRCs != oracle at {unit}")
            for c in range(K + M):
                if not np.array_equal(np.frombuffer(shards[c], np.uint8),
                                      allc[:, c].reshape(-1)):
                    raise AssertionError(f"object {i} shard {c} != oracle")
        for i in range(PIPE_OBJECTS):
            if not hbm_cache.get().commit(cid, f"obj{i}", (1, i)):
                raise AssertionError(f"object {i} at {unit} B not staged")
        try:
            busy, n_events = device_busy_share(prof, prof_wall)
        except (AttributeError, TypeError, ValueError) as e:
            busy, n_events = None, f"not measured: {e!r}"
        emit("pipelined_writes", stripe_unit=unit, objects=PIPE_OBJECTS,
             producers=PRODUCERS, warm_s=warm_s, wall_s=wall,
             write_gbs=PIPE_OBJECTS * PIPE_OBJECT_BYTES / wall / 1e9,
             dispatches=d["dev_dispatches"],
             stripes_per_dispatch=d["stripes"] / d["dispatches"],
             bytes_h2d=d["bytes_h2d"], bytes_d2h=d["bytes_d2h"],
             arena_uploads=d["arena_uploads"], replans=d["replans"],
             h2d_identity="S_pad*k*L per dispatch",
             d2h_identity="S_pad*(m*L+4*(k+m)) per dispatch",
             padded_stripes=d["bytes_h2d"] // per_stripe_up,
             device_busy_share=busy, profiler_device_events=n_events,
             profiled_write_gbs=PIPE_OBJECTS * PIPE_OBJECT_BYTES
             / prof_wall / 1e9,
             op_ms=1e3 * float(np.mean(durations)),
             span_ms={n: 1e3 * float(np.mean(v)) for n, v in spans.items()},
             note="host clock over all producers; busy share from the "
             "profiled pass (no cache intents), the rest from the second")
        written[unit] = (sinfo, results)
    return written


def phase_pipelined_rebuilds(payloads, written, codec, ecutil, ec_pipeline,
                             cuda_ec, device, tally):
    be = codec.backend
    want = [i for i in LOST if i < K]
    present = codec.minimum_to_decode(
        want, [i for i in range(K + M) if i not in LOST])
    rows = codec._decode_rows(want, present)
    for unit, (sinfo, results) in written.items():
        S, L = sinfo.stripe_count(PIPE_OBJECT_BYTES), sinfo.chunk_size
        for S_pad in warm_buckets(S):
            wait_warm(lambda: be.device_fn_if_ready(
                "bytes", rows, (), (S_pad, len(present), L), device),
                f"decode at {(S_pad, L)}")
        kept = [{c: shards[c] for c in range(K + M) if c not in LOST}
                for shards, _ in results]

        def rebuild(i):
            return bytes(ecutil.decode_object(codec, sinfo, kept[i],
                                              PIPE_OBJECT_BYTES))

        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        t0 = time.perf_counter()
        back = run_producers(rebuild, PIPE_OBJECTS)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        d = pipe_delta(ec_pipeline, before)
        launches_must_equal(cuda_ec, tally, {
            "gf_encode": d["dev_dispatches"], "gf_encode_crc": 0,
            "crc32c_segments": 0, "crc32c_chain": 0},
            f"pipelined rebuilds at {unit} B")
        if d["host_dispatches"] or not d["dev_dispatches"]:
            raise AssertionError(f"rebuilds at {unit} B left the card: {d}")
        for i, b in enumerate(back):
            if b != payloads[i].tobytes():
                raise AssertionError(f"rebuild of object {i} at {unit} B")
        emit("pipelined_rebuilds", stripe_unit=unit, lost=list(LOST),
             dispatches=d["dev_dispatches"],
             stripes_per_dispatch=d["stripes"] / d["dispatches"],
             bytes_h2d=d["bytes_h2d"], bytes_d2h=d["bytes_d2h"],
             rebuild_gbs=PIPE_OBJECTS * PIPE_OBJECT_BYTES / wall / 1e9,
             note="host clock over all producers")


def phase_deep_scrub(payloads, written, codec, ecutil, hbm_cache,
                     ec_pipeline, crc_mod, cuda_ec, device, tally):
    pipe = ec_pipeline.get()
    size = PIPE_OBJECT_BYTES // K               # one shard file
    chan = ec_pipeline.crc_channel(size, max_coalesce=SCRUB_BATCH)
    S_pad = 1
    while S_pad <= SCRUB_BATCH:
        wait_warm(lambda: ec_pipeline.crc_fn_if_ready(size, (S_pad, size),
                                                      device),
                  f"scrub CRC at {(S_pad, size)}")
        S_pad *= 2
    rows = [np.frombuffer(shards[c], np.uint8).reshape(1, size)
            for _sinfo, results in written.values()
            for shards, _ in results for c in range(K + M)]
    bad = rows[7].copy()
    bad[0, size // 2] ^= 0x40
    rows.append(bad)
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    before = ec_pipeline.stats()
    t0 = time.perf_counter()
    futs = [pipe.submit(chan, r) for r in rows]
    got = np.concatenate([f.result(60)[1][0] for f in futs])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    d = pipe_delta(ec_pipeline, before)
    launches_must_equal(cuda_ec, tally, {
        "gf_encode": 0, "gf_encode_crc": 0,
        "crc32c_segments": d["dev_dispatches"],
        "crc32c_chain": d["dev_dispatches"]}, "deep scrub")
    if d["host_dispatches"] or not d["dev_dispatches"]:
        raise AssertionError(f"scrub left the card: {d}")
    want = crc_mod.crc32c_batch(np.concatenate(rows[:-1]))
    if not np.array_equal(got[:-1], want):
        raise AssertionError("scrub CRCs != host CRCs")
    if got[-1] == got[7]:
        raise AssertionError("corrupted row not flagged")

    # scrub folds of the committed cache entries: no H2D at all
    h2d0 = ec_pipeline.stats()["bytes_h2d"]
    folded, row = 0, 0
    for unit, (sinfo, results) in written.items():
        for i in range(PIPE_OBJECTS):
            ent = hbm_cache.get().lookup(f"pg_{unit}", f"obj{i}", (1, i))
            if ent is None:
                raise AssertionError(f"no cache entry for obj{i} at {unit}")
            if ecutil.fold_shard_crcs(ent.crcs, sinfo.chunk_size) != \
                    [int(c) for c in got[row: row + K + M]]:
                raise AssertionError(f"scrub fold of obj{i} at {unit} B")
            row += K + M
            folded += 1
            if bytes(ent.data_bytes()) != payloads[i].tobytes():
                raise AssertionError(f"data_bytes of obj{i} at {unit} B")
            if i % 16 == 0:
                for c in range(K + M):
                    if ent.shard_bytes(c) != bytes(results[i][0][c]):
                        raise AssertionError(f"shard_bytes obj{i} s{c}")
    fold_h2d = ec_pipeline.stats()["bytes_h2d"] - h2d0
    if fold_h2d:
        raise AssertionError(f"cache-served scrub moved {fold_h2d} B H2D")

    # append write-through: resident prefix + uploaded tail
    unit = PIPE_UNITS[0]
    sinfo, results = written[unit]
    cid = f"pg_{unit}"
    old = payloads[0].tobytes()
    new = old + np.random.default_rng(SEED + 1).integers(
        0, 256, APPEND_BYTES, dtype=np.uint8).tobytes()
    full_before = len(old) // sinfo.stripe_width
    buf = np.zeros(sinfo.stripe_count(len(new)) * sinfo.stripe_width,
                   dtype=np.uint8)
    buf[:len(new)] = np.frombuffer(new, np.uint8)
    tail = buf.reshape(-1, K, sinfo.chunk_size)[full_before:]
    t_allc, t_crcs = codec.encode_stripes_with_crcs(tail)
    if not hbm_cache.get().append_through(
            cid, "obj0", (1, 0), (2, 0), len(new), sinfo.chunk_size,
            full_before, tail, t_allc[:, K:], t_crcs) \
            or not hbm_cache.get().commit(cid, "obj0", (2, 0)):
        raise AssertionError("append_through refused")
    ent = hbm_cache.get().lookup(cid, "obj0", (2, 0))
    shards, stripe_crcs = ecutil.encode_object_async(codec, sinfo,
                                                     new).result(60)
    if bytes(ent.data_bytes()) != new or \
            not np.array_equal(ent.crcs, stripe_crcs) or \
            any(ent.shard_bytes(c) != bytes(shards[c])
                for c in range(K + M)):
        raise AssertionError("append_through != fresh encode")
    emit("deep_scrub", rows=len(rows), row_bytes=size,
         dispatches=d["dev_dispatches"],
         rows_per_dispatch=d["stripes"] / d["dispatches"],
         bytes_h2d=d["bytes_h2d"], bytes_d2h=d["bytes_d2h"],
         scrub_gbs=len(rows) * size / wall / 1e9, corrupted_flagged=True,
         cache_folds=folded, cache_fold_bytes_h2d=fold_h2d,
         append_through_ok=True, cache=hbm_cache.stats(),
         note="host clock")


def phase_traces(payloads, codec, ecutil, optracker):
    sinfo = ecutil.StripeInfo(K, PIPE_UNITS[0])
    op = optracker.OpTracker(_Clock()).create("ec write",
                                              trace_id="client.0:1")
    with optracker.op_context(op):
        ecutil.encode_object(codec, sinfo, memoryview(payloads[1]))
    op.finish()
    spans = {s["name"]: s["t1"] - s["t0"] for s in op.dump()["spans"]}
    need = ("ec.coalesce", "ec.stage_h2d", "ec.device_compute", "ec.d2h")
    missing = [n for n in need if n not in spans]
    if missing:
        raise AssertionError(f"traced write lacks spans {missing}: {spans}")
    emit("traces", spans_s=spans)


# the kernels of the main path: writes (fused pass), rebuilds, and the
# deep-scrub CRC channel (crc32c_segments + crc32c_chain)
KERNEL_META = {
    "gf_encode": ("ceph_tpu_torch/csrc/gf_encode.cu",
                  "ceph_tpu/ops/pallas_ec.py:55"),
    "gf_encode_crc": ("ceph_tpu_torch/csrc/gf_encode.cu",
                      "ceph_tpu/ops/pallas_ec.py:55"),
    "crc32c_segments": ("ceph_tpu_torch/csrc/crc32c.cu",
                        "ceph_tpu/ops/pallas_ec.py:167"),
    "crc32c_chain": ("ceph_tpu_torch/csrc/crc32c.cu",
                     "ceph_tpu/ops/pallas_ec.py:167"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ceph_tpu_torch
    from ceph_tpu_torch import native
    from ceph_tpu_torch.erasure.registry import registry
    from ceph_tpu_torch.ops import crc32c as crc_mod
    from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf, hbm_cache
    from ceph_tpu_torch.ops import pipeline as ec_pipeline
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.utils import optracker

    device = torch.device("cuda", 0)
    ceph_tpu_torch.set_device(device)
    ident = gpu_identity()
    t0 = time.perf_counter()
    logs = cuda_ec.build()
    build_s = time.perf_counter() - t0
    emit("build", gpu=ident, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         nvcc={k: v.strip()[-400:] for k, v in logs.items()})

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = phase_kernels(device, gen, cuda_ec, ec_kernels, gf)[
        (B_MAIN, L_MAIN)]
    phase_profiles(device, gen, cuda_ec, ec_kernels, gf)

    # main path: each op is counted on its own, warm-ups excluded
    rng = np.random.default_rng(SEED)
    counts = dict.fromkeys(cuda_ec.launches, 0)
    ec_pipeline.configure(depth=PIPE_DEPTH, max_batch=PIPE_MAX_BATCH,
                          hbm_cache_bytes=HBM_CACHE_BYTES)
    codec = phase_codec(rng, registry, native, crc_mod, cuda_ec,
                        ec_pipeline, counts)
    phase_objects(rng, codec, ecutil, crc_mod, cuda_ec, counts)
    payloads = [rng.integers(0, 256, PIPE_OBJECT_BYTES, dtype=np.uint8)
                for _ in range(PIPE_OBJECTS)]
    written = phase_pipelined_writes(payloads, codec, ecutil, hbm_cache,
                                     ec_pipeline, optracker, native,
                                     crc_mod, cuda_ec, device, counts)
    phase_pipelined_rebuilds(payloads, written, codec, ecutil, ec_pipeline,
                             cuda_ec, device, counts)
    phase_deep_scrub(payloads, written, codec, ecutil, hbm_cache,
                     ec_pipeline, crc_mod, cuda_ec, device, counts)
    phase_traces(payloads, codec, ecutil, optracker)
    emit("pipeline", stats={k: v for k, v in ec_pipeline.stats().items()
                            if not isinstance(v, dict)})
    ec_pipeline.get().stop()
    by_source = {src: sum(n for name, n in counts.items()
                          if name.startswith(src)) for src in cuda_ec.SOURCES}
    emit("main_path_launches", launches=counts, by_source=by_source)
    idle = [n for n in KERNEL_META if counts[n] < 1]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "b2b_ms": r["b2b_ms"], "copy_ms": r["copy_ms"]})
    print(ident, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
