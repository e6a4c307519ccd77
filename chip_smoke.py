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

  5. pipelined writes: 8 producer threads write 32 seeded 16 MiB objects
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

Phase 9 drives the port's cluster path: a vstart MiniCluster of 3 mons
and 13 MemStore OSDs in this process (11 shard holders + two spares for
the out-marked OSD's shards to remap to), one EC pool (plugin=tpu reed_sol_van k=8 m=3,
host_cutover 64 KiB, the default 4 KiB stripe unit, pg_num 64, a 4 GiB
HBM cache) and 8 librados clients.  After every OSD's codec is warm at
every batch shape the windows reach, three counted windows run:

  writes: 64 x 4 MiB write_full from the 8 clients (under
     torch.profiler: the card's busy share), read back, and 100,001 B
     appended to 8 objects; a sample of 32 objects' shard files and
     HashInfo read from the OSD stores against the host oracle;
  scrub: deep scrub of every PG (once folded from the cache, then with
     the cache cleared through the CRC kernels), zero inconsistencies,
     then one corrupted shard flagged and nothing else;
  recovery: cache cleared, one OSD killed, every object read degraded,
     the OSD marked out, until the cluster is clean; every lost shard
     must then sit rebuilt by recovery on its new holder, equal to the
     lost bytes (no scrub repair: a shard left unrebuilt fails the phase).

Phase 10 drives the front doors on a fresh cluster of phase 9's shape
(3 mons, 13 MemStore OSDs, one marked out): an EC
base pool "doors" (phase 9's code with host_cutover 1, the 4 KiB unit,
pg_num 32) behind a replicated writeback cache tier "doors-hot" (a hit
set, target_max_objects 8), a replicated CephFS metadata pool, one MDS
and one RGW gateway.  At upstream's 4 MiB object size, 8 S3 clients PUT
16 x 8 MiB over HTTP with SigV4, 2 RBD clients write their own 32 MiB
image in 4 MiB writes with the ObjectCacher on, and 2 CephFS clients
write two 16 MiB files each: 256 MiB as 64 RADOS objects.  Four counted
windows:

  flush: from the first write until every data object sits in the base
     (each flush one 128-stripe encode) and the tier is at its target
     (under torch.profiler: the card's busy share); 16 objects' shard
     files and HashInfo against the host oracle;
  promote: the tier evicted and the cache cleared, everything read back
     through its own door (S3 GET with the ETag the body's MD5, RBD
     read, CephFS read) from the base, then stat sizes through each;
  scrub: deep scrub of every PG of the base, cache cleared, zero
     inconsistencies;
  degraded promote: an OSD holding shards of the base, drawn from the
     seed, killed; the tier evicted again and everything read again
     through the doors, at least one rebuild decode among them.

Phase 11 holds the mesh functions (ops/cuda_ec.py: one batch's chunk
length split across a dp x ls plane, each member's slice through the
kernels above on its own stream) with every member on this card, at
config #2: make_mesh_encode_crc_fn at 1x2, 1x3 (L does not divide by 3:
front pad, slice CRCs advanced and XORed) and 2x2 byte for byte against
the single-device fused pass, whose sample stripes match the host
oracle, the resident tensors against the inputs and parity, and
make_mesh_crc_fn at (352, 1 MiB), 1x2 and 1x3, against crc32c_rows; the
launches of each call equal its members' slices plus the chain where it
combines; each call's median host-clock ms beside the fused pass's.  The
pipeline with mesh_min_bytes under one 128-stripe encode: with one card
no plane forms (stats()["mesh"] None, no mesh dispatch) and the write
serves bit-exact on the lane (with two or more cards it must ride the
mesh, no degrade); a mesh-sized ecutil write takes a pooled arena and
returns it.  Then graft_entry.dryrun_multichip(8): 8 members sharing the
cards, oracle-checked.

Phase 12 drives the admin tools against a cluster of port daemons on
the card (1 mon, 12 MemStore OSDs): ceph_cli sets a tpu k=8 m=3 profile
and creates an EC pool on it; rados_cli puts and gets a seeded 16 MiB
file byte for byte, then `bench 10 write -b 4194304 -t 8` and `seq`
(MB/s printed, a sample of the bench objects read back); trace_dump
renders the OSDs' op dumps as a Chrome trace with ec.* spans.

Phase 13 runs the reference's device-path test files against the port
on the card: the tests/test_torch_*.py wrappers of test_ecutil,
test_erasure, test_faults, test_hbm_cache, test_pipeline,
test_scrub_repair, test_recovery_backfill, test_ec_append and
test_cluster, each through pytest.main in this process with the port's
device on the card (tests/_port_reference.OnTheCard; no
tests/conftest.py, which imports JAX).  Every collected case must pass;
per file it prints the cases, the launches of each kernel entry point
(counts zeroed before the file) and the batches a dispatch pipeline
served on the host, and together the files must launch gf_encode_crc,
gf_encode and crc32c_chain.  A file whose cases all route to the host
at their sizes prints 0 launches; that is a finding, not a failure.
`--suite-only` runs this phase alone.

In each window of phases 9, 10 and 12 every kernel entry point launched
exactly once per device dispatch of its kind (pipeline.stats()
dev_dispatches_enc/_dec/_crc), at least one device dispatch ran (except
in phase 10's promote window: a read of an intact object may dispatch
nothing) and the host served no stripe batch; no codec degraded (checked
after each window of phase 10 and at the end of phase 9).  It
prints GB/s and op latency p50/p99 of client writes, reads and degraded
reads per door, scrub GB/s, recovery and flush seconds, the mean op
spans per write from the primaries' op trackers, and stripes per
dispatch.

Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.  Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import hashlib
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


# -- phase 9: the cluster path ------------------------------------------------
#
# A vstart cluster of ceph_tpu_torch daemons in this process: 3 mons and
# 13 MemStore OSDs (the 11 shard holders k=8 m=3 needs, plus two spares:
# with one, CRUSH leaves a hole in some PG once an OSD is marked out),
# one EC pool at the default 4 KiB stripe unit, 8 librados clients with
# one Rados handle each.

CLUSTER_MONS, CLUSTER_OSDS, CLUSTER_PG_NUM = 3, 13, 64
# 64 objects, not the 256 (1 GiB) of a full run: the cluster path runs
# at ~30 MB/s in one interpreter, and the whole script keeps to its
# time budget (object size, profile and stripe unit are not cut)
CLUSTER_OBJECTS, CLUSTER_OBJECT_BYTES = 64, 4 << 20
CLUSTER_CLIENTS = 8
CLUSTER_APPENDS, CLUSTER_APPEND_BYTES = 8, 100_001   # not a stripe multiple
CLUSTER_SAMPLE = 32
CLUSTER_UNIT = 4096                       # ecutil.DEFAULT_STRIPE_UNIT
CLUSTER_POOL = "ecpool"
# host_cutover = MIN_DEVICE_BYTES: measured routing cannot move a batch
# of 64 KiB or more to the host
CLUSTER_PROFILE = {"plugin": "tpu", "technique": "reed_sol_van",
                   "k": str(K), "m": str(M), "host_cutover": str(1 << 16)}
CLUSTER_TIMEOUT = 600.0
CLUSTER_RECOVERY_TIMEOUT = 300.0


def cluster_conf():
    from ceph_tpu_torch.utils.config import Config
    return Config({
        # MiniCluster's own defaults
        "mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
        "osd_heartbeat_grace": 8.0, "mon_osd_min_down_reporters": 2,
        # the killed OSD is marked out by hand, after the degraded reads
        "mon_osd_down_out_interval": 1e6,
        "osd_ec_hbm_cache_bytes": HBM_CACHE_BYTES,
        "osd_op_history_size": 4 * CLUSTER_OBJECTS,
        "objecter_op_timeout": 120.0})


def percentiles_ms(lat) -> dict:
    a = 1e3 * np.asarray(lat, dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def cluster_window(cuda_ec, ec_pipeline, tally, before: dict,
                   what: str, need_dispatch: bool = True) -> dict:
    """Close a counted window of the cluster phase: each kernel entry
    point launched exactly once per device dispatch of its kind, at
    least one device dispatch (unless `need_dispatch` is False), and no
    stripe batch served by the host."""
    torch.cuda.synchronize()
    after = ec_pipeline.stats()
    d = {k: after[k] - before[k] for k in (
        "dispatches", "dev_dispatches", "host_dispatches",
        "dev_dispatches_enc", "dev_dispatches_dec", "dev_dispatches_crc",
        "stripes", "bytes_h2d", "bytes_d2h", "replans")}
    launches_must_equal(cuda_ec, tally, {
        "gf_encode": d["dev_dispatches_dec"],
        "gf_encode_crc": d["dev_dispatches_enc"],
        "crc32c_segments": d["dev_dispatches_crc"],
        "crc32c_chain": d["dev_dispatches_enc"] + d["dev_dispatches_crc"]},
        what)
    if d["host_dispatches"] or (need_dispatch and not d["dev_dispatches"]):
        raise AssertionError(f"{what} left the card: {d}")
    d["stripes_per_dispatch"] = d["stripes"] / max(1, d["dispatches"])
    return d


def cluster_warm(cluster, pool_id, ec_pipeline, device) -> float:
    """Every OSD's codec (each is a primary of some PGs) warm at every
    batch shape the windows reach, and the scrub CRC channel at every
    row bucket of both shard sizes: warm-ups launch kernels and serve
    their first calls from the host, so none may happen in a window."""
    from ceph_tpu_torch.ops.pipeline import next_bucket
    L = CLUSTER_UNIT
    S = CLUSTER_OBJECT_BYTES // (K * L)
    S_app = -(-(CLUSTER_OBJECT_BYTES + CLUSTER_APPEND_BYTES) // (K * L))
    S_tail = -(-CLUSTER_APPEND_BYTES // (K * L))
    max_batch = int(cluster.conf.osd_ec_pipeline_max_batch)
    whole = {next_bucket(n) for n in (S, S_app) + ((2 * S,) if 2 * S
                                                   <= max_batch else ())}
    t0 = time.monotonic()
    for osd in cluster.osds.values():
        warm_codec(osd.get_ec_codec(osd.osdmap.pools[pool_id]),
                   sorted(whole), next_bucket(S_tail), device)
    batch = int(cluster.conf.osd_deep_scrub_stripe_batch)
    for size in (S * L, S_app * L):
        for j in range(batch.bit_length()):
            wait_warm(lambda: ec_pipeline.crc_fn_if_ready(
                size, (1 << j, size), device), f"scrub CRC of {size} B")
    return time.monotonic() - t0


def warm_codec(codec, buckets, tail_bucket: int, device) -> None:
    """One codec warm at the windows' encode and decode batch shapes."""
    L, be = CLUSTER_UNIT, codec.backend
    for S_pad in sorted(set(buckets) | {tail_bucket}):
        wait_warm(lambda: be.fused_fn_if_ready(
            codec.coding_matrix, (S_pad, K, L), device),
            f"encode at {(S_pad, K, L)}")
    for r in range(1, M + 1):
        want = list(range(r))
        present = [i for i in range(K + M) if i not in want][:K]
        rows = codec._decode_rows(want, present)
        for S_pad in buckets:
            wait_warm(lambda: be.device_fn_if_ready(
                "bytes", rows, (), (S_pad, K, L), device),
                f"decode {r} at {(S_pad, K, L)}")


def run_clients(ios, fn, n: int):
    """fn(io, i) for i < n, object i on client i % len(ios), the clients
    concurrent; returns (wall seconds, per-op seconds, results)."""
    import threading
    lat, out, errs = [0.0] * n, [None] * n, []

    def worker(t):
        try:
            for i in range(t, n, len(ios)):
                t0 = time.perf_counter()
                out[i] = fn(ios[t], i)
                lat[i] = time.perf_counter() - t0
        except Exception as e:            # noqa: BLE001 (re-raised below)
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(ios))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return wall, lat, out


def write_spans(cluster) -> dict:
    """Mean per write op of each span the primaries' op trackers kept
    (client write ops only; sub-ops are the replicas' side)."""
    spans: dict = {}
    durations = []
    for osd in cluster.osds.values():
        for doc in osd.op_tracker.dump_historic_ops()["ops"]:
            if doc.get("kind") != "client" or "writefull" not in \
                    doc["description"]:
                continue
            durations.append(doc["duration"])
            for sp in doc["spans"]:
                spans.setdefault(sp["name"], []).append(sp["t1"] - sp["t0"])
    n = max(1, len(durations))
    return {"ops": len(durations),
            "op_ms": 1e3 * float(np.sum(durations)) / n,
            "span_ms": {k: 1e3 * float(np.sum(v)) / n
                        for k, v in sorted(spans.items())}}


def codec_routing(cluster) -> dict:
    """The routing counters of every OSD's codecs, summed."""
    tot: dict = {}
    for osd in cluster.osds.values():
        for codec in osd._ec_codecs.values():
            for key, v in codec.stat_counters().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    tot[key] = tot.get(key, 0) + v
    return tot


def shard_oracle(payload: bytes, coding, native, crc_mod):
    """(S, k+m, L) chunks of `payload` at the cluster's stripe unit."""
    W = K * CLUSTER_UNIT
    S = -(-len(payload) // W)
    buf = np.zeros(S * W, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    allc, _ = host_oracle(coding, buf.reshape(S, K, CLUSTER_UNIT), native,
                          crc_mod)
    return allc


def check_shards(cluster, pool_id, oid, payload, coding, native, crc_mod,
                 denc, HINFO_KEY, only=None):
    """Every shard file of `oid` (or the shard positions in `only`) and
    its HashInfo, read straight from the holders' stores, against the
    host oracle; returns {shard: holder}."""
    osdmap = cluster.leader().osdmon.osdmap
    pgid = osdmap.object_to_pg(pool_id, oid)
    _up, acting = osdmap.pg_to_up_acting_osds(pgid)
    allc = shard_oracle(payload, coding, native, crc_mod)
    full = len(payload) // (K * CLUSTER_UNIT)
    holders = {}
    for shard, holder in enumerate(acting):
        if only is not None and shard not in only:
            continue
        store = cluster.osds[holder].store
        name = f"{oid}.s{shard}"
        data = bytes(store.read(f"pg_{pgid}", name))
        hinfo = denc.loads(store.getattr(f"pg_{pgid}", name, HINFO_KEY))
        want = allc[:, shard].tobytes()
        if data != want:
            raise AssertionError(f"{name} on osd.{holder} != oracle")
        if hinfo["crc"] != crc_mod.crc32c(0, want) or \
                hinfo["crc_prefix"] != crc_mod.crc32c(
                    0, want[:full * CLUSTER_UNIT]) or \
                hinfo["size"] != len(payload):
            raise AssertionError(f"{name} on osd.{holder}: HashInfo "
                                 f"{hinfo} != oracle")
        holders[shard] = holder
    return holders


def unclean(cluster, pool_id) -> list:
    """Why wait_for_clean would say no: per PG of the pool, the members
    whose copy is missing, incomplete or (primary) inactive."""
    osdmap = cluster.leader().osdmon.osdmap
    out = []
    for pgid in osdmap.all_pgs():
        if pgid.pool != pool_id:
            continue
        acting = osdmap.pg_to_up_acting_osds(pgid)[1]
        live = [o for o in acting if o >= 0]
        bad = []
        for o in live:
            pg = cluster.osds[o].pgs.get(pgid) if o in cluster.osds else None
            if pg is None or not pg.backfill_complete or pg.pglog.missing \
                    or (o == live[0] and (not pg.active
                                          or pg.ec_audit_pending)):
                bad.append((o, None if pg is None else (
                    pg.backfill_complete, len(pg.pglog.missing),
                    pg.active, pg.ec_audit_pending)))
        if bad or len(live) < len(acting):
            out.append((str(pgid), acting, bad))
    return out[:12]


def has_shard(cluster, pool_id, i: int, shard: int) -> bool:
    osdmap = cluster.leader().osdmon.osdmap
    pg = osdmap.object_to_pg(pool_id, f"obj{i}")
    osd = cluster.osds.get(osdmap.pg_to_up_acting_osds(pg)[1][shard])
    return osd is not None and \
        f"obj{i}.s{shard}" in osd.store.collection_list(f"pg_{pg}")


def scrub_all(cluster, pool_id, threads: int = CLUSTER_CLIENTS) -> dict:
    """Deep scrub of every PG of the pool from its primary, `threads`
    PGs at a time; returns {pgid: result}."""
    from concurrent.futures import ThreadPoolExecutor
    osdmap = cluster.leader().osdmon.osdmap
    pgids = [p for p in osdmap.all_pgs() if p.pool == pool_id]

    def one(pgid):
        _up, acting = osdmap.pg_to_up_acting_osds(pgid)
        primary = next(o for o in acting if o >= 0)
        return pgid, cluster.osds[primary].get_pg(pgid).scrub(deep=True)

    with ThreadPoolExecutor(threads) as pool:
        return dict(pool.map(one, pgids))


def phase_cluster(rng, cuda_ec, ec_pipeline, hbm_cache, native, crc_mod,
                  device, tally):
    from ceph_tpu_torch.osd.pglog import HINFO_KEY
    from ceph_tpu_torch.store import Transaction
    from ceph_tpu_torch.utils import denc
    from ceph_tpu_torch.vstart import MiniCluster

    t_start = time.perf_counter()
    cluster = MiniCluster(num_mons=CLUSTER_MONS, num_osds=CLUSTER_OSDS,
                          conf=cluster_conf())
    try:
        cluster.start(timeout=120.0)
        admin = cluster.client()
        admin.create_ec_pool(CLUSTER_POOL, "k8m3", CLUSTER_PROFILE,
                             pg_num=CLUSTER_PG_NUM)
        pool_id = admin.open_ioctx(CLUSTER_POOL).pool_id
        cluster.wait_for_clean(CLUSTER_TIMEOUT)
        boot_s = time.perf_counter() - t_start
        warm_s = cluster_warm(cluster, pool_id, ec_pipeline, device)
        coding = cluster.osds[0].get_ec_codec(
            cluster.osds[0].osdmap.pools[pool_id]).coding_matrix
        ios = [cluster.client(f"client.load{t}").open_ioctx(CLUSTER_POOL)
               for t in range(CLUSTER_CLIENTS)]
        payloads = [rng.integers(0, 256, CLUSTER_OBJECT_BYTES,
                                 dtype=np.uint8)
                    for _ in range(CLUSTER_OBJECTS)]
        nbytes = CLUSTER_OBJECTS * CLUSTER_OBJECT_BYTES
        out = {"mons": CLUSTER_MONS, "osds": CLUSTER_OSDS,
               "pg_num": CLUSTER_PG_NUM, "profile": CLUSTER_PROFILE,
               "objects": CLUSTER_OBJECTS,
               "object_bytes": CLUSTER_OBJECT_BYTES,
               "clients": CLUSTER_CLIENTS, "boot_s": boot_s,
               "warm_s": warm_s}
        emit("cluster_boot", **out)

        # -- window 1: writes, reads, appends ------------------------------
        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            w_wall, w_lat, _ = run_clients(
                ios, lambda io, i: io.write_full(f"obj{i}", payloads[i]),
                CLUSTER_OBJECTS)
        r_wall, r_lat, back = run_clients(
            ios, lambda io, i: io.read(f"obj{i}"), CLUSTER_OBJECTS)
        for i, b in enumerate(back):
            if bytes(b) != payloads[i].tobytes():
                raise AssertionError(f"read of obj{i} != payload")
        back = None
        finals = {i: payloads[i].tobytes() for i in range(CLUSTER_OBJECTS)}
        for i in range(CLUSTER_APPENDS):
            delta = rng.integers(0, 256, CLUSTER_APPEND_BYTES,
                                 dtype=np.uint8).tobytes()
            ios[0].append(f"obj{i}", delta)
            finals[i] += delta
            if bytes(ios[0].read(f"obj{i}")) != finals[i]:
                raise AssertionError(f"append to obj{i} != payload+delta")
        d_write = cluster_window(cuda_ec, ec_pipeline, tally, before,
                                 "cluster writes, reads and appends")
        try:
            busy, n_events = device_busy_share(prof, w_wall)
        except (AttributeError, TypeError, ValueError) as e:
            busy, n_events = None, f"not measured: {e!r}"
        sample = list(range(CLUSTER_APPENDS)) + [
            int(i) for i in np.linspace(CLUSTER_APPENDS, CLUSTER_OBJECTS - 1,
                                        CLUSTER_SAMPLE - CLUSTER_APPENDS)]
        for i in sample:
            check_shards(cluster, pool_id, f"obj{i}", finals[i], coding,
                         native, crc_mod, denc, HINFO_KEY)
        step = dict(
            write_gbs=nbytes / w_wall / 1e9, write_lat_ms=percentiles_ms(
                w_lat), read_gbs=nbytes / r_wall / 1e9,
            read_lat_ms=percentiles_ms(r_lat),
            read_cache_bytes_served=hbm_cache.stats()["read_bytes_served"],
            device_busy_share=busy, profiler_device_events=n_events,
            write_window=d_write, write_trace=write_spans(cluster),
            shards_checked_objects=len(sample),
            elapsed_s=time.perf_counter() - t_start)
        emit("cluster_writes", **step)
        out.update(step)

        # -- window 2: deep scrub ------------------------------------------
        # the cache holds every object, and a scrub of a cached object
        # folds its CRCs on the host from the entry (phase 7 checks
        # that path): cleared, every shard goes through the CRC kernels
        hbm_cache.get().clear()
        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        t0 = time.perf_counter()
        results = scrub_all(cluster, pool_id)
        s_wall = time.perf_counter() - t0
        if any(r["inconsistent"] for r in results.values()):
            raise AssertionError(f"clean scrub found inconsistencies")
        checked = sum(r["checked"] for r in results.values())
        osdmap = cluster.leader().osdmon.osdmap
        pgid = osdmap.object_to_pg(pool_id, "obj9")
        _up, acting = osdmap.pg_to_up_acting_osds(pgid)
        holder, name = acting[2], "obj9.s2"
        store = cluster.osds[holder].store
        good = bytes(store.read(f"pg_{pgid}", name, 4096, 16))
        store.apply_transaction(Transaction().write(
            f"pg_{pgid}", name, 4096, bytes(b ^ 0xA5 for b in good)))
        dirty = scrub_all(cluster, pool_id)
        found = [(str(p), i) for p, r in dirty.items()
                 for i in r["inconsistent"]]
        if found != [(str(pgid), {"object": name, "osd": holder})]:
            raise AssertionError(f"corrupted {name} on osd.{holder}: "
                                 f"scrub found {found}")
        store.apply_transaction(Transaction().write(
            f"pg_{pgid}", name, 4096, good))
        d_scrub = cluster_window(cuda_ec, ec_pipeline, tally, before,
                                 "cluster deep scrub")
        shard_bytes = sum(len(finals[i]) for i in finals) * (K + M) // K
        step = dict(scrub_gbs=shard_bytes / s_wall / 1e9,
                    scrub_checked=checked,
                    scrub_window=d_scrub, corrupted_flagged=found,
                    elapsed_s=time.perf_counter() - t_start)
        emit("cluster_scrub", **step)
        out.update(step)

        # -- window 3: degraded reads and recovery -------------------------
        # the OSD to lose comes from the seed
        victim = int(rng.integers(CLUSTER_OSDS))
        lost = {}
        for i in range(CLUSTER_OBJECTS):
            oid = f"obj{i}"
            pg = osdmap.object_to_pg(pool_id, oid)
            _up, acting = osdmap.pg_to_up_acting_osds(pg)
            if victim in acting:
                shard = acting.index(victim)
                lost[i] = (shard, bytes(cluster.osds[victim].store.read(
                    f"pg_{pg}", f"{oid}.s{shard}")))
        hbm_cache.get().clear()
        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        cluster.kill_osd(victim)
        cluster.mark_osd_down(victim)
        cluster.wait_for_osd_down(victim, 60.0)
        g_wall, g_lat, back = run_clients(
            ios, lambda io, i: io.read(f"obj{i}"), CLUSTER_OBJECTS)
        for i, b in enumerate(back):
            if bytes(b) != finals[i]:
                raise AssertionError(f"degraded read of obj{i} != payload")
        back = None
        emit("cluster_degraded_reads",
             degraded_read_gbs=sum(map(len, finals.values())) / g_wall / 1e9,
             degraded_read_lat_ms=percentiles_ms(g_lat),
             elapsed_s=time.perf_counter() - t_start)
        t0 = time.perf_counter()
        cluster.mark_osd_out(victim)
        try:
            cluster.wait_for_clean(CLUSTER_RECOVERY_TIMEOUT)
        except TimeoutError:
            raise TimeoutError(f"not clean: {unclean(cluster, pool_id)}")
        recovery_s = time.perf_counter() - t0
        # clean includes every EC primary's role audit: each lost shard
        # file must already sit on its new holder
        absent = [(i, shard) for i, (shard, _d) in lost.items()
                  if not has_shard(cluster, pool_id, i, shard)]
        if absent:
            raise AssertionError(f"clean, but lost shards not rebuilt: "
                                 f"{absent} {unclean(cluster, pool_id)}")
        d_rec = cluster_window(cuda_ec, ec_pipeline, tally, before,
                               "cluster degraded reads and recovery")
        osdmap = cluster.leader().osdmon.osdmap
        for i, (shard, data) in lost.items():
            pg = osdmap.object_to_pg(pool_id, f"obj{i}")
            holder = osdmap.pg_to_up_acting_osds(pg)[1][shard]
            if holder == victim or bytes(
                    cluster.osds[holder].store.read(
                        f"pg_{pg}", f"obj{i}.s{shard}")) != data:
                raise AssertionError(f"rebuilt obj{i}.s{shard} != lost")
            if i in sample:
                check_shards(cluster, pool_id, f"obj{i}", finals[i], coding,
                             native, crc_mod, denc, HINFO_KEY, only={shard})
        # every acknowledged write reads back from the recovered pool
        _wall, _lat, back = run_clients(
            ios, lambda io, i: io.read(f"obj{i}"), CLUSTER_OBJECTS)
        for i, b in enumerate(back):
            if bytes(b) != finals[i]:
                raise AssertionError(f"obj{i} after recovery != payload")
        back = None
        step = dict(degraded_read_gbs=sum(map(len, finals.values()))
                   / g_wall / 1e9, degraded_read_lat_ms=percentiles_ms(
                       g_lat), victim=victim, recovery_s=recovery_s,
                   rebuilt_shards_checked=len(lost),
                   recovery_window=d_rec,
                   codecs_degraded=degraded_codecs(cluster),
                   routing=codec_routing(cluster),
                   elapsed_s=time.perf_counter() - t_start)
        emit("cluster_recovery", **step)
        if step["codecs_degraded"]:
            raise AssertionError("an OSD's codec degraded to the host")
        out.update(step)
        return out
    finally:
        cluster.stop()
        ec_pipeline.get().stop()


# Phase 10: the front doors (S3, RBD, CephFS) over a writeback cache
# tier in front of a k=8 m=3 EC base.  The doors' objects are upstream's
# default 4 MiB (ceph_file_layout, RBD order 22, the RGW stripe), so each
# flush to the base is one 128-stripe encode, phase 9's batch shape.
# Cut: one base pool shared by the three doors.
DOORS_POOL, DOORS_HOT, DOORS_META = "doors", "doors-hot", "cephfs_metadata"
DOORS_PG_NUM, DOORS_META_PG_NUM = 32, 16
# phase 9's code with host_cutover 1: the doors' metadata objects (bucket
# index, rbd_header, ...) hold no data and flush as one 32 KiB stripe,
# under 64 KiB; at phase 9's cutover the host would encode them
DOORS_PROFILE_NAME = "k8m3-doors"
DOORS_PROFILE = {**CLUSTER_PROFILE, "host_cutover": "1"}
# target / pg_num < 1 object per tier PG: every full agent scan evicts
# whatever it finds clean, so the agent evicts all it flushes
DOORS_TARGET_MAX_OBJECTS = 8
DOORS_HIT_SET = {"hit_set_count": "2", "hit_set_period": "10.0"}
DOORS_OBJECT_BYTES = 4 << 20
DOORS_ACCESS, DOORS_SECRET = "AKIACHIPSMOKE", "chip-smoke-secret"
DOORS_BUCKET = "doors"
S3_CLIENTS, S3_OBJECTS, S3_OBJECT_BYTES = 8, 16, 8 << 20
RBD_CLIENTS, RBD_IMAGE_BYTES, RBD_ORDER = 2, 32 << 20, 22
FS_CLIENTS, FS_FILES, FS_FILE_BYTES = 2, 2, 16 << 20
DOORS_SAMPLE = 16
DOORS_TIMEOUT = 300.0


def s3_request(port: int, method: str, path: str, data: bytes = b""):
    """One SigV4-signed S3 request to the gateway: (headers, body)."""
    import urllib.error
    import urllib.request
    from ceph_tpu_torch.rgw import auth_v4
    host = f"127.0.0.1:{port}"
    headers = auth_v4.sign_v4(method, path, "", {"host": host}, data,
                              DOORS_ACCESS, DOORS_SECRET)
    headers["Host"] = host
    req = urllib.request.Request(f"http://{host}{path}", data=data or None,
                                 method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=CLUSTER_TIMEOUT) as resp:
            return resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        raise AssertionError(f"S3 {method} {path}: {e.code} "
                             f"{e.read()[:300]!r}") from e


def etag_of(headers) -> str:
    return headers["ETag"].strip('"')


def tier_names(cluster, pool_id: int) -> set:
    """Object names in a replicated pool, from its PG primaries."""
    names = set()
    for osd in cluster.osds.values():
        for pgid, pg in list(osd.pgs.items()):
            if pgid.pool != pool_id or not pg.is_primary:
                continue
            names |= {n for n in osd.store.collection_list(f"pg_{pgid}")
                      if not n.startswith("_pgmeta") and "@" not in n}
    return names


def in_base(cluster, base_id: int, oids) -> set:
    """The oids whose k+m shard files all sit on their acting set."""
    osdmap = cluster.leader().osdmon.osdmap
    listed = {}
    out = set()
    for oid in oids:
        pgid = osdmap.object_to_pg(base_id, oid)
        acting = osdmap.pg_to_up_acting_osds(pgid)[1]
        ok = True
        for shard, holder in enumerate(acting):
            osd = cluster.osds.get(holder)
            if osd is None or not osd.osdmap.is_up(holder):
                continue          # a down holder's shard stays where it was
            key = (holder, pgid)
            if key not in listed:
                listed[key] = set(osd.store.collection_list(f"pg_{pgid}"))
            ok = ok and f"{oid}.s{shard}" in listed[key]
        if ok:
            out.add(oid)
    return out


def wait_ticking(cluster, pred, timeout: float, what: str) -> float:
    """Poll `pred` while the cluster's clock runs ahead of real time (the
    tier agent works on heartbeat ticks); returns the seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(what)
        cluster.tick(0.25)
        time.sleep(0.1)
    return time.perf_counter() - t0


def mon_command_ok(cluster, admin, cmd: dict) -> None:
    """A mon command that must succeed; retried while the mons answer
    ETIMEDOUT or EAGAIN (a paxos round still busy with the new pools)."""
    end = time.monotonic() + CLUSTER_TIMEOUT
    while True:
        rv, msg, _ = admin.mon_command(cmd)
        if rv == 0:
            return
        if rv not in (-110, -11) or time.monotonic() > end:
            raise AssertionError(f"{cmd}: {rv} {msg}")
        cluster.tick(0.25)


def doors_warm(cluster, pool_id, ec_pipeline, device) -> float:
    """Every OSD's doors codec warm at every batch bucket up to
    max_batch (a flush of a one-stripe metadata object may coalesce
    with others or with a data object's 128 stripes), and the scrub CRC
    channel at the data and the metadata shard sizes."""
    max_batch = int(cluster.conf.osd_ec_pipeline_max_batch)
    buckets = [1 << j for j in range(max_batch.bit_length())]
    t0 = time.monotonic()
    for osd in cluster.osds.values():
        warm_codec(osd.get_ec_codec(osd.osdmap.pools[pool_id]), buckets,
                   buckets[0], device)
    batch = int(cluster.conf.osd_deep_scrub_stripe_batch)
    S = DOORS_OBJECT_BYTES // (K * CLUSTER_UNIT)
    for size in (CLUSTER_UNIT, S * CLUSTER_UNIT):
        for j in range(batch.bit_length()):
            wait_warm(lambda: ec_pipeline.crc_fn_if_ready(
                size, (1 << j, size), device), f"scrub CRC of {size} B")
    return time.monotonic() - t0


def degraded_codecs(cluster) -> int:
    return sum(bool(getattr(c, "degraded", False))
               for o in cluster.osds.values() for c in o._ec_codecs.values())


def door_rate(nbytes: int, wall: float, lat) -> dict:
    return {"gbs": nbytes / wall / 1e9, "wall_s": wall,
            "ops": len(lat), "lat_ms": percentiles_ms(lat)}


class Doors:
    """The three doors' clients and the payload each was given."""

    def __init__(self, cluster, rng, gw):
        from ceph_tpu_torch.client.striper import object_name
        from ceph_tpu_torch.fs import CephFS
        from ceph_tpu_torch.rbd import RBD, data_oid
        from ceph_tpu_torch.rgw import obj_soid
        self.gw = gw
        self.s3 = [rng.integers(0, 256, S3_OBJECT_BYTES, dtype=np.uint8)
                   .tobytes() for _ in range(S3_OBJECTS)]
        self.images = [rng.integers(0, 256, RBD_IMAGE_BYTES, dtype=np.uint8)
                       .tobytes() for _ in range(RBD_CLIENTS)]
        self.files = [rng.integers(0, 256, FS_FILE_BYTES, dtype=np.uint8)
                      .tobytes() for _ in range(FS_CLIENTS * FS_FILES)]
        self.rbd_ios = [cluster.client(f"client.rbd{t}").open_ioctx(
            DOORS_POOL) for t in range(RBD_CLIENTS)]
        for t, io in enumerate(self.rbd_ios):
            RBD(io).create(f"image{t}", RBD_IMAGE_BYTES, order=RBD_ORDER)
        self.fss = []
        for t in range(FS_CLIENTS):
            fs = CephFS(cluster.client(f"client.fs{t}"),
                        data_pool=DOORS_POOL, metadata_pool=DOORS_META)
            wait_ticking(cluster, lambda: self._mounted(fs), 120.0,
                         "CephFS mount")
            self.fss.append(fs)
        s3_request(gw.port, "PUT", f"/{DOORS_BUCKET}")
        self.objects = {}         # RADOS data object -> its payload
        for i, body in enumerate(self.s3):
            self._add_objects(lambda n: object_name(
                obj_soid(DOORS_BUCKET, f"obj{i}"), n), body)
        for t, body in enumerate(self.images):
            self._add_objects(lambda n: data_oid(f"image{t}", n), body)

    def _add_objects(self, name_of, body: bytes) -> None:
        """The 4 MiB RADOS objects a door stripes `body` into."""
        O = DOORS_OBJECT_BYTES
        for n in range(len(body) // O):
            self.objects[name_of(n)] = body[n * O:(n + 1) * O]

    @staticmethod
    def _mounted(fs) -> bool:
        from ceph_tpu_torch.fs import FsError
        try:
            fs.mount(timeout=10.0)
            return True
        except FsError:
            return False

    def write(self) -> dict:
        """Every door writes its payload; per-door rates."""
        from ceph_tpu_torch.fs import data_oid
        from ceph_tpu_torch.rbd import Image

        def put(_c, i):
            headers, _ = s3_request(self.gw.port, "PUT",
                                    f"/{DOORS_BUCKET}/obj{i}", self.s3[i])
            if etag_of(headers) != hashlib.md5(self.s3[i]).hexdigest():
                raise AssertionError(f"S3 PUT obj{i}: ETag != MD5")

        wall, lat, _ = run_clients([None] * S3_CLIENTS, put, S3_OBJECTS)
        out = {"s3": door_rate(S3_OBJECTS * S3_OBJECT_BYTES, wall, lat)}

        t0 = time.perf_counter()
        imgs = [Image(io, f"image{t}", cache=True)
                for t, io in enumerate(self.rbd_ios)]
        per = RBD_IMAGE_BYTES // DOORS_OBJECT_BYTES

        def rbd_write(img, i):
            t, n = i % RBD_CLIENTS, i // RBD_CLIENTS
            O = DOORS_OBJECT_BYTES
            img.write(n * O, self.images[t][n * O:(n + 1) * O])

        _w, lat, _ = run_clients(imgs, rbd_write, RBD_CLIENTS * per)
        for img in imgs:
            img.close()           # flushes the ObjectCacher
        out["rbd"] = door_rate(RBD_CLIENTS * RBD_IMAGE_BYTES,
                               time.perf_counter() - t0, lat)

        def fs_write(fs, i):
            f = fs.open(f"/file{i}", "w")
            f.write(self.files[i])
            f.close()
            return f.ino

        wall, lat, inos = run_clients(self.fss, fs_write, len(self.files))
        for i, ino in enumerate(inos):
            self._add_objects(lambda n: data_oid(ino, n), self.files[i])
        out["cephfs"] = door_rate(len(self.files) * FS_FILE_BYTES, wall, lat)
        return out

    def read(self, what: str) -> dict:
        """Every door reads its payload back; each byte must match."""
        from ceph_tpu_torch.rbd import Image

        def get(_c, i):
            headers, body = s3_request(self.gw.port, "GET",
                                       f"/{DOORS_BUCKET}/obj{i}")
            if body != self.s3[i] or \
                    etag_of(headers) != hashlib.md5(body).hexdigest():
                raise AssertionError(f"{what}: S3 GET obj{i} != PUT")

        wall, lat, _ = run_clients([None] * S3_CLIENTS, get, S3_OBJECTS)
        out = {"s3": door_rate(S3_OBJECTS * S3_OBJECT_BYTES, wall, lat)}

        t0 = time.perf_counter()
        imgs = [Image(io, f"image{t}", cache=True)
                for t, io in enumerate(self.rbd_ios)]
        per = RBD_IMAGE_BYTES // DOORS_OBJECT_BYTES

        def rbd_read(img, i):
            t, n = i % RBD_CLIENTS, i // RBD_CLIENTS
            O = DOORS_OBJECT_BYTES
            if bytes(img.read(n * O, O)) != \
                    self.images[t][n * O:(n + 1) * O]:
                raise AssertionError(f"{what}: image{t} object {n} != "
                                     f"written")

        _w, lat, _ = run_clients(imgs, rbd_read, RBD_CLIENTS * per)
        for img in imgs:
            img.close()
        out["rbd"] = door_rate(RBD_CLIENTS * RBD_IMAGE_BYTES,
                               time.perf_counter() - t0, lat)

        def fs_read(fs, i):
            f = fs.open(f"/file{i}", "r")
            got = f.read()
            f.close()
            if got != self.files[i]:
                raise AssertionError(f"{what}: {f"/file{i}"} != written")

        wall, lat, _ = run_clients(self.fss, fs_read, len(self.files))
        out["cephfs"] = door_rate(len(self.files) * FS_FILE_BYTES, wall, lat)
        walls = sum(v["wall_s"] for v in out.values())
        out["gbs"] = self.nbytes() / walls / 1e9
        return out

    def nbytes(self) -> int:
        return S3_OBJECTS * S3_OBJECT_BYTES + \
            RBD_CLIENTS * RBD_IMAGE_BYTES + len(self.files) * FS_FILE_BYTES

    def check_sizes(self) -> None:
        """stat through each door: S3 HEAD, RBD image size, CephFS."""
        from ceph_tpu_torch.rbd import Image
        for i in range(S3_OBJECTS):
            headers, _ = s3_request(self.gw.port, "HEAD",
                                    f"/{DOORS_BUCKET}/obj{i}")
            if int(headers["Content-Length"]) != S3_OBJECT_BYTES:
                raise AssertionError(f"HEAD obj{i}: {headers}")
        for t, io in enumerate(self.rbd_ios):
            with Image(io, f"image{t}") as img:
                if img.stat()["size"] != RBD_IMAGE_BYTES:
                    raise AssertionError(f"image{t}: {img.stat()}")
        for i in range(len(self.files)):
            size = self.fss[i % FS_CLIENTS].stat(f"/file{i}")["size"]
            if size != FS_FILE_BYTES:
                raise AssertionError(f"{f"/file{i}"}: size {size}")


def phase_doors(rng, cuda_ec, ec_pipeline, hbm_cache, native, crc_mod,
                device, tally):
    from ceph_tpu_torch.vstart import MiniCluster
    # phase 9's own cluster is not reused: after its windows the leader
    # mon took new client connections and commands late (80-100 s of
    # command timeouts and MDS monc hunting on the H100), so phase 10
    # boots one of the same shape, one of its 13 OSDs out
    cluster = MiniCluster(num_mons=CLUSTER_MONS, num_osds=CLUSTER_OSDS,
                          conf=cluster_conf())
    try:
        return doors_windows(cluster, rng, cuda_ec, ec_pipeline, hbm_cache,
                             native, crc_mod, device, tally)
    finally:
        cluster.stop()
        ec_pipeline.get().stop()


def doors_windows(cluster, rng, cuda_ec, ec_pipeline, hbm_cache, native,
                  crc_mod, device, tally):
    from ceph_tpu_torch.osd.pglog import HINFO_KEY
    from ceph_tpu_torch.utils import denc

    t_start = time.perf_counter()
    setup = {}                   # seconds of each setup step
    cluster.start(timeout=120.0)
    admin = cluster.client()
    out_osd = int(rng.integers(CLUSTER_OSDS))
    cluster.mark_osd_out(out_osd)
    setup["boot_s"] = time.perf_counter() - t_start
    if DOORS_TARGET_MAX_OBJECTS >= DOORS_PG_NUM:
        raise ValueError("the agent would keep an object in each tier PG")
    admin.create_ec_pool(DOORS_POOL, DOORS_PROFILE_NAME, DOORS_PROFILE,
                         pg_num=DOORS_PG_NUM)
    admin.create_pool(DOORS_HOT, pg_num=DOORS_PG_NUM)
    admin.create_pool(DOORS_META, pg_num=DOORS_META_PG_NUM)
    base_id = admin.open_ioctx(DOORS_POOL).pool_id
    hot_id = admin.open_ioctx(DOORS_HOT).pool_id
    cluster.wait_for_clean(CLUSTER_TIMEOUT)
    setup["pools_s"] = time.perf_counter() - t_start - sum(setup.values())
    settings = {"target_max_objects": str(DOORS_TARGET_MAX_OBJECTS),
                **DOORS_HIT_SET}
    for cmd in [{"prefix": "osd tier add", "pool": DOORS_POOL,
                 "tierpool": DOORS_HOT},
                {"prefix": "osd tier cache-mode", "pool": DOORS_HOT,
                 "mode": "writeback"},
                {"prefix": "osd tier set-overlay", "pool": DOORS_POOL,
                 "overlaypool": DOORS_HOT}] + [
                {"prefix": "osd pool set", "pool": DOORS_HOT, "var": k,
                 "val": v} for k, v in settings.items()]:
        mon_command_ok(cluster, admin, cmd)
    setup["tier_s"] = time.perf_counter() - t_start - sum(setup.values())
    cluster.start_mds("a", metadata_pool=DOORS_META, data_pool=DOORS_POOL)
    gw = cluster.start_rgw(access_key=DOORS_ACCESS, secret_key=DOORS_SECRET,
                           data_pool=DOORS_POOL)
    setup["daemons_s"] = time.perf_counter() - t_start - sum(setup.values())
    warm_s = doors_warm(cluster, base_id, ec_pipeline, device)
    coding = cluster.osds[0].get_ec_codec(
        cluster.osds[0].osdmap.pools[base_id]).coding_matrix
    t0 = time.perf_counter()
    doors = Doors(cluster, rng, gw)
    setup["clients_s"] = time.perf_counter() - t0
    emit("doors_setup", mons=CLUSTER_MONS, osds=CLUSTER_OSDS,
         out_osd=out_osd, base=DOORS_POOL, tier=DOORS_HOT,
         pg_num=DOORS_PG_NUM, tier_settings=settings,
         s3=[S3_CLIENTS, S3_OBJECTS, S3_OBJECT_BYTES],
         rbd=[RBD_CLIENTS, RBD_IMAGE_BYTES, RBD_ORDER],
         cephfs=[FS_CLIENTS, FS_FILES, FS_FILE_BYTES],
         setup=setup, warm_s=warm_s,
         elapsed_s=time.perf_counter() - t_start)

    def tier_data():
        return tier_names(cluster, hot_id) & set(doors.objects)

    def evicted():
        return not tier_data()

    def codecs_stay():
        if degraded_codecs(cluster):
            raise AssertionError("an OSD's codec degraded to the host")

    # -- window 1: flush -----------------------------------------------
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    before = ec_pipeline.stats()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        writes = doors.write()
        settle_s = wait_ticking(
            cluster, lambda: in_base(cluster, base_id, doors.objects)
            == set(doors.objects) and len(tier_names(
                cluster, hot_id)) <= DOORS_TARGET_MAX_OBJECTS,
            DOORS_TIMEOUT, "tier flush and evict")
    flush_s = time.perf_counter() - t0
    d_flush = cluster_window(cuda_ec, ec_pipeline, tally, before,
                             "doors flush")
    codecs_stay()
    try:
        busy, n_events = device_busy_share(prof, flush_s)
    except (AttributeError, TypeError, ValueError) as e:
        busy, n_events = None, f"not measured: {e!r}"
    sample = sorted(doors.objects)[::len(doors.objects) // DOORS_SAMPLE]
    for oid in sample[:DOORS_SAMPLE]:
        check_shards(cluster, base_id, oid, doors.objects[oid], coding,
                     native, crc_mod, denc, HINFO_KEY)
    step = dict(write=writes, flush_s=flush_s, settle_s=settle_s,
                data_objects=len(doors.objects),
                device_busy_share=busy, profiler_device_events=n_events,
                flush_window=d_flush, shards_checked_objects=DOORS_SAMPLE,
                elapsed_s=time.perf_counter() - t_start)
    emit("doors_flush", **step)
    out = {"flush": step}

    # -- window 2: promote ---------------------------------------------
    evict_s = wait_ticking(cluster, evicted, DOORS_TIMEOUT, "tier evict")
    hbm_cache.get().clear()
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    before = ec_pipeline.stats()
    reads = doors.read("promote")
    d_prom = cluster_window(cuda_ec, ec_pipeline, tally, before,
                            "doors promote", need_dispatch=False)
    codecs_stay()
    doors.check_sizes()
    step = dict(read=reads, promote_gbs=reads["gbs"], evict_s=evict_s,
                promote_window=d_prom,
                elapsed_s=time.perf_counter() - t_start)
    emit("doors_promote", **step)
    out["promote"] = step

    # -- window 3: deep scrub of the base ------------------------------
    hbm_cache.get().clear()
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    before = ec_pipeline.stats()
    t0 = time.perf_counter()
    results = scrub_all(cluster, base_id)
    s_wall = time.perf_counter() - t0
    bad = [(str(p), r["inconsistent"]) for p, r in results.items()
           if r["inconsistent"]]
    if bad:
        raise AssertionError(f"doors scrub found inconsistencies: {bad}")
    d_scrub = cluster_window(cuda_ec, ec_pipeline, tally, before,
                             "doors deep scrub")
    codecs_stay()
    shard_bytes = len(doors.objects) * DOORS_OBJECT_BYTES * (K + M) // K
    step = dict(scrub_gbs=shard_bytes / s_wall / 1e9, scrub_s=s_wall,
                scrub_checked=sum(r["checked"] for r in results.values()),
                scrub_window=d_scrub,
                elapsed_s=time.perf_counter() - t_start)
    emit("doors_scrub", **step)
    out["scrub"] = step

    # -- window 4: degraded promote ------------------------------------
    osdmap = cluster.leader().osdmon.osdmap
    holders = sorted({o for p in osdmap.all_pgs() if p.pool == base_id
                      for o in osdmap.pg_to_up_acting_osds(p)[1]
                      if o >= 0 and osdmap.is_up(o)})
    victim = holders[int(rng.integers(len(holders)))]
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    cluster.wait_for_osd_down(victim, 60.0)
    evict_s = wait_ticking(cluster, evicted, DOORS_TIMEOUT, "tier evict")
    hbm_cache.get().clear()
    torch.cuda.synchronize()
    cuda_ec.reset_launches()
    before = ec_pipeline.stats()
    reads = doors.read("degraded promote")
    d_deg = cluster_window(cuda_ec, ec_pipeline, tally, before,
                           "doors degraded promote")
    if not d_deg["dev_dispatches_dec"]:
        raise AssertionError(f"degraded promote ran no decode: {d_deg}")
    codecs_stay()
    step = dict(read=reads, degraded_promote_gbs=reads["gbs"],
                victim=victim, evict_s=evict_s, degraded_window=d_deg,
                routing=codec_routing(cluster),
                elapsed_s=time.perf_counter() - t_start)
    emit("doors_degraded_promote", **step)
    out["degraded"] = step
    return out


# -- phase 11: the mesh functions and mode, and the dry run ----------------

MESH_LAYOUTS = ((1, 2), (1, 3), (2, 2))  # (n_dp, n_ls), members on cuda:0
MESH_CRC_LAYOUTS = ((1, 2), (1, 3))
MESH_RUNS = 5
MESH_SAMPLE = 2                  # stripes held against the host oracle
MESH_PIPE_SHAPE = (128, K, 4096)  # one 128-stripe encode at the 4 KiB unit
DRYRUN_MEMBERS = 8


def mesh_launches(n: int, chain: bool, encode: bool = True) -> dict:
    """Per mesh call: each member's slice through gf_encode_crc (encode)
    or crc32c_segments (scrub fold), then crc32c_chain once on the first
    member where it joins the members' segments, else once per member."""
    return {"gf_encode": 0, "gf_encode_crc": n if encode else 0,
            "crc32c_segments": 0 if encode else n,
            "crc32c_chain": 1 if chain else n}


def host_ms(fn, runs: int) -> float:
    """Median host-clock ms of fn() (the mesh functions take host arrays
    and return once their members are done)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def np_err(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def mesh_members(n: int) -> list:
    """n plane members, one card each while there are cards, sharing
    them beyond that (all on cuda:0 on a one-card machine)."""
    return [torch.device("cuda", j % torch.cuda.device_count())
            for j in range(n)]


def phase_mesh(rng, device, cuda_ec, ec_kernels, gf, registry, native,
               crc_mod, ec_pipeline, ecutil, tally):
    """The mesh encode and scrub fold with every member of the plane on
    this card, against the single-device fused pass and crc32c_rows at
    config #2 (launches per call counted); the pipeline's mesh mode with
    the budget under one 128-stripe encode; the dry run of 8 members."""
    from ceph_tpu_torch import graft_entry
    from ceph_tpu_torch.utils import copyaudit

    coding = gf.reed_sol_van_matrix(K, M)
    S, L = B_MAIN, L_MAIN
    pinned = torch.empty((S, K, L), dtype=torch.uint8, pin_memory=True)
    batch = pinned.numpy()
    batch[:] = rng.integers(0, 256, (S, K, L), dtype=np.uint8)
    x = pinned.to(device)
    single = cuda_ec.make_encode_crc_fn(coding, L)
    ref_p, ref_c = single(x)
    torch.cuda.synchronize()
    ref_p = ref_p.cpu().numpy()
    ref_c = ref_c.view(torch.int32).cpu().numpy().view(np.uint32)
    o_allc, o_crcs = host_oracle(coding, batch[:MESH_SAMPLE], native,
                                 crc_mod)
    if not (np.array_equal(o_allc[:, K:], ref_p[:MESH_SAMPLE])
            and np.array_equal(o_crcs, ref_c[:MESH_SAMPLE])):
        raise AssertionError("single-device fused pass != host oracle")
    single_ms = time_ms(single, [x] * TIMED_RUNS)["ms"]

    p_host = torch.empty((S, M, L), dtype=torch.uint8, pin_memory=True)
    c_host = torch.empty((S, K + M), dtype=torch.int32, pin_memory=True)

    def single_host():
        # the same transfers as a mesh call: pinned up, pinned down
        p, c = single(pinned.to(device, non_blocking=True))
        p_host.copy_(p, non_blocking=True)
        c_host.copy_(c.view(torch.int32), non_blocking=True)
        torch.cuda.synchronize()

    single_host_ms = host_ms(single_host, MESH_RUNS)
    del x
    out = {"shape": [S, K, L], "tolerance": 0,
           "single_ms": single_ms, "single_host_ms": single_host_ms,
           "encode": [], "crc": []}
    for dp, ls in MESH_LAYOUTS:
        n = dp * ls
        fn = cuda_ec.make_mesh_encode_crc_fn(coding, L, mesh_members(n),
                                             dp, ls)
        fn(batch)                       # streams and parameter blocks
        _, Lp, pad = ec_kernels.mesh_geometry(L, ls)
        chain = Lp % SEG == 0
        p, c, res = counted(cuda_ec, tally, mesh_launches(n, chain),
                            f"mesh encode {dp}x{ls}",
                            lambda: fn(batch, keep_resident=True))
        err = max(np_err(p, ref_p), np_err(c, ref_c))
        dev_data, dev_parity, rpad = res
        if rpad != pad or \
                not np.array_equal(dev_data.to_host()[:S, :, pad:],
                                   batch) or \
                not np.array_equal(dev_parity.to_host()[:S, :, pad:], p):
            raise AssertionError(f"mesh {dp}x{ls}: resident tensors are "
                                 "not the inputs and parity")
        del res, dev_data, dev_parity
        if err:
            raise AssertionError(f"mesh encode {dp}x{ls} != fused pass: "
                                 f"{err}")
        row = {"layout": [dp, ls],
               "members": [str(d) for d in mesh_members(n)], "pad": pad,
               "chain": chain, "max_abs_err": err,
               "launches": mesh_launches(n, chain),
               "ms": host_ms(lambda: fn(batch), MESH_RUNS)}
        out["encode"].append(row)
        emit("mesh_encode", **row, single_ms=single_ms,
             single_host_ms=single_host_ms)

    rows_pinned = torch.empty((S * (K + M), L), dtype=torch.uint8,
                              pin_memory=True)
    rows_np = rows_pinned.numpy()
    rows_np.reshape(S, K + M, L)[:] = np.concatenate([batch, ref_p], axis=1)
    rows_dev = rows_pinned.to(device)
    ref_r = cuda_ec.crc32c_rows(rows_dev)
    torch.cuda.synchronize()
    ref_r = ref_r.view(torch.int32).cpu().numpy().view(np.uint32)
    crc_ms = time_ms(cuda_ec.crc32c_rows, [rows_dev] * TIMED_RUNS)["ms"]
    crc_host_ms = host_ms(lambda: cuda_ec.crc32c_rows(rows_pinned.to(
        device, non_blocking=True)).view(torch.int32).cpu(), MESH_RUNS)
    del rows_dev
    if not np.array_equal(ref_r, ref_c.reshape(-1)):
        raise AssertionError("crc32c_rows != the fused pass's CRCs")
    for dp, ls in MESH_CRC_LAYOUTS:
        n = dp * ls
        fn = cuda_ec.make_mesh_crc_fn(L, mesh_members(n), dp, ls)
        fn(rows_np)
        _, Lp, pad = ec_kernels.mesh_geometry(L, ls)
        chain = Lp % SEG == 0
        got = counted(cuda_ec, tally, mesh_launches(n, chain, False),
                      f"mesh crc {dp}x{ls}", lambda: fn(rows_np))
        err = np_err(got, ref_r)
        if err:
            raise AssertionError(f"mesh crc {dp}x{ls} != crc32c_rows")
        row = {"layout": [dp, ls],
               "members": [str(d) for d in mesh_members(n)],
               "rows": rows_np.shape[0],
               "pad": pad, "chain": chain, "max_abs_err": err,
               "launches": mesh_launches(n, chain, False),
               "ms": host_ms(lambda: fn(rows_np), MESH_RUNS)}
        out["crc"].append(row)
        emit("mesh_crc", **row, single_ms=crc_ms,
             single_host_ms=crc_host_ms)
    del pinned, batch, rows_pinned, rows_np, p_host, c_host

    # the pipeline: one 128-stripe encode over the mesh budget
    codec = registry.factory("tpu", {"k": str(K), "m": str(M),
                                     "technique": "reed_sol_van",
                                     "host_cutover": "1"})
    stripes = rng.integers(0, 256, MESH_PIPE_SHAPE, dtype=np.uint8)
    wait_warm(lambda: codec.backend.fused_fn_if_ready(
        codec.coding_matrix, MESH_PIPE_SHAPE, device), "128-stripe encode")
    pipe = ec_pipeline.get()
    prev = pipe.mesh_min_bytes
    ec_pipeline.configure(mesh_min_bytes=stripes.nbytes // 4)
    cards = torch.cuda.device_count()
    try:
        before = pipe.stats()
        if cards >= 2:
            cuda_ec.reset_launches()
            t0 = time.monotonic()
            while pipe.stats()["mesh_dispatches"] == \
                    before["mesh_dispatches"]:
                if time.monotonic() - t0 > WARM_TIMEOUT_S:
                    raise TimeoutError("no mesh dispatch on "
                                       f"{cards} cards")
                allc, crcs = codec.encode_stripes_with_crcs(stripes)
            for name, k in cuda_ec.launch_counts().items():
                tally[name] += k
        else:
            allc, crcs = counted(
                cuda_ec, tally, ENCODE_LAUNCHES,
                "pipeline encode over the mesh budget",
                lambda: codec.encode_stripes_with_crcs(stripes))
        ref_allc, ref_crcs = host_oracle(codec.coding_matrix, stripes,
                                         native, crc_mod)
        if not (np.array_equal(allc, ref_allc)
                and np.array_equal(crcs, ref_crcs)):
            raise AssertionError("encode over the mesh budget != host")
        st = pipe.stats()
        meshed = st["mesh_dispatches"] - before["mesh_dispatches"]
        degrades = st["mesh_degrades"] - before["mesh_degrades"]
        if cards >= 2 and (meshed < 1 or degrades):
            raise AssertionError(f"mesh on {cards} cards: {meshed} "
                                 f"dispatches, {degrades} degrades")
        if cards < 2 and (st["mesh"] is not None or meshed):
            raise AssertionError("a mesh plane formed on one card")
        # a mesh-sized object write takes a pooled arena and gives it
        # back after the shard fan-out, its staging copy noted
        sinfo = ecutil.StripeInfo(K, MESH_PIPE_SHAPE[2])
        payload = stripes.tobytes()
        free0 = len(pipe._arena_free)
        stage0 = copyaudit.snapshot()["sites"].get(
            "ec.stage", {"copies": 0})["copies"]
        if cards >= 2:
            shards, shard_crcs = ecutil.encode_object(codec, sinfo, payload)
        else:
            shards, shard_crcs = counted(
                cuda_ec, tally, ENCODE_LAUNCHES, "ecutil mesh-sized write",
                lambda: ecutil.encode_object(codec, sinfo, payload))
        for c, shard in enumerate(shards):
            if bytes(shard) != ref_allc[:, c].tobytes() or \
                    shard_crcs[c] != crc_mod.crc32c(0, bytes(shard)):
                raise AssertionError(f"mesh-sized write: shard {c} wrong")
        stage1 = copyaudit.snapshot()["sites"].get(
            "ec.stage", {"copies": 0})["copies"]
        donated = pipe.stats()["arena_donations"] - \
            before["arena_donations"]
        if len(pipe._arena_free) != min(free0 + 1,
                                        ec_pipeline.ARENA_POOL_MAX) or \
                stage1 - stage0 != (0 if donated else 1):
            raise AssertionError("pooled arena not returned or its "
                                 "staging copy not accounted")
        out["pipeline"] = {"cards": cards, "mesh": st["mesh"],
                           "mesh_dispatches": meshed,
                           "mesh_degrades": degrades,
                           "mesh_min_bytes": stripes.nbytes // 4,
                           "arena_donations": donated,
                           "arenas_pooled": len(pipe._arena_free)}
    finally:
        ec_pipeline.configure(mesh_min_bytes=prev)
        pipe.stop()
    emit("mesh_pipeline", **out["pipeline"])

    expect = {"gf_encode": DRYRUN_MEMBERS, "gf_encode_crc": 0,
              "crc32c_segments": 1, "crc32c_chain": 1}
    graft_entry.dryrun_multichip(DRYRUN_MEMBERS)      # first use
    t0 = time.perf_counter()
    r = counted(cuda_ec, tally, expect, "dryrun_multichip",
                lambda: graft_entry.dryrun_multichip(DRYRUN_MEMBERS))
    if not r.get("oracle"):
        raise AssertionError(f"dry run: {r}")
    out["dryrun"] = {**r, "launches": expect,
                     "s": time.perf_counter() - t0}
    emit("dryrun_multichip", **out["dryrun"])
    return out


# -- phase 12: the admin tools against a cluster on the card ----------------

TOOLS_MONS, TOOLS_OSDS = 1, 12
TOOLS_POOL, TOOLS_PROFILE_NAME, TOOLS_PG_NUM = "clipool", "k8m3cli", 32
TOOLS_PROFILE = ("k=8", "m=3", "plugin=tpu", "technique=reed_sol_van",
                 "host_cutover=1")
TOOLS_FILE_BYTES = 16 << 20
TOOLS_BENCH_S, TOOLS_BENCH_BLOCK, TOOLS_BENCH_THREADS = 10, 4 << 20, 8
TOOLS_SAMPLE = 8


def run_cli(main_fn, argv) -> str:
    import io as io_mod
    buf = io_mod.StringIO()
    rc = main_fn(argv, out=buf)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} {argv} -> rc {rc}: "
                             f"{buf.getvalue()[-400:]}")
    return buf.getvalue()


def bench_mb_s(text: str) -> float:
    for line in text.splitlines():
        if line.startswith("Bandwidth (MB/sec):"):
            return float(line.split(":", 1)[1])
    raise AssertionError(f"no bandwidth in rados bench output: {text!r}")


def phase_tools(rng, cuda_ec, ec_pipeline, device, tally):
    """The CLIs against a cluster of port daemons on the card: the ceph
    CLI sets a tpu k=8 m=3 profile and creates an EC pool on it, rados
    puts and gets a 16 MiB file and benches 4 MiB writes then reads, and
    trace_dump renders the OSDs' op dumps as a Chrome trace with ec.*
    spans.  One counted window, launches equal to device dispatches."""
    import os
    import shutil

    from ceph_tpu_torch.ops.pipeline import next_bucket
    from ceph_tpu_torch.tools import ceph_cli, rados_cli, trace_dump
    from ceph_tpu_torch.vstart import MiniCluster

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch", "chip_smoke_tools")
    os.makedirs(work, exist_ok=True)
    t_start = time.perf_counter()
    cluster = MiniCluster(num_mons=TOOLS_MONS, num_osds=TOOLS_OSDS,
                          conf=cluster_conf())
    try:
        cluster.start(timeout=120.0)
        conf = os.path.join(work, "ceph.conf")
        mon_host = ",".join(f"{h}:{p}" for h, p in
                            (cluster.monmap.addr_of(n)
                             for n in cluster.monmap.ranks()))
        with open(conf, "w") as f:
            f.write(f"[global]\nfsid = {cluster.monmap.fsid}\n"
                    f"mon_host = {mon_host}\nobjecter_op_timeout = 120\n")
        run_cli(ceph_cli.main, ["-c", conf, "osd", "erasure-code-profile",
                                "set", TOOLS_PROFILE_NAME, *TOOLS_PROFILE])
        run_cli(ceph_cli.main, ["-c", conf, "osd", "pool", "create",
                                TOOLS_POOL, str(TOOLS_PG_NUM),
                                str(TOOLS_PG_NUM), "erasure",
                                TOOLS_PROFILE_NAME])
        admin = cluster.client()
        io = admin.open_ioctx(TOOLS_POOL)
        if not cluster.leader().osdmon.osdmap.pools[io.pool_id].is_erasure:
            raise AssertionError("ceph_cli created a replicated pool")
        cluster.wait_for_clean(CLUSTER_TIMEOUT)
        boot_s = time.perf_counter() - t_start
        # the put's 512-stripe encode, the bench's 128-stripe ones and
        # pairs of them coalesced
        S = TOOLS_BENCH_BLOCK // (K * CLUSTER_UNIT)
        buckets = sorted({next_bucket(TOOLS_FILE_BYTES // (K * CLUSTER_UNIT)),
                          next_bucket(S), next_bucket(2 * S)})
        t0 = time.monotonic()
        for osd in cluster.osds.values():
            warm_codec(osd.get_ec_codec(osd.osdmap.pools[io.pool_id]),
                       buckets, buckets[0], device)
        warm_s = time.monotonic() - t0
        src, dst = os.path.join(work, "in.bin"), os.path.join(work, "out.bin")
        rng.integers(0, 256, TOOLS_FILE_BYTES, dtype=np.uint8).tofile(src)

        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        base = ["-c", conf, "-p", TOOLS_POOL]
        t0 = time.perf_counter()
        run_cli(rados_cli.main, base + ["put", "file", src])
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_cli(rados_cli.main, base + ["get", "file", dst])
        get_s = time.perf_counter() - t0
        with open(src, "rb") as a, open(dst, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("rados get != the file put")
        bench = ["bench", str(TOOLS_BENCH_S), "write", "-b",
                 str(TOOLS_BENCH_BLOCK), "-t", str(TOOLS_BENCH_THREADS)]
        w_out = run_cli(rados_cli.main, base + bench)
        bench[2] = "seq"
        r_out = run_cli(rados_cli.main, base + bench)
        d = cluster_window(cuda_ec, ec_pipeline, tally, before,
                           "tools: rados put, get and bench")
        made = sorted(n for n in io.list_objects()
                      if n.startswith("bench_"))
        pattern = (bytes(range(256)) * (TOOLS_BENCH_BLOCK // 256 + 1))[
            :TOOLS_BENCH_BLOCK]
        for name in made[:TOOLS_SAMPLE]:
            if bytes(io.read(name)) != pattern:
                raise AssertionError(f"bench object {name} reads wrong")
        paths = []
        for osd in cluster.osds.values():
            path = os.path.join(work, f"{osd.entity}.json")
            with open(path, "w") as f:
                json.dump(osd.op_tracker.dump_historic_ops(), f)
            paths.append(path)
        events = json.loads(run_cli(trace_dump.main,
                                    ["--dump", *paths]))["traceEvents"]
        ec_spans = sorted({e["name"] for e in events
                           if e.get("ph") == "X" and
                           e.get("name", "").startswith("ec.")})
        if not ec_spans:
            raise AssertionError("trace_dump shows no ec.* spans")
        degraded = sum(1 for osd in cluster.osds.values()
                       for codec in osd._ec_codecs.values()
                       if codec.degraded)
        if degraded:
            raise AssertionError(f"{degraded} codecs degraded")
        out = {"mons": TOOLS_MONS, "osds": TOOLS_OSDS,
               "pg_num": TOOLS_PG_NUM, "profile": list(TOOLS_PROFILE),
               "boot_s": boot_s, "warm_s": warm_s,
               "file_bytes": TOOLS_FILE_BYTES,
               "put_gbs": TOOLS_FILE_BYTES / put_s / 1e9,
               "get_gbs": TOOLS_FILE_BYTES / get_s / 1e9,
               "bench_write_mb_s": bench_mb_s(w_out),
               "bench_seq_mb_s": bench_mb_s(r_out),
               "bench_objects": len(made), "ec_spans": ec_spans,
               "trace_events": len(events), "window": d,
               "elapsed_s": time.perf_counter() - t_start}
        emit("tools", **out)
        return out
    finally:
        cluster.stop()
        ec_pipeline.get().stop()
        shutil.rmtree(work, ignore_errors=True)


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


# Phase 13: the reference's device-path test files, through their
# tests/test_torch_*.py wrappers, with the port's device on the card.
# pytest runs in this process without tests/conftest.py (it imports
# JAX); the wrappers' _port_reference plugin asks for the card and
# registers the `slow` marker.
REF_SUITE = ("test_torch_ecutil", "test_torch_ref_erasure",
             "test_torch_faults", "test_torch_ref_hbm_cache",
             "test_torch_ref_pipeline", "test_torch_scrub_repair",
             "test_torch_recovery_backfill", "test_torch_ec_append",
             "test_torch_ref_cluster")
REF_SUITE_KERNELS = ("gf_encode_crc", "gf_encode", "crc32c_chain")
REF_SUITE_TIMEOUT_S = 420.0


class _SuiteTally:
    """pytest plugin: per-file case outcomes (a case failing in any
    phase counts failed), and every dispatch pipeline the file's cases
    build, for their host-served batches."""

    def __init__(self, pipeline_cls):
        self.results: dict[str, str] = {}
        self.collected = 0
        self.pipes: list = []
        self._cls, self._init = pipeline_cls, pipeline_cls.__init__
        pipes, init = self.pipes, self._init

        def tracked(pipe, *a, **kw):
            init(pipe, *a, **kw)
            pipes.append(pipe)

        pipeline_cls.__init__ = tracked

    def close(self) -> None:
        self._cls.__init__ = self._init

    def outcomes(self) -> dict:
        return {k: sum(v == k for v in self.results.values())
                for k in ("passed", "failed", "skipped")}

    def failures(self) -> list:
        return [n for n, v in self.results.items() if v == "failed"]

    def pytest_collection_finish(self, session):
        self.collected = len(session.items)

    def pytest_runtest_logreport(self, report):
        prev = self.results.get(report.nodeid)
        if report.failed:
            self.results[report.nodeid] = "failed"
        elif report.skipped and prev != "failed":
            self.results[report.nodeid] = "skipped"
        elif report.when == "call" and prev is None:
            self.results[report.nodeid] = "passed"


def phase_reference_suite(cuda_ec, ec_pipeline, hbm_cache, device):
    """Run each wrapper of REF_SUITE under pytest with the card asked
    for: every collected case must pass; per file, the launches of each
    kernel entry point (counts zeroed before the file) and the batches
    a dispatch pipeline served on the host.  Together the files must
    launch each of REF_SUITE_KERNELS."""
    import faulthandler
    import os

    import pytest
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    sys.path.insert(0, tests)
    from _port_reference import OnTheCard

    total = dict.fromkeys(cuda_ec.launches, 0)
    rows, t_phase = [], time.perf_counter()
    faulthandler.dump_traceback_later(REF_SUITE_TIMEOUT_S, exit=True)
    try:
        for name in REF_SUITE:
            ec_pipeline.get().stop()
            hbm_cache.get().clear()
            args = [os.path.join(tests, f"{name}.py"), "-q", "-m",
                    "not slow", "--noconftest", "-p", "no:cacheprovider",
                    "-p", "no:randomly"]
            tally = _SuiteTally(ec_pipeline.EcDevicePipeline)
            torch.cuda.synchronize()
            cuda_ec.reset_launches()
            host0 = ec_pipeline.stats()["host_dispatches"]
            t0 = time.perf_counter()
            try:
                rc = pytest.main(args, plugins=[OnTheCard(str(device)),
                                                tally])
            finally:
                tally.close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cuda_ec.launch_counts()
            host = ec_pipeline.stats()["host_dispatches"] - host0 + sum(
                p.stats()["host_dispatches"] for p in tally.pipes
                if p is not ec_pipeline.get())
            for k, v in launches.items():
                total[k] += v
            wrapper = sys.modules.get(name)
            row = {"file": f"tests/{name}.py", "rc": int(rc),
                   "collected": tally.collected, **tally.outcomes(),
                   "excluded_in_wrapper": list(
                       getattr(wrapper, "_port_excluded", ())),
                   "launches": launches,
                   "host_batches": host, "wall_s": wall,
                   "all_host": not any(launches.values())}
            emit("reference_suite_file", **row)
            rows.append(row)
            if rc != 0 or row["failed"] or not tally.collected or \
                    row["passed"] != tally.collected:
                raise AssertionError(
                    f"reference suite on the card: {name} rc {rc}, "
                    f"{tally.outcomes()} of {tally.collected}, failed "
                    f"{tally.failures()[:10]}")
    finally:
        faulthandler.cancel_dump_traceback_later()
        ec_pipeline.get().stop()
    idle = [k for k in REF_SUITE_KERNELS if total[k] < 1]
    emit("reference_suite", files=len(rows),
         passed=sum(r["passed"] for r in rows),
         collected=sum(r["collected"] for r in rows), launches=total,
         host_batches=sum(r["host_batches"] for r in rows),
         wall_s=time.perf_counter() - t_phase)
    if idle:
        raise AssertionError(f"reference suite launched no {idle}")
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "the card (see the module docstring).")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run phase 11 alone, its "
                    "plane members one card each while there are cards "
                    "(the multi-card check of the mesh functions and "
                    "mode); the whole run needs one card")
    ap.add_argument("--suite-only", action="store_true",
                    help="build the kernels and run phase 13 alone (the "
                    "reference's device-path test files on the card)")
    args = ap.parse_args(argv)
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

    if args.mesh_only:
        ec_pipeline.configure(depth=PIPE_DEPTH, max_batch=PIPE_MAX_BATCH,
                              hbm_cache_bytes=HBM_CACHE_BYTES)
        counts = dict.fromkeys(cuda_ec.launches, 0)
        phase_mesh(np.random.default_rng(SEED), device, cuda_ec,
                   ec_kernels, gf, registry, native, crc_mod, ec_pipeline,
                   ecutil, counts)
        emit("mesh_only_launches", launches=counts,
             cards=torch.cuda.device_count())
        print(ident, flush=True)
        return 0
    if args.suite_only:
        phase_reference_suite(cuda_ec, ec_pipeline, hbm_cache, device)
        print(ident, flush=True)
        return 0

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
    payloads = written = None
    phase_cluster(rng, cuda_ec, ec_pipeline, hbm_cache, native, crc_mod,
                  device, counts)
    phase_doors(rng, cuda_ec, ec_pipeline, hbm_cache, native, crc_mod,
                device, counts)
    phase_mesh(rng, device, cuda_ec, ec_kernels, gf, registry, native,
               crc_mod, ec_pipeline, ecutil, counts)
    phase_tools(rng, cuda_ec, ec_pipeline, device, counts)
    by_source = {src: sum(n for name, n in counts.items()
                          if name.startswith(src)) for src in cuda_ec.SOURCES}
    emit("main_path_launches", launches=counts, by_source=by_source)
    idle = [n for n in KERNEL_META if counts[n] < 1]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    phase_reference_suite(cuda_ec, ec_pipeline, hbm_cache, device)

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
