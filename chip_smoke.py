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

  writes: 32 x 4 MiB write_full from the 8 clients (under
     torch.profiler: the card's busy share), read back, and 100,001 B
     appended to 8 objects; a sample of 16 objects' shard files and
     HashInfo read from the OSD stores against the host oracle;
  scrub: deep scrub of every PG (once folded from the cache, then with
     the cache cleared through the CRC kernels), zero inconsistencies,
     then one corrupted shard flagged and nothing else;
  recovery: cache cleared, one OSD killed, every object read degraded,
     the OSD marked out, until the cluster is clean; every lost shard
     must then sit rebuilt by recovery on its new holder, equal to the
     lost bytes (no scrub repair: a shard left unrebuilt fails the phase).

Phase 10 drives the front doors on phase 9's own cluster (3 mons, 13
MemStore OSDs, the one phase 9 killed marked out), each setup step timed
and failed past 60 s: an EC
base pool "doors" (phase 9's code with host_cutover 1, the 4 KiB unit,
pg_num 32) behind a replicated writeback cache tier "doors-hot" (a hit
set, target_max_objects 8), a replicated CephFS metadata pool, one MDS
and one RGW gateway.  At upstream's 4 MiB object size, 8 S3 clients PUT
8 x 8 MiB over HTTP with SigV4, 2 RBD clients write their own 16 MiB
image in 4 MiB writes with the ObjectCacher on, and 2 CephFS clients
write two 8 MiB files each: 128 MiB as 32 RADOS objects.  Four counted
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

Phase 14 runs phase 9's cluster as Ceph deploys it: 3 mons, 13 MemStore
OSDs and a mgr, each a process started with `python -m
ceph_tpu_torch.daemons` from one conf file (cluster_conf()'s keys, the
admin sockets under _scratch/daemons/asok, each OSD's HBM cache 4 GiB /
13 so that the card holds phase 9's 4 GiB in all), and 8 client
processes, each with its own Rados from the conf.  The pool and seed
are phase 9's, the workload twice its objects (with 32 in 64 PGs some
OSD is primary of none): the profile set and the pool created through
the port's ceph CLI, 64 x 4 MiB written, read back bit-exact in the
client processes, 100,001 B appended to 8.  Before the windows every OSD
process is warmed by the `ec warm` admin command at each batch and
scrub shape the windows can give it (ec_warm), and each counted window
is preceded by uncounted passes of the same ops on the same objects
(other bytes) until they serve no batch on a host.  Windows: writes,
reads and appends (nvidia-smi's compute apps sampled meanwhile: every
OSD pid must hold the card); then every OSD's HBM cache dropped (`cache
drop`: the windows after it go to the shards, as phase 9's do after its
cache clears); deep scrub of every PG
(`pg deep-scrub`, each result read from the primary's log), no
inconsistency; SIGKILL of an OSD drawn from the seed among the primaries
of the objects' PGs, marked down by the mon from its peers' failure
reports alone, every object read degraded, `ceph osd out` through the
CLI and recovery until every lost shard is rebuilt and the PGs are
clean; SIGKILL of a second OSD, one now holding rebuilt shards, and
every object read degraded again.  Each window's device dispatches and
kernel launches are read from every OSD's `perf dump` over its admin
socket and summed: device dispatches above 0 for the kinds the window
runs, no batch on a host, and each kernel entry point launched once per
device dispatch of its kind; the degraded reads decode at most
MAX_DECODE_SHARE stripes per stripe read (as phase 9's must: a resent
read runs once).  At the end every daemon must exit 0 on
SIGTERM within 30 s.  It prints client write, read and degraded-read
GB/s and p50/p99, the share of the degraded reads' stripes that were
decoded, recovery seconds, scrub GB/s, boot and warm-up seconds, stripes
per write dispatch per OSD, each process's card memory, the kernel
launches, and a fresh client's first `health` seconds after each window.

Phase 15 runs phase 10's doors on phase 14's cluster, after its last
window: phase 14's second killed OSD started again (its MemStore empty;
with 11 OSDs in, CRUSH leaves a hole in some PG of a k+m = 11 pool) and
the pool clean on 12 OSDs; phase 10's pools and tier made through the
port's ceph CLI; one MDS and one RGW process from the same conf file,
each boot timed with the card's memory.used around it (neither may
initialise CUDA: their `status` over the admin socket says);
every OSD process warmed by ec_warm; then phase 10's widths from
client processes: 8 S3 processes PUT 8 x 8 MiB with SigV4 to the RGW
process, 2 RBD processes each write a 16 MiB image (order 22,
ObjectCacher on), 2 CephFS processes each write two 8 MiB files
through the MDS process.  Windows, each counted from every OSD's `perf
dump`: writes; flush, until every shard file of every door object and
its HashInfo, read over the holders' admin sockets (`dump_shard`),
equal the host oracle; promote (the tier listed empty of door objects,
every OSD's HBM cache dropped, every object read through its door, then
stat sizes); deep scrub of the base (`pg deep-scrub` per PG); degraded
promote (an OSD drawn from the seed among the holders of door objects'
shards SIGKILLed and marked down from its peers' reports, the tier
empty again, every object read again).  Each window runs no batch on a
host and launches each kernel once per device dispatch of its kind,
the flush encodes and the scrub CRCs on the card, the degraded promote
decodes; no codec degrades (mon `health`); phase 15 launches all four
kernel entry points.  Every read is byte-exact (S3 GETs with the ETag
the body's MD5).  It prints per-door GB/s and op p50/p99, flush s,
promote, scrub and degraded-promote GB/s beside phase 10's from the
same run, the MDS and RGW boot seconds and card memory, and the
launches.  The MDS and the RGW stop first at teardown and must exit 0
on SIGTERM with the other daemons.  `--daemons-only` runs phases 14,
15 and 17 alone.

Phase 16 runs BASELINE.md configs #1-#5, each under its own plugin,
through the port's codecs in this process, at bench.py's shapes: #1
jerasure reed_sol_van k=2 m=1 at (128, 2, 4096), #2 isa reed_sol_van
k=8 m=3 at (32, 8, 1 MiB), and one stripe of 1 MiB chunks of #3
jerasure cauchy_good k=6 m=3 packetsize=32, #4 shec k=8 m=4 c=3 and #5
lrc k=4 m=2 l=3.  Two codecs per config from the registry: one with its
TorchBackend pinned to the device (host_cutover 1 on the instance), the
host oracle with the profile's `backend=host`.  Every device shape the
ops meet is warmed first (the codec's device_shapes, what `ec warm`
warms).  Then, counted: the encode byte-exact against the oracle's;
every erasure of one chunk and of two (where m allows) and 16 seeded
ones of m chunks that minimum_to_decode accepts, decoded from the
shard layout (chunk i of each stripe, concatenated, over the first
stripes up to 1 MiB a chunk: all of #1's, #2's first) and byte-exact
against the encoded chunks; gf_encode launched once per device call the routing
recorded for the byte-matrix configs (#1, #2, #4, #5; #3's packet
transform is plain PyTorch on the card, no kernel), and no call served
by the host.  It prints CUDA-event ms (median of 10) and GB/s of the
encode and of one decode beside the host oracle's ms on this machine's
CPU.  `--plugins-only` runs this phase alone.

Phase 17 runs the same five configs as EC pools of phase 14's cluster,
after phase 15 and before the teardown: phase 15's killed OSD and phase
14's out-marked one started again (their MemStores empty) and marked in,
every pool clean on 13 OSDs; the five profiles and their pools (pg_num
16, the default 4 KiB unit) created back to back with the port's ceph
CLI, a burst of maps, and the osdmap polled from the first command until
every pool is clean: no OSD may be marked down in that window; the
card's memory.used unchanged across it (the mons instantiate each plugin
to validate its profile); then pool by pool: `ec warm` on every OSD, 16
seeded 4 MiB write_full from 8 client processes (one set, which
switches pools), read back byte-exact, every shard file and HashInfo of
8 sampled objects (`dump_shard`) against the host oracle of that
profile, deep scrub of every PG with no inconsistency.  Then one OSD
drawn from the seed is SIGKILLed and left in: every object of every
pool read degraded, byte-exact; the OSD started again and recovery
until the PGs are clean and the counters still; the shard sample
checked again.  gf_encode must launch in the write windows of pools #1
and #2, crc32c_segments and crc32c_chain in every pool's scrub window.
The measured routing, shec's and lrc's stripe-by-stripe OSD encode
(under 64 KiB, so on the host) and the host's stripe-by-stripe degraded
decodes are the reference's and are reported, not changed: per pool
client GB/s and op p50/p99, each window's launches, the routing's
device and host samples and crossover bytes, and the recovery seconds.

After each window of phase 9 a fresh client's first `health` is timed
(client creation included); one that waits past 5 s dumps every
thread's stack to _scratch/mon_stacks_<window>.txt.

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
import os
import signal
import subprocess
import sys
import threading
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


def launches_must_equal(cuda_ec, tally, expect: dict, what: str,
                        got: dict | None = None) -> dict:
    """Counts read just after a counted window (zeroed just before it),
    or `got`, read by the caller."""
    if got is None:
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
# 32 objects, not the 256 (1 GiB) of a full run: the cluster path runs
# at ~30 MB/s in one interpreter, and the whole script keeps to its
# time budget (object size, profile and stripe unit are not cut)
CLUSTER_OBJECTS, CLUSTER_OBJECT_BYTES = 32, 4 << 20
# phase 14 writes 64: with 32 objects in 64 PGs some OSD is the primary
# of none, and every OSD process must dispatch on the card there
DAEMONS_OBJECTS = 64
CLUSTER_CLIENTS = 8
CLUSTER_APPENDS, CLUSTER_APPEND_BYTES = 8, 100_001   # not a stripe multiple
CLUSTER_SAMPLE = 16
CLUSTER_UNIT = 4096                       # ecutil.DEFAULT_STRIPE_UNIT
CLUSTER_POOL = "ecpool"
# host_cutover = MIN_DEVICE_BYTES: measured routing cannot move a batch
# of 64 KiB or more to the host
CLUSTER_PROFILE = {"plugin": "tpu", "technique": "reed_sol_van",
                   "k": str(K), "m": str(M), "host_cutover": str(1 << 16)}
CLUSTER_TIMEOUT = 600.0
CLUSTER_RECOVERY_TIMEOUT = 300.0


CLUSTER_CONF = {
    # MiniCluster's own defaults
    "mon_tick_interval": 0.5, "osd_heartbeat_interval": 0.5,
    "osd_heartbeat_grace": 8.0, "mon_osd_min_down_reporters": 2,
    # the killed OSD is marked out by hand, after the degraded reads
    "mon_osd_down_out_interval": 1e6,
    "osd_ec_hbm_cache_bytes": HBM_CACHE_BYTES,
    "osd_op_history_size": 4 * DAEMONS_OBJECTS,
    "objecter_op_timeout": 120.0}


def cluster_conf():
    from ceph_tpu_torch.utils.config import Config
    return Config(CLUSTER_CONF)


def percentiles_ms(lat) -> dict:
    a = 1e3 * np.asarray(lat, dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def cluster_window_open(cuda_ec, ec_pipeline) -> dict:
    """Open a counted window of the cluster phase where nothing is in
    flight (see cluster_window): zero the launch counts, and return the
    pipeline's stats to close the window against.  A dispatch launched
    before the zeroing but collected after it would read as a dispatch
    without its launch."""
    torch.cuda.synchronize()
    pipe = ec_pipeline.get()
    end = time.monotonic() + 60.0
    while True:
        pipe.flush(max(0.0, end - time.monotonic()))
        cuda_ec.reset_launches()
        before = ec_pipeline.stats()
        pipe.flush(max(0.0, end - time.monotonic()))
        if not any(cuda_ec.launch_counts().values()) and \
                ec_pipeline.stats()["dispatches"] == before["dispatches"] \
                or time.monotonic() > end:
            return before


def cluster_window(cuda_ec, ec_pipeline, tally, before: dict,
                   what: str, need_dispatch: bool = True) -> dict:
    """Close a counted window of the cluster phase: each kernel entry
    point launched exactly once per device dispatch of its kind, at
    least one device dispatch (unless `need_dispatch` is False), and no
    stripe batch served by the host.  The window closes where nothing is
    in flight: a dispatch counts when its results are collected, its
    launch when it is issued, so work still running in the background
    (a remapped member's backfill, a role audit, the tier agent) would
    read as a launch without its dispatch."""
    torch.cuda.synchronize()
    pipe = ec_pipeline.get()
    end = time.monotonic() + 60.0
    while True:
        pipe.flush(max(0.0, end - time.monotonic()))
        got, after = cuda_ec.launch_counts(), ec_pipeline.stats()
        pipe.flush(max(0.0, end - time.monotonic()))
        if (cuda_ec.launch_counts(), ec_pipeline.stats()["dispatches"]) \
                == (got, after["dispatches"]) or time.monotonic() > end:
            break
    d = {k: after[k] - before[k] for k in (
        "dispatches", "dev_dispatches", "host_dispatches",
        "dev_dispatches_enc", "dev_dispatches_dec", "dev_dispatches_crc",
        "stripes", "bytes_h2d", "bytes_d2h", "replans")}
    launches_must_equal(cuda_ec, tally, {
        "gf_encode": d["dev_dispatches_dec"],
        "gf_encode_crc": d["dev_dispatches_enc"],
        "crc32c_segments": d["dev_dispatches_crc"],
        "crc32c_chain": d["dev_dispatches_enc"] + d["dev_dispatches_crc"]},
        what, got)
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


MON_PROBE_DUMP_S = 5.0       # a first `health` slower than this dumps
MON_PROBE_DUMP_EVERY_S = 15.0  # every thread's stack, and again after this


def stack_dump(path: str, label: str) -> list:
    """Append every thread's stack to `path`; returns, for each thread
    with a frame in the mon package, its name and innermost frames."""
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    mon = []
    with open(path, "a") as f:
        f.write(f"=== {label}\n")
        for ident, frame in sys._current_frames().items():
            stack = traceback.extract_stack(frame)
            f.write(f"--- {names.get(ident, ident)}\n")
            f.write("".join(traceback.format_list(stack)))
            if any("/mon/" in fr.filename for fr in stack):
                mon.append([names.get(ident, str(ident))] + [
                    f"{fr.filename.rsplit('/', 2)[-1]}:{fr.lineno} {fr.name}"
                    for fr in stack[-3:]])
    return mon


def first_health(make_client, name: str, stage: str) -> dict:
    """Seconds from creating client `name` (make_client(name)) to its
    first answered `health` (client creation included, as
    tests/mon_after_windows.py's first_command), and the mon that
    answered.  While it waits past MON_PROBE_DUMP_S, a watchdog dumps
    every thread of this process (with phase 9's in-process cluster,
    the mons' too) to _scratch/mon_stacks_<stage>.txt, and again every
    MON_PROBE_DUMP_EVERY_S: the leader's threads blocked (the same
    frames each time) or runnable."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "_scratch", f"mon_stacks_{stage}.txt")
    done, dumps = threading.Event(), []

    def watchdog():
        wait = MON_PROBE_DUMP_S
        while not done.wait(wait):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            dumps.append(stack_dump(path, f"{stage} after "
                                    f"{time.perf_counter() - t0:.1f} s"))
            print(f"chip_smoke: mon probe {stage} waiting "
                  f"{time.perf_counter() - t0:.1f} s; mon threads: "
                  f"{json.dumps(dumps[-1])}", file=sys.stderr, flush=True)
            wait = MON_PROBE_DUMP_EVERY_S

    t0 = time.perf_counter()
    w = threading.Thread(target=watchdog, daemon=True)
    w.start()
    try:
        rados = make_client(name)
        try:
            rv, _out, _ = rados.mon_command({"prefix": "health"})
        finally:
            rados.shutdown()
    finally:
        done.set()
        w.join()
    if rv != 0:
        raise AssertionError(f"health after {stage}: {rv} {_out}")
    return {"s": time.perf_counter() - t0, "mon": str(rados.monc._cur_mon),
            "stack_dumps": len(dumps)}


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
        before = cluster_window_open(cuda_ec, ec_pipeline)
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
        probes = {"writes_reads_appends": first_health(
            cluster.client, "client.probe_writes", "writes")}
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
            first_health=probes["writes_reads_appends"],
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
        before = cluster_window_open(cuda_ec, ec_pipeline)
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
        probes["scrub"] = first_health(cluster.client,
                                       "client.probe_scrub", "scrub")
        shard_bytes = sum(len(finals[i]) for i in finals) * (K + M) // K
        step = dict(scrub_gbs=shard_bytes / s_wall / 1e9,
                    first_health=probes["scrub"],
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
        before = cluster_window_open(cuda_ec, ec_pipeline)
        cluster.kill_osd(victim)
        cluster.mark_osd_down(victim)
        cluster.wait_for_osd_down(victim, 60.0)
        g_wall, g_lat, back = run_clients(
            ios, lambda io, i: io.read(f"obj{i}"), CLUSTER_OBJECTS)
        for i, b in enumerate(back):
            if bytes(b) != finals[i]:
                raise AssertionError(f"degraded read of obj{i} != payload")
        back = None
        mid = ec_pipeline.stats()
        d_deg = {k: mid[k] - before[k] for k in (
            "dispatches", "dev_dispatches_dec", "stripes")}
        share = decode_share_ok(d_deg, object_stripes(
            objects(range(CLUSTER_OBJECTS), range(CLUSTER_APPENDS))),
            "cluster degraded reads")
        probes["degraded_reads"] = first_health(
            cluster.client, "client.probe_degraded", "degraded_reads")
        emit("cluster_degraded_reads",
             first_health=probes["degraded_reads"],
             degraded_read_gbs=sum(map(len, finals.values())) / g_wall / 1e9,
             degraded_read_lat_ms=percentiles_ms(g_lat),
             degraded_decode_share=share,
             degraded_window=d_deg,
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
        probes["recovery"] = first_health(
            cluster.client, "client.probe_recovery", "recovery")
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
                   recovery_window=d_rec, first_health=probes,
                   codecs_degraded=degraded_codecs(cluster),
                   routing=codec_routing(cluster),
                   elapsed_s=time.perf_counter() - t_start)
        emit("cluster_recovery", **step)
        if step["codecs_degraded"]:
            raise AssertionError("an OSD's codec degraded to the host")
        out.update(step)
        return out, cluster
    except BaseException:
        cluster.stop()
        ec_pipeline.get().stop()
        raise


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
S3_CLIENTS, S3_OBJECTS, S3_OBJECT_BYTES = 8, 8, 8 << 20
RBD_CLIENTS, RBD_IMAGE_BYTES, RBD_ORDER = 2, 16 << 20, 22
FS_CLIENTS, FS_FILES, FS_FILE_BYTES = 2, 2, 8 << 20
DOORS_SAMPLE = 16
DOORS_TIMEOUT = 300.0
DOORS_SETUP_STEP_S = 60.0                 # each setup step, or the run fails


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


def mon_command_ok(cluster, admin, cmd: dict,
                   timeout: float = CLUSTER_TIMEOUT) -> int:
    """A mon command that must succeed; retried while the mons answer
    ETIMEDOUT or EAGAIN (a paxos round still busy with the new pools).
    Returns the retries."""
    end = time.monotonic() + timeout
    retries = 0
    while True:
        rv, msg, _ = admin.mon_command(cmd)
        if rv == 0:
            return retries
        if rv not in (-110, -11) or time.monotonic() > end:
            raise AssertionError(f"{cmd}: {rv} {msg}")
        retries += 1
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


def phase_doors(cluster, out_osd, rng, cuda_ec, ec_pipeline, hbm_cache,
                native, crc_mod, device, tally):
    """Phase 10 on phase 9's cluster, `out_osd` its OSD killed and
    marked out; stops the cluster."""
    try:
        return doors_windows(cluster, out_osd, rng, cuda_ec, ec_pipeline,
                             hbm_cache, native, crc_mod, device, tally)
    finally:
        cluster.stop()
        ec_pipeline.get().stop()


def doors_windows(cluster, out_osd, rng, cuda_ec, ec_pipeline, hbm_cache,
                  native, crc_mod, device, tally):
    from ceph_tpu_torch.osd.pglog import HINFO_KEY
    from ceph_tpu_torch.utils import denc

    t_start = time.perf_counter()
    setup = {}                   # seconds of each setup step
    maps = {}                    # the leader's osdmap epochs of each
    hbm_cache.get().clear()
    admin = cluster.client("client.doors_admin")
    setup["first_health"] = first_health(
        cluster.client, "client.probe_doors", "doors_setup")
    if DOORS_TARGET_MAX_OBJECTS >= DOORS_PG_NUM:
        raise ValueError("the agent would keep an object in each tier PG")

    def step(name: str, fn) -> None:
        """One setup step on the aged cluster, failed past
        DOORS_SETUP_STEP_S (the waits inside are bounded by it too)."""
        epoch = cluster.leader().osdmon.osdmap.epoch
        t0 = time.perf_counter()
        fn()
        setup[f"{name}_s"] = took = time.perf_counter() - t0
        maps[name] = cluster.leader().osdmon.osdmap.epoch - epoch
        if took > DOORS_SETUP_STEP_S:
            raise AssertionError(f"setup step {name} took {took:.1f} s on "
                                 f"phase 9's cluster: {setup}")

    def pools():
        admin.create_ec_pool(DOORS_POOL, DOORS_PROFILE_NAME, DOORS_PROFILE,
                             pg_num=DOORS_PG_NUM)
        admin.create_pool(DOORS_HOT, pg_num=DOORS_PG_NUM)
        admin.create_pool(DOORS_META, pg_num=DOORS_META_PG_NUM)
        cluster.wait_for_clean(DOORS_SETUP_STEP_S)

    settings = {"target_max_objects": str(DOORS_TARGET_MAX_OBJECTS),
                **DOORS_HIT_SET}

    def command(cmd: dict):
        def run():
            setup["mon_retries"] = setup.get("mon_retries", 0) + \
                mon_command_ok(cluster, admin, cmd, DOORS_SETUP_STEP_S)
        return run

    gws = []
    step("pools", pools)
    base_id = admin.open_ioctx(DOORS_POOL).pool_id
    hot_id = admin.open_ioctx(DOORS_HOT).pool_id
    step("tier_add", command({"prefix": "osd tier add", "pool": DOORS_POOL,
                              "tierpool": DOORS_HOT}))
    step("cache_mode", command({"prefix": "osd tier cache-mode",
                                "pool": DOORS_HOT, "mode": "writeback"}))
    step("set_overlay", command({"prefix": "osd tier set-overlay",
                                 "pool": DOORS_POOL,
                                 "overlaypool": DOORS_HOT}))
    for k, v in settings.items():
        step(f"set_{k}", command({"prefix": "osd pool set",
                                  "pool": DOORS_HOT, "var": k, "val": v}))
    step("mds", lambda: cluster.start_mds(
        "a", metadata_pool=DOORS_META, data_pool=DOORS_POOL))
    step("rgw", lambda: gws.append(cluster.start_rgw(
        access_key=DOORS_ACCESS, secret_key=DOORS_SECRET,
        data_pool=DOORS_POOL)))
    emit("doors_setup_steps", steps_s={k: v for k, v in setup.items()
                                       if k.endswith("_s")},
         maps=maps, limit_s=DOORS_SETUP_STEP_S, gpu=gpu_identity())
    gw = gws[0]
    warm_s = doors_warm(cluster, base_id, ec_pipeline, device)
    osd = next(iter(cluster.osds.values()))
    coding = osd.get_ec_codec(osd.osdmap.pools[base_id]).coding_matrix
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
    before = cluster_window_open(cuda_ec, ec_pipeline)
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
    before = cluster_window_open(cuda_ec, ec_pipeline)
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
    before = cluster_window_open(cuda_ec, ec_pipeline)
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
    before = cluster_window_open(cuda_ec, ec_pipeline)
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

        before = cluster_window_open(cuda_ec, ec_pipeline)
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


# -- phase 14: the daemons as processes ---------------------------------------
#
# Phase 9's cluster as Ceph deploys it (upstream src/vstart.sh, and every
# production cluster): each mon, OSD and the mgr in a process of its own,
# started through the port's entry point `python -m ceph_tpu_torch.daemons`
# from one conf file, and 8 client processes, each with its own Rados from
# that conf (tools.connect_from_conf).  The daemons run on the real clock:
# a killed OSD is marked down by the mon from its peers' failure reports.
# The launcher lives here and in the tests, not in the package.

DAEMON_MAIN = ("-m", "ceph_tpu_torch.daemons")
DAEMONS_FSID = "5e2b3c1a-0000-4000-8000-00000000000e"
DAEMONS_BOOT_TIMEOUT = 300.0
DAEMONS_STOP_TIMEOUT = 30.0         # SIGTERM to exit, each daemon
DAEMONS_CLIENT_TIMEOUT = 600.0      # one client process's ops of a window
DAEMONS_WARM_ROUNDS = 8             # uncounted passes at most, until
DAEMONS_WARM_CLEAN = 2              # this many in a row are host-free


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WARM_TAG = 2                         # the warm-up passes' payloads


def object_payload(seed: int, i: int, nbytes: int, tag: int = 0) -> bytes:
    """The seeded bytes of object i (tag + 1: its appended tail)."""
    return np.random.default_rng([seed, tag, i]).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


class ProcCluster:
    """The daemons of one cluster, each a process started with
    `python <main> <role> ... -c <conf>` (main: DAEMON_MAIN, or another
    command line of the same entry point), its output in
    `<workdir>/<name>.log` and its admin socket in `<workdir>/asok`.
    `conf` holds the [global] keys beside fsid, mon host and
    objectstore.  close() kills whatever still runs."""

    def __init__(self, workdir: str, mons: int, osds: int, conf: dict,
                 main=DAEMON_MAIN, env: dict | None = None,
                 mgr: bool = True):
        self.workdir = workdir
        self.asok_dir = os.path.join(workdir, "asok")
        os.makedirs(self.asok_dir, exist_ok=True)
        self.mons = [chr(ord("a") + i) for i in range(mons)]
        self.n_osds = osds
        self.main = tuple(main)
        self.mgr = mgr
        root = os.path.dirname(os.path.abspath(__file__))
        self.cwd = root
        self.env = dict(os.environ if env is None else env)
        self.env["PYTHONPATH"] = root + os.pathsep + self.env.get(
            "PYTHONPATH", "")
        hosts = ",".join(f"127.0.0.1:{free_port()}" for _ in self.mons)
        lines = ["[global]", f"fsid = {DAEMONS_FSID}",
                 f"mon host = {hosts}", "objectstore = memstore",
                 f"admin socket dir = {self.asok_dir}"]
        lines += [f"{k} = {v}" for k, v in conf.items()]
        self.conf_path = os.path.join(workdir, "ceph.conf")
        with open(self.conf_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.procs: dict = {}
        self.args: dict = {}
        self.killed: set = set()      # SIGKILLed and not started again
        self.admin = None

    def log_path(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.log")

    def log(self, name: str) -> str:
        with open(self.log_path(name), errors="replace") as f:
            return f.read()

    def asok(self, name: str) -> str:
        return os.path.join(self.asok_dir, f"{name}.asok")

    def spawn(self, name: str, args: list) -> None:
        """Start `name`; a name started before (a restart) keeps its old
        log as `<name>.log.1`."""
        path = self.log_path(name)
        if name in self.procs:
            os.replace(path, path + ".1")
        self.args[name] = args
        self.killed.discard(name)
        with open(path, "w") as log:
            self.procs[name] = subprocess.Popen(
                [sys.executable, *self.main, *args, "-c", self.conf_path],
                cwd=self.cwd, env=self.env, stdout=log,
                stderr=subprocess.STDOUT)

    def start_daemon(self, name: str, args: list,
                     timeout: float = DAEMONS_BOOT_TIMEOUT) -> float:
        """Start one daemon more (or again, with its first arguments
        when `args` is None) and wait for its `up at` line; returns the
        seconds."""
        t0 = time.perf_counter()
        self.spawn(name, self.args[name] if args is None else args)
        self.wait_up([name], timeout)
        return time.perf_counter() - t0

    def wait_up(self, names, timeout: float) -> None:
        """Until each daemon has printed its `<name> up at` line."""
        end = time.monotonic() + timeout
        for name in names:
            while f"{name} up at" not in self.log(name):
                rc = self.procs[name].poll()
                if rc is not None or time.monotonic() > end:
                    raise AssertionError(
                        f"{name} did not come up (rc {rc}): "
                        f"{self.log(name)[-3000:]}")
                time.sleep(0.1)

    def start(self, timeout: float = DAEMONS_BOOT_TIMEOUT,
              on_up=None) -> float:
        """The mons, then the mgr, then the OSDs, each group up before
        the next (on_up(group) after each); returns the seconds until
        every OSD is up in the mon's map."""
        from ceph_tpu_torch.tools import connect_from_conf
        t0 = time.perf_counter()
        groups = [("mons", [(f"mon.{n}", ["mon", "--name", n])
                            for n in self.mons])]
        if self.mgr:
            groups.append(("mgr", [("mgr.x", ["mgr", "--name", "x"])]))
        groups.append(("osds", [(f"osd.{i}", ["osd", "--id", str(i)])
                                for i in range(self.n_osds)]))
        for group, daemons in groups:
            for name, args in daemons:
                self.spawn(name, args)
            self.wait_up([name for name, _args in daemons], timeout)
            if on_up is not None:
                on_up(group)
        self.admin = connect_from_conf(self.conf_path, "client.launcher")
        self.wait_osds(lambda m: all(m.is_up(i)
                                     for i in range(self.n_osds)),
                       timeout, "every OSD up")
        return time.perf_counter() - t0

    def osdmap(self):
        from ceph_tpu_torch.osd.osdmap import OSDMap
        rv, out, data = self.admin.mon_command({"prefix": "osd dump"})
        if rv != 0:
            raise AssertionError(f"osd dump: {rv} {out}")
        return OSDMap.decode(data)

    def wait_osds(self, pred, timeout: float, what: str) -> float:
        """Poll the mon's OSD map until pred(map); returns seconds."""
        t0 = time.perf_counter()
        while not pred(self.osdmap()):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(what)
            time.sleep(0.1)
        return time.perf_counter() - t0

    def wait_clean(self, pool_id: int, pg_num: int, timeout: float
                   ) -> float:
        """Until the mon's PG map has all `pg_num` PGs of the pool
        active+clean; returns seconds."""
        t0 = time.perf_counter()
        while True:
            rv, out, data = self.admin.mon_command({"prefix": "pg dump"})
            if rv != 0:
                raise AssertionError(f"pg dump: {rv} {out}")
            stats = [st for pgid, st in json.loads(data).items()
                     if pgid.split(".")[0] == str(pool_id)]
            if len(stats) == pg_num and all(
                    st.get("state") == "active+clean" for st in stats):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"pool {pool_id} not clean: "
                                   f"{sorted(st.get('state') for st in stats)}")
            time.sleep(0.25)

    def perf(self, name: str) -> dict:
        """`ceph daemon <asok> perf dump`, through the port's ceph CLI."""
        import io
        from ceph_tpu_torch.tools import ceph_cli
        buf = io.StringIO()
        ceph_cli.main(["daemon", self.asok(name), "perf", "dump"], out=buf)
        return json.loads(buf.getvalue())

    def kill(self, name: str) -> None:
        self.procs[name].send_signal(signal.SIGKILL)
        self.procs[name].wait(DAEMONS_STOP_TIMEOUT)
        self.killed.add(name)

    def stop(self, timeout: float = DAEMONS_STOP_TIMEOUT) -> dict:
        """SIGTERM to every live daemon: the MDS and the gateway first
        (they write through the OSDs as they stop), then the OSDs and
        the mgr, then the mons; {name: exit code}, None for one that
        outlived `timeout` and was killed."""
        if self.admin is not None:
            self.admin.shutdown()
            self.admin = None
        live = {n: p for n, p in self.procs.items() if p.poll() is None}
        gateways = [n for n in live if n.startswith(("mds.", "rgw"))]
        codes = {}
        for group in (gateways,
                      [n for n in live if not n.startswith("mon.")
                       and n not in gateways],
                      [n for n in live if n.startswith("mon.")]):
            for n in group:
                live[n].send_signal(signal.SIGTERM)
            for n in group:
                try:
                    codes[n] = live[n].wait(timeout)
                except subprocess.TimeoutExpired:
                    live[n].kill()
                    live[n].wait()
                    codes[n] = None
        return codes

    def close(self) -> None:
        if self.admin is not None:
            self.admin.shutdown()
            self.admin = None
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def client_main(conf_path: str, name: str, pool: str, seed: int,
                conn) -> None:
    """One client process: its own Rados from the conf; runs each
    (op, items, tag[, pool]) it is sent on `pool` unless the message
    names another, items being (oid, payload index, bytes, appended
    bytes) as objects() makes them, with the payloads of `tag`
    (object_payload), and answers (per-op seconds, errors)."""
    from ceph_tpu_torch.tools import connect_from_conf
    rados = connect_from_conf(conf_path, name)
    try:
        ios = {pool: rados.open_ioctx(pool)}
        conn.send("ready")
        while True:
            msg = conn.recv()
            if msg is None:
                break
            op, items, tag, *other = msg
            target = other[0] if other else pool
            if target not in ios:
                ios[target] = rados.open_ioctx(target)
            io = ios[target]
            lat, errs = [], []
            for oid, i, nbytes, tail in items:
                t0 = time.perf_counter()
                try:
                    if op == "write":
                        io.write_full(oid, object_payload(seed, i, nbytes,
                                                          tag))
                    elif op == "append":
                        io.append(oid, object_payload(seed, i, tail,
                                                      tag + 1))
                    else:
                        want = object_payload(seed, i, nbytes, tag)
                        if tail:
                            want += object_payload(seed, i, tail, tag + 1)
                        if bytes(io.read(oid)) != want:
                            errs.append(f"read of {oid} != its payload")
                except Exception as e:   # noqa: BLE001 (sent back)
                    errs.append(f"{op} {oid}: {e!r}")
                lat.append(time.perf_counter() - t0)
            conn.send((lat, errs))
    finally:
        rados.shutdown()


def objects(idxs, appended=()) -> list:
    """Client items of objects obj<i>: CLUSTER_OBJECT_BYTES each, with
    CLUSTER_APPEND_BYTES appended to those in `appended`."""
    return [(f"obj{i}", i, CLUSTER_OBJECT_BYTES,
             CLUSTER_APPEND_BYTES if i in appended else 0) for i in idxs]


class ClientProcs:
    """`n` client processes running `main` (client_main unless said),
    named `<name><t>`; item j of a run goes to client j % n.  Call
    ready() after the constructor unless `wait` was left True."""

    def __init__(self, conf_path: str, pool: str, n: int, seed: int,
                 main=None, name: str = "client.load", wait: bool = True):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        try:
            for t in range(n):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=main or client_main, daemon=True,
                                args=(conf_path, f"{name}{t}", pool,
                                      seed, child))
                p.start()
                self.conns.append(parent)
                self.procs.append(p)
            if wait:
                self.ready()
        except BaseException:
            self.close()
            raise

    def ready(self) -> None:
        """Until every client process has connected."""
        for c in self.conns:
            if not c.poll(DAEMONS_BOOT_TIMEOUT) or c.recv() != "ready":
                raise AssertionError("a client process did not connect")

    def run(self, op: str, items, clients=None, tag=0, pool=None):
        """`op` ("write", "read", "append") on `items`
        with the payloads of `tag`, spread over the clients (or over the
        first `clients`), concurrently, on the clients' pool or `pool`;
        returns (wall seconds, per-op seconds).  Raises the first error
        a client reported."""
        wall, lat, _out = self.run_out(op, items, clients, tag, pool)
        return wall, lat

    def run_out(self, op: str, items, clients=None, tag=0, pool=None):
        """run(), returning (wall seconds, per-op seconds, each item's
        result in item order) where the client's main answers results."""
        n = clients or len(self.conns)
        parts = [items[t::n] for t in range(n)]
        t0 = time.perf_counter()
        for c, part in zip(self.conns, parts):
            c.send((op, part, tag) if pool is None else (op, part, tag, pool))
        lat, errs, out = [], [], [None] * len(items)
        for t, (c, part) in enumerate(zip(self.conns, parts)):
            if not c.poll(DAEMONS_CLIENT_TIMEOUT):
                raise TimeoutError(f"{op}: a client process did not "
                                   f"answer in {DAEMONS_CLIENT_TIMEOUT} s")
            got = c.recv()
            lat += got[0]
            errs += got[1]
            if len(got) > 2:
                out[t::n] = got[2]
        wall = time.perf_counter() - t0
        if errs:
            raise AssertionError(f"{op}: {errs[:4]}")
        return wall, lat, out

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()


PIPE_COUNTERS = ("dispatches", "dev_dispatches", "host_dispatches",
                 "dev_dispatches_enc", "dev_dispatches_dec",
                 "dev_dispatches_crc", "stripes", "bytes_h2d", "bytes_d2h",
                 "cache_hit", "cache_read_bytes_served")


def osd_counters(cluster, osds) -> dict:
    """{osd: its perf dump's ec_pipeline counters, its process's kernel
    launches (launch_<kernel>) and recovery_pushes}."""
    out = {}
    for i in osds:
        perf = cluster.perf(f"osd.{i}")
        pipe = perf["ec_pipeline"]
        out[i] = {k: pipe[k] for k in PIPE_COUNTERS}
        out[i].update({f"launch_{name}": n
                       for name, n in pipe["launches"].items()})
        out[i]["recovery_pushes"] = perf["osd"]["recovery_pushes"]
    return out


def counters_delta(before: dict, after: dict) -> dict:
    """Summed over the OSDs alive at both ends, with stripes per
    dispatch, and per OSD the dispatches and stripes per dispatch."""
    live = sorted(set(before) & set(after))
    d = {k: sum(after[i][k] - before[i][k] for i in live)
         for k in after[live[0]]}
    d["stripes_per_dispatch"] = d["stripes"] / max(1, d["dispatches"])
    d["per_osd"] = {i: [after[i]["dispatches"] - before[i]["dispatches"],
                        (after[i]["stripes"] - before[i]["stripes"])
                        / max(1, after[i]["dispatches"]
                              - before[i]["dispatches"])]
                    for i in live}
    return d


def window_launches(d: dict) -> dict:
    """The kernel launches of a window's counters_delta."""
    return {k[len("launch_"):]: v for k, v in d.items()
            if k.startswith("launch_")}


def daemons_window(cluster, osds, before: dict, what: str, kinds) -> dict:
    """Close a counted window of phase 14: every OSD's counters read
    over its admin socket, summed; device dispatches of each kind in
    `kinds` ("enc", "dec", "crc") above 0, no stripe batch on a host,
    and each kernel entry point launched in the OSD processes exactly
    once per device dispatch of its kind (as cluster_window checks in
    one process)."""
    after = osd_counters(cluster, osds)
    d = counters_delta(before, after)
    want = {"gf_encode": d["dev_dispatches_dec"],
            "gf_encode_crc": d["dev_dispatches_enc"],
            "crc32c_segments": d["dev_dispatches_crc"],
            "crc32c_chain": d["dev_dispatches_enc"]
            + d["dev_dispatches_crc"]}
    idle = [k for k in kinds if d[f"dev_dispatches_{k}"] < 1]
    if idle or d["host_dispatches"] or window_launches(d) != want:
        raise AssertionError(f"{what}: no device {idle} dispatch, host "
                             f"batches, or launches != {want}: {d}")
    return d


def deep_scrub_procs(cluster, pool_id: int, timeout: float) -> tuple:
    """`pg deep-scrub` of every PG of the pool, one PG at a time (the mon
    command the ceph CLI sends; the mon hands it to the PG's primary),
    each result read from the primary's log line `scrub <pgid>: {...}`;
    returns (wall seconds, {pgid: result}).  One at a time: concurrent
    scrubs coalesce in a shard holder's pipeline into row counts that
    no warm-up pass can be sure to have met."""
    import ast
    import re
    line = re.compile(r" 1 scrub (\S+): (\{.*\})\s*$")
    osdmap = cluster.osdmap()
    results: dict = {}
    t0 = time.perf_counter()
    for pg in osdmap.all_pgs():
        if pg.pool != pool_id:
            continue
        pgid, log = str(pg), cluster.log_path(f"osd.{osdmap.pg_primary(pg)}")
        offset = os.path.getsize(log)
        rv, out, _ = cluster.admin.mon_command(
            {"prefix": "pg deep-scrub", "pgid": pgid})
        if rv != 0:
            raise AssertionError(f"pg deep-scrub {pgid}: {rv} {out}")
        while pgid not in results:
            with open(log, errors="replace") as f:
                f.seek(offset)
                for text in f:
                    m = line.search(text)
                    if m and m.group(1) == pgid:
                        results[pgid] = ast.literal_eval(m.group(2))
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"deep scrub of {pgid}: no result "
                                   f"({len(results)} PGs done)")
            time.sleep(0.01)
    return time.perf_counter() - t0, results


def cli(cluster, *words) -> str:
    """The port's ceph CLI against the cluster's conf."""
    import io
    from ceph_tpu_torch.tools import ceph_cli
    buf = io.StringIO()
    rc = ceph_cli.main(["-c", cluster.conf_path, *words], out=buf)
    if rc != 0:
        raise AssertionError(f"ceph {' '.join(words)}: rc {rc}")
    return buf.getvalue()


def nvidia_smi(query: str) -> list:
    """The rows of `nvidia-smi --query-<query> --format=csv,noheader,
    nounits`, each a list of fields."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-{query}", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [[f.strip() for f in line.split(",")]
            for line in out.strip().splitlines()]


def card_processes() -> dict:
    """{pid: MiB} of the processes nvidia-smi lists on the card."""
    return {int(pid): float(mib) for pid, mib in
            nvidia_smi("compute-apps=pid,used_memory")}


def card_used_mib() -> float:
    """Device memory in use on card 0, all processes, MiB."""
    return float(nvidia_smi("gpu=memory.used")[0][0])


def lanes_on_card(cluster, osds) -> dict:
    """{osd: [lane device, lane dispatches]} from each OSD's perf dump;
    raises unless every OSD process dispatched on a CUDA lane."""
    lanes = {}
    for i in osds:
        devs = cluster.perf(f"osd.{i}")["ec_pipeline"]["devices"]
        lanes[i] = [[d["device"], d["dispatches"]] for d in devs.values()]
        if not any(dev.startswith("cuda") and k > 0
                   for dev, k in lanes[i]):
            raise AssertionError(f"osd.{i} dispatched nothing on a card: "
                                 f"{lanes[i]}")
    return lanes


def card_mib_report(card_mib: dict, seen: dict, pids: dict) -> dict:
    """Card memory: nvidia-smi's memory.used after each group of daemons
    came up and at its peak in the write window, the rise each group
    brought (per OSD process: the OSDs' rise over their count), and
    each daemon's own line of --query-compute-apps where it lists the
    daemon's pid (a container's PID namespace can hide them)."""
    rise = {g: card_mib[g] - card_mib[prev] for prev, g in
            zip(("before", "mons", "mgr"), ("mons", "mgr", "osds"))
            if g in card_mib and prev in card_mib}
    return {"used": card_mib, "rise": rise,
            "per_osd_at_boot": rise.get("osds", 0.0) / CLUSTER_OSDS,
            "per_osd_in_writes": (card_mib.get("writes", 0.0)
                                  - card_mib["mgr"]) / CLUSTER_OSDS,
            "compute_apps": {str(k): v for k, v in seen.items()},
            "by_pid": {nm: seen[pid] for nm, pid in pids.items()
                       if pid in seen}}


def lost_shards(osdmap, pool_id: int, victim: int, n: int) -> dict:
    """{object index: shard position} of the victim's shards."""
    out = {}
    for i in range(n):
        acting = osdmap.pg_to_up_acting_osds(
            osdmap.object_to_pg(pool_id, f"obj{i}"))[1]
        if victim in acting:
            out[i] = acting.index(victim)
    return out


def primaries_of(osdmap, pool_id: int, n: int) -> list:
    """The OSDs that are the primary of a PG holding one of the n
    objects: killing one moves the degraded reads and rebuilds of its
    PGs to their next primaries."""
    return sorted({osdmap.pg_primary(osdmap.object_to_pg(pool_id,
                                                         f"obj{i}"))
                   for i in range(n)})


def ec_warm(cluster, osds, pool: str, shard_sizes) -> dict:
    """`ec warm` on every OSD in `osds`: the pool's codec at each padded
    batch up to osd_ec_pipeline_max_batch or the largest object's
    stripes (every device call its codec's path makes: a tpu pool's
    fused encode and decodes of 1..m rows), and the scrub CRC over
    shards of each of `shard_sizes` bytes, before the windows meet those
    shapes (a first call at a new shape serves from the host while its
    kernels warm).  Returns the shapes, their count by kind and the
    slowest OSD's seconds."""
    top = max(int(cluster_conf().osd_ec_pipeline_max_batch),
              max(shard_sizes) // CLUSTER_UNIT)
    got = osds_command(cluster, osds, {
        "prefix": "ec warm", "pool": pool,
        "stripes": [1 << j for j in range(top.bit_length())],
        "scrub_sizes": list(shard_sizes)})
    kinds: dict = {}
    for a in got.values():
        for kind, k in a["kinds"].items():
            kinds[kind] = kinds.get(kind, 0) + k
    return {"shapes": sum(a["shapes"] for a in got.values()),
            "kinds": kinds, "s": max(a["s"] for a in got.values())}


def object_stripes(items) -> int:
    """Stripes of the objects of client items."""
    width = K * CLUSTER_UNIT
    return sum(-(-(nbytes + tail) // width)
               for _oid, _i, nbytes, tail in items)


def decode_share(d: dict, stripes_read: int):
    """The share of a read window's stripes that went through a decode
    (its dispatches all decodes), None if other kinds ran."""
    if d["dispatches"] != d["dev_dispatches_dec"]:
        return None
    return d["stripes"] / stripes_read


# stripes decoded per stripe read, at most, in a degraded-read window:
# each read decodes its stripes once (a resent copy runs no second
# decode) or fewer (reads the primary serves whole)
MAX_DECODE_SHARE = 1.1


def decode_share_ok(d: dict, stripes_read: int, what: str) -> float:
    """decode_share(), which must exist and be at most
    MAX_DECODE_SHARE."""
    share = decode_share(d, stripes_read)
    if share is None or share > MAX_DECODE_SHARE:
        raise AssertionError(f"{what}: {share} stripes decoded per stripe "
                             f"read (at most {MAX_DECODE_SHARE}): {d}")
    return share


def phase_daemons(rng, doors10=None):
    """Phase 14, then phases 15 and 17 on its cluster (see the module
    docstring); `doors10` is phase 10's result, None when it did not
    run."""
    import shutil
    from ceph_tpu_torch.tools import connect_from_conf
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, "_scratch", "daemons")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t_start = time.perf_counter()
    # each OSD process gets 1/13 of phase 9's shared 4 GiB HBM cache:
    # the card holds the same cache in all
    cluster = ProcCluster(workdir, CLUSTER_MONS, CLUSTER_OSDS, {
        **CLUSTER_CONF,
        "osd_ec_hbm_cache_bytes": HBM_CACHE_BYTES // CLUSTER_OSDS})
    clients = None
    osds = list(range(CLUSTER_OSDS))
    n, nbytes = DAEMONS_OBJECTS, CLUSTER_OBJECT_BYTES
    appended = set(range(CLUSTER_APPENDS))
    every = objects(range(n), appended)
    tails = objects(sorted(appended), appended)
    stripes_read = object_stripes(every)
    grace = float(CLUSTER_CONF["osd_heartbeat_grace"])
    probes = {}
    out = {"mons": CLUSTER_MONS, "osds": CLUSTER_OSDS, "mgrs": 1,
           "pg_num": CLUSTER_PG_NUM, "profile": CLUSTER_PROFILE,
           "objects": n, "object_bytes": nbytes,
           "clients": CLUSTER_CLIENTS, "client_processes": True}

    def probe(stage: str) -> None:
        probes[stage] = first_health(
            lambda name: connect_from_conf(cluster.conf_path, name),
            f"client.probe_{stage}", f"daemons_{stage}")["s"]

    def warm(fn) -> int:
        """Uncounted passes of `fn` until DAEMONS_WARM_CLEAN in a row run
        no batch on a host, DAEMONS_WARM_ROUNDS at most (concurrent ops
        coalesce into varying shapes, and the scrub channel's row counts
        vary); returns the passes.  The counted window's own check says
        whether they sufficed."""
        clean = 0
        for rounds in range(1, DAEMONS_WARM_ROUNDS + 1):
            before = osd_counters(cluster, live)
            fn()
            host = counters_delta(before, osd_counters(
                cluster, live))["host_dispatches"]
            clean = 0 if host else clean + 1
            if clean == DAEMONS_WARM_CLEAN:
                break
        return rounds

    card_mib = {"before": card_used_mib()}

    def on_up(group: str) -> None:
        card_mib[group] = card_used_mib()

    try:
        boot_s = cluster.start(on_up=on_up)
        live = list(osds)
        cli(cluster, "osd", "erasure-code-profile", "set", "k8m3",
            *(f"{k}={v}" for k, v in CLUSTER_PROFILE.items()))
        cli(cluster, "osd", "pool", "create", CLUSTER_POOL,
            str(CLUSTER_PG_NUM), "erasure", "k8m3")
        pool_id = cluster.osdmap().pool_by_name(CLUSTER_POOL).id
        cluster.wait_clean(pool_id, CLUSTER_PG_NUM, CLUSTER_TIMEOUT)
        clients = ClientProcs(cluster.conf_path, CLUSTER_POOL,
                              CLUSTER_CLIENTS, SEED)
        out["boot_s"] = time.perf_counter() - t_start
        out["osds_up_s"] = boot_s
        probe("boot")
        t0 = time.perf_counter()
        out["ec_warm"] = ec_warm(cluster, osds, CLUSTER_POOL, (
            CLUSTER_OBJECT_BYTES // K,
            object_stripes(tails) // len(tails) * CLUSTER_UNIT))

        def warm_writes():
            # the counted window's objects, ops and sizes, other bytes:
            # the appends' tail shapes on their primaries, and the
            # writes' coalescing
            clients.run("write", objects(range(n)), tag=WARM_TAG)
            clients.run("read", objects(range(n)), tag=WARM_TAG)
            clients.run("append", tails, clients=1, tag=WARM_TAG)
            clients.run("read", tails, tag=WARM_TAG)

        out["warm_passes"] = {"writes": warm(warm_writes)}
        out["warm_s"] = time.perf_counter() - t0
        emit("daemons_boot", **out)

        # -- window 1: writes, reads, appends ------------------------------
        seen: dict = {}
        stop = threading.Event()

        def sample_card():
            while not stop.wait(0.5):
                seen.update(card_processes())
                card_mib["writes"] = max(card_mib.get("writes", 0.0),
                                         card_used_mib())

        before = osd_counters(cluster, live)
        sampler = threading.Thread(target=sample_card, daemon=True)
        sampler.start()
        try:
            w_wall, w_lat = clients.run("write", objects(range(n)))
        finally:
            stop.set()
            sampler.join()
        probe("writes")
        r_wall, r_lat = clients.run("read", objects(range(n)))
        clients.run("append", tails, clients=1)
        clients.run("read", tails)
        probe("reads")
        d_write = daemons_window(cluster, live, before,
                                 "daemons writes, reads and appends",
                                 ("enc",))
        lanes = lanes_on_card(cluster, live)
        pids = {name: p.pid for name, p in cluster.procs.items()}
        listed = {nm for nm, pid in pids.items() if pid in seen}
        if listed and not {f"osd.{i}" for i in live} <= listed:
            raise AssertionError(f"nvidia-smi lists {sorted(listed)} but "
                                 f"not every OSD: {seen} {pids}")
        step = dict(write_gbs=n * nbytes / w_wall / 1e9,
                    write_lat_ms=percentiles_ms(w_lat),
                    read_gbs=n * nbytes / r_wall / 1e9,
                    read_lat_ms=percentiles_ms(r_lat),
                    write_window=d_write, osd_lanes=lanes,
                    stripes_per_write_dispatch={
                        i: spd for i, (k, spd) in d_write["per_osd"].items()
                        if k},
                    card_mib=card_mib_report(card_mib, seen, pids),
                    elapsed_s=time.perf_counter() - t_start)
        emit("daemons_writes", **step)
        out.update(step)

        # scrub, degraded reads and recovery go to the shards, as phase
        # 9's do after its cache clears
        osds_command(cluster, live, {"prefix": "cache drop"})

        # -- window 2: deep scrub --------------------------------------------
        scrub_passes = warm(lambda: deep_scrub_procs(
            cluster, pool_id, CLUSTER_TIMEOUT))
        before = osd_counters(cluster, live)
        s_wall, results = deep_scrub_procs(cluster, pool_id,
                                           CLUSTER_TIMEOUT)
        bad = {p: r for p, r in results.items() if r["inconsistent"]}
        if bad:
            raise AssertionError(f"deep scrub found inconsistencies: {bad}")
        d_scrub = daemons_window(cluster, live, before,
                                 "daemons deep scrub", ("crc",))
        probe("scrub")
        total = n * nbytes + len(appended) * CLUSTER_APPEND_BYTES
        step = dict(scrub_gbs=total * (K + M) / K / s_wall / 1e9,
                    scrub_checked=sum(r["checked"]
                                      for r in results.values()),
                    scrub_warm_passes=scrub_passes,
                    scrub_window=d_scrub,
                    elapsed_s=time.perf_counter() - t_start)
        emit("daemons_scrub", **step)
        out.update(step)

        # -- window 3: a real process death, degraded reads, recovery --------
        osdmap = cluster.osdmap()
        eligible = primaries_of(osdmap, pool_id, n)
        victim = eligible[int(rng.integers(len(eligible)))]
        lost = lost_shards(osdmap, pool_id, victim, n)
        down_s = kill_and_wait_down(cluster, victim, grace)
        live.remove(victim)
        d_deg, g_wall, g_lat = degraded_reads(
            cluster, clients, live, every, warm, "daemons degraded reads")
        probe("degraded_reads")
        before = osd_counters(cluster, live)
        t0 = time.perf_counter()
        cli(cluster, "osd", "out", str(victim))
        recovery_s = wait_recovered(cluster, live, before, pool_id,
                                    len(lost), CLUSTER_RECOVERY_TIMEOUT,
                                    t0)
        d_rec = daemons_window(cluster, live, before, "daemons recovery",
                               ("dec", "enc"))
        probe("recovery")
        step = dict(victim=victim, marked_down_s=down_s,
                    degraded_read_gbs=total / g_wall / 1e9,
                    degraded_read_lat_ms=percentiles_ms(g_lat),
                    degraded_decode_share=decode_share_ok(
                        d_deg, stripes_read, "daemons degraded reads"),
                    degraded_window=d_deg, recovery_s=recovery_s,
                    lost_shards=len(lost), recovery_window=d_rec,
                    elapsed_s=time.perf_counter() - t_start)
        emit("daemons_recovery", **step)
        out.update(step)

        # -- window 4: a second death, of an OSD holding rebuilt shards ------
        osdmap = cluster.osdmap()
        holders = sorted({osdmap.pg_to_up_acting_osds(osdmap.object_to_pg(
            pool_id, f"obj{i}"))[1][shard] for i, shard in lost.items()})
        eligible = [o for o in holders
                    if o in primaries_of(osdmap, pool_id, n)] or holders
        victim2 = eligible[int(rng.integers(len(eligible)))]
        down2_s = kill_and_wait_down(cluster, victim2, grace)
        live.remove(victim2)
        d_deg2, g2_wall, g2_lat = degraded_reads(
            cluster, clients, live, every, warm,
            "daemons degraded reads after the second death")
        probe("second_degraded_reads")
        step = dict(victim2=victim2, marked_down2_s=down2_s,
                    degraded_read2_gbs=total / g2_wall / 1e9,
                    degraded_read2_lat_ms=percentiles_ms(g2_lat),
                    degraded2_decode_share=decode_share_ok(
                        d_deg2, stripes_read,
                        "daemons degraded reads after the second death"),
                    degraded2_window=d_deg2,
                    elapsed_s=time.perf_counter() - t_start)
        emit("daemons_second_death", **step)
        out.update(step)

        clients.close()
        clients = None

        # -- phase 15: the doors as processes on this cluster --------------
        out["doors"] = phase_doors_daemons(cluster, rng, live, victim2,
                                           pool_id, doors10)

        # -- phase 17: the plugins' pools on this cluster ------------------
        out["plugins"] = phase_plugin_pools(cluster, rng, live, victim,
                                            out["doors"]["victim3"])

        # -- teardown ----------------------------------------------------------
        codes = cluster.stop()
        bad = {nm: rc for nm, rc in codes.items() if rc != 0}
        if bad or set(codes) != set(cluster.procs) - cluster.killed:
            raise AssertionError(f"SIGTERM exits: {codes}")
        out.update(exit_codes=codes, first_health_s=probes,
                   wall_s=time.perf_counter() - t_start)
        emit("daemons", **{k: v for k, v in out.items()
                           if not k.endswith("window") and k != "doors"})
        return out
    finally:
        if clients is not None:
            clients.close()
        cluster.close()


def kill_and_wait_down(cluster, victim: int, grace: float) -> float:
    """SIGKILL osd.<victim>; the seconds until the mon's map has it down,
    which only its peers' failure reports can do.  Raises past twice the
    heartbeat grace (the peers report once the grace has passed)."""
    t0 = time.perf_counter()
    cluster.kill(f"osd.{victim}")
    cluster.wait_osds(lambda m: not m.is_up(victim), 2 * grace,
                      f"osd.{victim} not marked down")
    down_s = time.perf_counter() - t0
    reports = [mon for mon in cluster.mons
               if f"marking osd.{victim} down (" in cluster.log(
                   f"mon.{mon}")]
    if not reports:
        raise AssertionError(f"osd.{victim} down, but no mon logged the "
                             f"failure reports")
    return down_s


def degraded_reads(cluster, clients, live, items, warm, what):
    """Every object read back bit-exact with OSDs down: uncounted warm
    passes, then the counted one; returns (window, wall seconds, per-op
    seconds)."""
    warm(lambda: clients.run("read", items))
    before = osd_counters(cluster, live)
    wall, lat = clients.run("read", items)
    return daemons_window(cluster, live, before, what, ("dec",)), wall, lat


def wait_recovered(cluster, live, before, pool_id, lost: int,
                   timeout: float, t0: float) -> float:
    """After a mark-out: until the PGs are active+clean, the OSDs have
    landed at least `lost` rebuilt shards (recovery_pushes counts each,
    local or pushed) and their counters stood still for a second;
    returns seconds since t0."""
    while True:
        now = osd_counters(cluster, live)
        d = counters_delta(before, now)
        if d["recovery_pushes"] >= lost:
            cluster.wait_clean(pool_id, CLUSTER_PG_NUM,
                               timeout - (time.perf_counter() - t0))
            time.sleep(1.0)
            if osd_counters(cluster, live) == now:
                return time.perf_counter() - t0 - 1.0
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"recovery: {d}")
        time.sleep(0.25)


# -- phase 15: the doors as processes on phase 14's cluster ----------------

DOOR_TAGS = {"s3": 10, "rbd": 20, "cephfs": 30}   # object_payload tags
DOOR_ITEMS = {"s3": S3_OBJECTS, "rbd": RBD_CLIENTS,
              "cephfs": FS_CLIENTS * FS_FILES}
DOOR_BYTES = {"s3": S3_OBJECT_BYTES, "rbd": RBD_IMAGE_BYTES,
              "cephfs": FS_FILE_BYTES}
DOORS_RGW = "rgw"                      # the gateway's ProcCluster name


def door_payload(seed: int, door: str, i: int, nbytes: int) -> bytes:
    """The seeded body of S3 object i, RBD image i or CephFS file i."""
    return object_payload(seed, i, nbytes, DOOR_TAGS[door])


def door_op(door: str, ctx, seed: int, op: str, item: tuple, lat: list):
    """One op of a door client on item (i, bytes of its body); appends
    each RADOS-object-size op's seconds to `lat` and returns the op's
    result."""
    O = DOORS_OBJECT_BYTES
    i, nbytes = item
    if door == "s3":
        path = f"/{DOORS_BUCKET}/obj{i}"
        t0 = time.perf_counter()
        if op == "bucket":
            s3_request(ctx, "PUT", f"/{DOORS_BUCKET}")
            return None
        if op == "size":
            return int(s3_request(ctx, "HEAD", path)[0]["Content-Length"])
        body = door_payload(seed, door, i, nbytes)
        headers, got = s3_request(ctx, "PUT" if op == "write" else "GET",
                                  path, body if op == "write" else b"")
        lat.append(time.perf_counter() - t0)
        if (op == "read" and got != body) or \
                etag_of(headers) != hashlib.md5(body).hexdigest():
            raise AssertionError(f"S3 {op} obj{i}: body or ETag != PUT")
        return None
    if door == "rbd":
        from ceph_tpu_torch.rbd import RBD, Image
        name = f"image{i}"
        if op == "create":
            RBD(ctx).create(name, nbytes, order=RBD_ORDER)
            return None
        if op == "size":
            with Image(ctx, name) as img:
                return img.stat()["size"]
        body = door_payload(seed, door, i, nbytes)
        img = Image(ctx, name, cache=True)
        try:
            for n in range(nbytes // O):
                t0 = time.perf_counter()
                if op == "write":
                    img.write(n * O, body[n * O:(n + 1) * O])
                elif bytes(img.read(n * O, O)) != body[n * O:(n + 1) * O]:
                    raise AssertionError(f"{name} object {n} != written")
                lat.append(time.perf_counter() - t0)
        finally:
            img.close()           # flushes the ObjectCacher
        return None
    path = f"/file{i}"
    if op == "size":
        return ctx.stat(path)["size"]
    body = door_payload(seed, door, i, nbytes)
    t0 = time.perf_counter()
    f = ctx.open(path, "w" if op == "write" else "r")
    if op == "write":
        f.write(body)
    got = None if op == "write" else f.read()
    f.close()
    lat.append(time.perf_counter() - t0)
    if got is not None and got != body:
        raise AssertionError(f"{path} != written")
    return f.ino


def door_main(conf_path: str, name: str, door: str, seed: int,
              conn) -> None:
    """One door client process.  `door` "s3:<port>": SigV4 requests over
    HTTP to the RGW process, no Rados of its own; "rbd": its own Rados,
    the images with the ObjectCacher on; "cephfs": its own Rados and a
    CephFS mount through the MDS process.  Runs each (op, items, tag)
    it is sent (door_op) and answers (per-op seconds, errors, results)."""
    from ceph_tpu_torch.tools import connect_from_conf
    kind, _, port = door.partition(":")
    rados = None
    try:
        if kind == "s3":
            ctx = int(port)
        else:
            rados = connect_from_conf(conf_path, name)
            if kind == "rbd":
                ctx = rados.open_ioctx(DOORS_POOL)
            else:
                from ceph_tpu_torch.fs import CephFS, FsError
                ctx = CephFS(rados, data_pool=DOORS_POOL,
                             metadata_pool=DOORS_META)
                end = time.monotonic() + DOORS_TIMEOUT
                while True:
                    try:
                        ctx.mount(timeout=10.0)
                        break
                    except FsError:
                        if time.monotonic() > end:
                            raise
        conn.send("ready")
        while True:
            msg = conn.recv()
            if msg is None:
                break
            op, items, _tag = msg
            lat, errs, out = [], [], []
            for item in items:
                try:
                    out.append(door_op(kind, ctx, seed, op, item, lat))
                except Exception as e:   # noqa: BLE001 (sent back)
                    errs.append(f"{kind} {op} {item[0]}: {e!r}")
                    out.append(None)
            conn.send((lat, errs, out))
    finally:
        if rados is not None:
            rados.shutdown()


class DoorProcs:
    """Phase 15's client processes: S3_CLIENTS S3 clients over HTTP to the
    RGW process, RBD_CLIENTS RBD clients and FS_CLIENTS CephFS clients
    through the MDS process, one Rados or HTTP client each."""

    def __init__(self, conf_path: str, port: int, seed: int):
        self.seed = seed
        self.procs: dict = {}
        self.inos: list = []
        try:
            for kind, n in (("s3", S3_CLIENTS), ("rbd", RBD_CLIENTS),
                            ("cephfs", FS_CLIENTS)):
                self.procs[kind] = ClientProcs(
                    conf_path, f"s3:{port}" if kind == "s3" else kind, n,
                    seed, main=door_main, name=f"client.{kind}",
                    wait=False)
            for procs in self.procs.values():
                procs.ready()
        except BaseException:
            self.close()
            raise

    @staticmethod
    def items(kind: str) -> list:
        """The door's items: (index, bytes of its body)."""
        return [(i, DOOR_BYTES[kind]) for i in range(DOOR_ITEMS[kind])]

    def setup(self) -> None:
        """The bucket and the images, before the write window."""
        self.procs["s3"].run("bucket", self.items("s3")[:1], clients=1)
        self.procs["rbd"].run("create", self.items("rbd"))

    def run(self, op: str) -> dict:
        """`op` ("write" or "read") through every door, one door after
        the other; per-door rates and all together."""
        out = {}
        for kind, procs in self.procs.items():
            wall, lat, res = procs.run_out(op, self.items(kind))
            if kind == "cephfs" and op == "write":
                self.inos = res
            out[kind] = door_rate(DOOR_ITEMS[kind] * DOOR_BYTES[kind],
                                  wall, lat)
        out["gbs"] = self.nbytes() / sum(v["wall_s"] for v in out.values()
                                         if isinstance(v, dict)) / 1e9
        return out

    def check_sizes(self) -> None:
        """stat through each door: S3 HEAD, RBD image size, CephFS."""
        for kind, procs in self.procs.items():
            _w, _l, sizes = procs.run_out("size", self.items(kind))
            if sizes != [DOOR_BYTES[kind]] * DOOR_ITEMS[kind]:
                raise AssertionError(f"{kind} sizes {sizes}")

    def nbytes(self) -> int:
        return sum(DOOR_ITEMS[k] * DOOR_BYTES[k] for k in self.procs)

    def objects(self) -> dict:
        """{RADOS data object: its payload}: the 4 MiB objects each door
        stripes its bodies into."""
        from ceph_tpu_torch.client.striper import object_name
        from ceph_tpu_torch.fs import data_oid as fs_oid
        from ceph_tpu_torch.rbd import data_oid as rbd_oid
        from ceph_tpu_torch.rgw import obj_soid
        O = DOORS_OBJECT_BYTES
        names = {"s3": lambda i, n: object_name(
                     obj_soid(DOORS_BUCKET, f"obj{i}"), n),
                 "rbd": lambda i, n: rbd_oid(f"image{i}", n),
                 "cephfs": lambda i, n: fs_oid(self.inos[i], n)}
        out = {}
        for kind in self.procs:
            for i, nbytes in self.items(kind):
                body = door_payload(self.seed, kind, i, nbytes)
                for n in range(len(body) // O):
                    out[names[kind](i, n)] = body[n * O:(n + 1) * O]
        return out

    def close(self) -> None:
        for procs in self.procs.values():
            procs.close()
        self.procs = {}


def doors_pools_cli(cluster, profile_name: str, profile: dict,
                    pg_num: int, meta_pg_num: int, settings: dict) -> dict:
    """Phase 10's pools through the port's ceph CLI: the EC base, the
    replicated writeback tier over it with `settings`, the CephFS
    metadata pool; each clean.  Returns {step: seconds}."""
    t0 = time.perf_counter()
    cli(cluster, "osd", "erasure-code-profile", "set", profile_name,
        *(f"{k}={v}" for k, v in profile.items()))
    for words in ([DOORS_POOL, str(pg_num), str(pg_num), "erasure",
                   profile_name], [DOORS_HOT, str(pg_num)],
                  [DOORS_META, str(meta_pg_num)]):
        cli(cluster, "osd", "pool", "create", *words)
    osdmap = cluster.osdmap()
    for name, n in ((DOORS_POOL, pg_num), (DOORS_HOT, pg_num),
                    (DOORS_META, meta_pg_num)):
        cluster.wait_clean(osdmap.pool_by_name(name).id, n, CLUSTER_TIMEOUT)
    pools_s = time.perf_counter() - t0
    cli(cluster, "osd", "tier", "add", DOORS_POOL, DOORS_HOT)
    cli(cluster, "osd", "tier", "cache-mode", DOORS_HOT, "writeback")
    cli(cluster, "osd", "tier", "set-overlay", DOORS_POOL, DOORS_HOT)
    for var, val in settings.items():
        cli(cluster, "osd", "pool", "set", DOORS_HOT, var, val)
    return {"pools_s": pools_s,
            "tier_s": time.perf_counter() - t0 - pools_s}


def start_doors_daemons(cluster, port: int, card) -> dict:
    """The MDS and the RGW as processes, each with its admin socket;
    each boot's seconds and, with `card` (card_used_mib), the card's
    memory before and after it.  Raises if either initialised CUDA."""
    from ceph_tpu_torch.utils.admin_socket import admin_command
    out = {"mib_before": card() if card else None}
    for name, args in (
            ("mds.a", ["mds", "--name", "a", "--metadata-pool", DOORS_META,
                       "--data-pool", DOORS_POOL]),
            (DOORS_RGW, ["rgw", "--port", str(port), "--access-key",
                         DOORS_ACCESS, "--secret-key", DOORS_SECRET,
                         "--data-pool", DOORS_POOL])):
        out[f"{name}_boot_s"] = cluster.start_daemon(name, args)
        out[f"{name}_mib_after"] = card() if card else None
        entity = "client.rgw" if name == DOORS_RGW else name
        status = admin_command(cluster.asok(entity), "status")
        if status.get("cuda_initialized") is not False:
            raise AssertionError(f"{name} initialised CUDA: {status}")
    return out


def doors_shards(cluster, osdmap, base_id: int, oid: str, want: dict,
                 shards=None) -> list:
    """The shards of `oid` (or those in `shards`) whose holder's file
    differs from `want` ({shard: (sha256, crc, crc_prefix, size)}), read
    with `dump_shard` over each holder's admin socket."""
    from ceph_tpu_torch.utils.admin_socket import admin_command
    pgid = osdmap.object_to_pg(base_id, oid)
    acting = osdmap.pg_to_up_acting_osds(pgid)[1]
    bad = []
    for shard in (range(len(acting)) if shards is None else shards):
        got = admin_command(cluster.asok(f"osd.{acting[shard]}"), {
            "prefix": "dump_shard", "pgid": str(pgid),
            "oid": f"{oid}.s{shard}"})
        h = got.get("hinfo") or {}
        if (got.get("sha256"), h.get("crc"), h.get("crc_prefix"),
                h.get("size")) != want[shard]:
            bad.append(shard)
    return bad


def shard_digests(payload: bytes, coding, native, crc_mod) -> dict:
    """{shard: (sha256, crc, crc_prefix, size)} of the host oracle's
    shard files of `payload` and their HashInfo."""
    allc = shard_oracle(payload, coding, native, crc_mod)
    full = len(payload) // (K * CLUSTER_UNIT)
    out = {}
    for shard in range(K + M):
        want = allc[:, shard].tobytes()
        out[shard] = (hashlib.sha256(want).hexdigest(),
                      crc_mod.crc32c(0, want),
                      crc_mod.crc32c(0, want[:full * CLUSTER_UNIT]),
                      len(payload))
    return out


def osds_command(cluster, osds, cmd: dict) -> dict:
    """One admin-socket command on every OSD in `osds`, concurrently;
    {osd: answer}.  Raises on an answer with an error."""
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.utils.admin_socket import admin_command
    with ThreadPoolExecutor(len(osds)) as pool:
        got = dict(zip(osds, pool.map(
            lambda i: admin_command(cluster.asok(f"osd.{i}"), cmd), osds)))
    bad = {i: a for i, a in got.items()
           if isinstance(a, dict) and "error" in a}
    if bad:
        raise AssertionError(f"{cmd['prefix']}: {bad}")
    return got


def codecs_on_card(cluster) -> None:
    """No OSD reports an EC codec degraded to the host (mon health)."""
    rv, out, _ = cluster.admin.mon_command({"prefix": "health"})
    if rv != 0 or "EC device degraded" in out:
        raise AssertionError(f"health: {rv} {out}")


def phase_doors_daemons(cluster, rng, live: list, victim2: int,
                        pool14: int, doors10=None) -> dict:
    """Phase 15 (see the module docstring) on phase 14's cluster, `live`
    its OSDs up; `victim2` phase 14's second killed OSD.  Adds the MDS
    and the RGW to `cluster` (its stop() stops them) and returns the
    phase's figures beside phase 10's (`doors10`, None when phase 10
    did not run)."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.erasure.registry import registry
    from ceph_tpu_torch.ops import crc32c as crc_mod
    t_start = time.perf_counter()
    setup = {}
    # the second victim started again, its MemStore empty: 12 OSDs in.
    # With 11 in, CRUSH leaves a hole in some PG of a k+m = 11 pool
    t0 = time.perf_counter()
    setup["restart_boot_s"] = cluster.start_daemon(f"osd.{victim2}", None)
    live.append(victim2)
    cluster.wait_osds(lambda m: m.is_up(victim2), CLUSTER_TIMEOUT,
                      f"osd.{victim2} up again")
    cluster.wait_clean(pool14, CLUSTER_PG_NUM, CLUSTER_RECOVERY_TIMEOUT)
    setup["restart_clean_s"] = time.perf_counter() - t0
    settings = {"target_max_objects": str(DOORS_TARGET_MAX_OBJECTS),
                **DOORS_HIT_SET}
    setup.update(doors_pools_cli(cluster, DOORS_PROFILE_NAME,
                                 DOORS_PROFILE, DOORS_PG_NUM,
                                 DOORS_META_PG_NUM, settings))
    osdmap = cluster.osdmap()
    base_id = osdmap.pool_by_name(DOORS_POOL).id
    port = free_port()
    boot = start_doors_daemons(cluster, port, card_used_mib)
    # the flushes' encodes, the degraded promotes' decodes, the scrub
    # CRC of small and whole-object shards
    t0 = time.perf_counter()
    warm = ec_warm(cluster, live, DOORS_POOL,
                   (CLUSTER_UNIT, DOORS_OBJECT_BYTES // K))
    setup["warm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    doors = DoorProcs(cluster.conf_path, port, SEED)
    try:
        doors.setup()
        setup["clients_s"] = time.perf_counter() - t0
        coding = registry.factory("tpu", {
            k: v for k, v in DOORS_PROFILE.items()
            if k != "plugin"}).coding_matrix
        emit("doors_daemons_setup", osds=len(live), restarted=victim2,
             base=DOORS_POOL, tier=DOORS_HOT, pg_num=DOORS_PG_NUM,
             tier_settings=settings,
             s3=[S3_CLIENTS, S3_OBJECTS, S3_OBJECT_BYTES],
             rbd=[RBD_CLIENTS, RBD_IMAGE_BYTES, RBD_ORDER],
             cephfs=[FS_CLIENTS, FS_FILES, FS_FILE_BYTES],
             setup=setup, boot=boot,
             warm_shapes=warm["shapes"],
             elapsed_s=time.perf_counter() - t_start)
        out = {"setup": setup, "boot": boot}
        hot = cluster.admin.open_ioctx(DOORS_HOT)

        def tier_data():
            return set(hot.list_objects()) & set(objects)

        # -- window 1: writes ----------------------------------------------
        before = osd_counters(cluster, live)
        writes = doors.run("write")
        d_write = daemons_window(cluster, live, before, "doors writes", ())
        codecs_on_card(cluster)
        objects = doors.objects()
        want = {oid: shard_digests(body, coding, native, crc_mod)
                for oid, body in objects.items()}

        # -- window 2: flush, until the base holds every object ------------
        before = osd_counters(cluster, live)
        t0 = time.perf_counter()
        pending = set(objects)
        while pending:           # shard 0, as each flush lands
            osdmap = cluster.osdmap()
            pending = {o for o in pending if doors_shards(
                cluster, osdmap, base_id, o, want[o], shards=[0])}
            if pending:
                if time.perf_counter() - t0 > DOORS_TIMEOUT:
                    raise TimeoutError(f"flush: {sorted(pending)[:8]}")
                time.sleep(0.25)
        while True:              # then every shard of every object
            osdmap = cluster.osdmap()
            bad = {o: b for o in objects
                   if (b := doors_shards(cluster, osdmap, base_id, o,
                                         want[o]))}
            if not bad:
                break
            if time.perf_counter() - t0 > DOORS_TIMEOUT:
                raise AssertionError(f"base shards != oracle: {bad}")
            time.sleep(0.25)
        flush_s = time.perf_counter() - t0
        d_flush = daemons_window(cluster, live, before, "doors flush", ())
        codecs_on_card(cluster)
        enc = d_write["dev_dispatches_enc"] + d_flush["dev_dispatches_enc"]
        if not enc:
            raise AssertionError("doors writes and flush: no device encode")
        step = dict(write=writes, write_window=d_write, flush_s=flush_s,
                    flush_window=d_flush, data_objects=len(objects),
                    shards_checked_objects=len(objects),
                    elapsed_s=time.perf_counter() - t_start)
        emit("doors_daemons_flush", **step)
        out.update(step)

        # -- window 3: promote -----------------------------------------------
        evict_s = wait_for(lambda: not tier_data(), DOORS_TIMEOUT,
                           "tier evict")
        osds_command(cluster, live, {"prefix": "cache drop"})
        before = osd_counters(cluster, live)
        reads = doors.run("read")
        d_prom = daemons_window(cluster, live, before, "doors promote", ())
        codecs_on_card(cluster)
        doors.check_sizes()
        step = dict(read=reads, promote_gbs=reads["gbs"], evict_s=evict_s,
                    promote_window=d_prom,
                    elapsed_s=time.perf_counter() - t_start)
        emit("doors_daemons_promote", **step)
        out.update(step)

        # -- window 4: deep scrub of the base ----------------------------------
        osds_command(cluster, live, {"prefix": "cache drop"})
        before = osd_counters(cluster, live)
        s_wall, results = deep_scrub_procs(cluster, base_id, CLUSTER_TIMEOUT)
        bad = {p: r for p, r in results.items() if r["inconsistent"]}
        if bad:
            raise AssertionError(f"doors deep scrub: {bad}")
        d_scrub = daemons_window(cluster, live, before, "doors deep scrub",
                                 ("crc",))
        codecs_on_card(cluster)
        step = dict(scrub_gbs=len(objects) * DOORS_OBJECT_BYTES * (K + M)
                    / K / s_wall / 1e9, scrub_s=s_wall,
                    scrub_checked=sum(r["checked"] for r in results.values()),
                    scrub_window=d_scrub,
                    elapsed_s=time.perf_counter() - t_start)
        emit("doors_daemons_scrub", **step)
        out.update(step)

        # -- window 5: degraded promote ----------------------------------------
        osdmap = cluster.osdmap()
        holders = sorted({o for oid in objects for o in
                          osdmap.pg_to_up_acting_osds(osdmap.object_to_pg(
                              base_id, oid))[1] if o in live})
        victim = holders[int(rng.integers(len(holders)))]
        down_s = kill_and_wait_down(cluster, victim,
                                    float(CLUSTER_CONF["osd_heartbeat_grace"]))
        live.remove(victim)
        evict2_s = wait_for(lambda: not tier_data(), DOORS_TIMEOUT,
                            "tier evict after the kill")
        osds_command(cluster, live, {"prefix": "cache drop"})
        before = osd_counters(cluster, live)
        reads = doors.run("read")
        d_deg = daemons_window(cluster, live, before,
                               "doors degraded promote", ("dec",))
        codecs_on_card(cluster)
        step = dict(degraded_read=reads, degraded_promote_gbs=reads["gbs"],
                    victim3=victim, marked_down3_s=down_s,
                    evict2_s=evict2_s, degraded_promote_window=d_deg,
                    elapsed_s=time.perf_counter() - t_start)
        emit("doors_daemons_degraded_promote", **step)
        out.update(step)
    finally:
        doors.close()
    out["beside_phase10"] = doors_beside(doors10, out)
    emit("doors_daemons_vs_one_process", **out["beside_phase10"])
    return out


def wait_for(pred, timeout: float, what: str) -> float:
    """Poll `pred` on the real clock; returns the seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(what)
        time.sleep(0.25)
    return time.perf_counter() - t0


def doors_beside(doors10, doors15) -> dict:
    """Phase 10's and phase 15's door figures side by side: per door
    write and read GB/s with op p50/p99, flush s, promote, scrub and
    degraded-promote GB/s (phase 10: None where it did not run)."""
    def rates(win):
        return {k: [v["gbs"], v["lat_ms"]["p50"], v["lat_ms"]["p99"]]
                for k, v in win.items() if isinstance(v, dict)}

    one = doors10 or {}
    rows = {"one_process": None if doors10 is None else {
                "write": rates(one["flush"]["write"]),
                "promote_read": rates(one["promote"]["read"]),
                "flush_s": one["flush"]["flush_s"],
                "promote_gbs": one["promote"]["promote_gbs"],
                "scrub_gbs": one["scrub"]["scrub_gbs"],
                "degraded_promote_gbs": one["degraded"][
                    "degraded_promote_gbs"]},
            "processes": {
                "write": rates(doors15["write"]),
                "promote_read": rates(doors15["read"]),
                "flush_s": doors15["flush_s"],
                "promote_gbs": doors15["promote_gbs"],
                "scrub_gbs": doors15["scrub_gbs"],
                "degraded_promote_gbs": doors15["degraded_promote_gbs"]}}
    return rows


def run_daemons_phase(rng, doors10=None) -> dict:
    """Phases 14, 15 and 17 with this process's card memory released
    first; prints the kernel launches each phase's counted windows made
    in the OSD processes (each OSD's perf dump).  Every kernel entry
    point must launch in phase 15."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = phase_daemons(rng, doors10)

    def launched(result, windows) -> dict:
        launches = {}
        for w in windows:
            for name, k in window_launches(result[w]).items():
                launches[name] = launches.get(name, 0) + k
        return launches

    emit("daemons_launches", launches=launched(out, (
        "write_window", "scrub_window", "degraded_window",
        "recovery_window", "degraded2_window")))
    doors = launched(out["doors"], (
        "write_window", "flush_window", "promote_window", "scrub_window",
        "degraded_promote_window"))
    emit("doors_daemons_launches", launches=doors)
    idle = [name for name in KERNEL_META if doors.get(name, 0) < 1]
    if idle:
        raise AssertionError(f"phase 15 launched no {idle}")
    plugins = {}
    for name, pool in out["plugins"]["pools"].items():
        plugins[name] = {w: pool[k] for w, k in (
            ("write", "write_launches"), ("scrub", "scrub_launches"))}
        plugins[name]["degraded_read"] = pool["degraded_read"]["launches"]
    plugins["recovery"] = out["plugins"]["recovery_launches"]
    emit("plugin_pools_launches", launches=plugins)
    return out


# -- phase 16: BASELINE.md configs #1-#5 through the port's codecs ---------

# (BASELINE.md config, plugin, profile, (stripes, chunk bytes)): bench.py's
# rows of bench_other_configs, config #1 its batched one, config #2 the
# main path's (32, 8, 1 MiB); stripes None: one (k, chunk) stripe
PLUGIN_CONFIGS = (
    (1, "jerasure", {"k": "2", "m": "1", "technique": "reed_sol_van"},
     (128, 4096)),
    (2, "isa", {"k": "8", "m": "3", "technique": "reed_sol_van"},
     (B_MAIN, L_MAIN)),
    (3, "jerasure", {"k": "6", "m": "3", "technique": "cauchy_good",
                     "packetsize": "32"}, (None, 1 << 20)),
    (4, "shec", {"k": "8", "m": "4", "c": "3"}, (None, 1 << 20)),
    (5, "lrc", {"k": "4", "m": "2", "l": "3"}, (None, 1 << 20)),
)
PLUGIN_PATTERNS = 16          # seeded erasure patterns of m chunks
PLUGIN_HOST_RUNS = 3          # host oracle timing runs (median)
PLUGIN_DECODE_CHUNK = 1 << 20  # decodes: the shard layout up to this


def routing_samples(be) -> dict:
    """{"dev": n, "host": n}: a TorchBackend's routing samples."""
    out = {"dev": 0, "host": 0}
    for (path, _b), ent in list(be._perf.items()):
        out[path] += ent["n"]
    return out


def erasure_patterns(codec, rng) -> list:
    """Every erasure of one chunk and of two (where m >= 2), and
    PLUGIN_PATTERNS seeded ones of m chunks (where m > 2), each kept
    only where the codec's minimum_to_decode accepts it (shec and lrc
    recover some patterns only)."""
    import itertools
    from ceph_tpu_torch.erasure.interface import ErasureCodeError
    n = codec.get_chunk_count()
    m = n - codec.get_data_chunk_count()

    def recoverable(lost) -> bool:
        try:
            codec.minimum_to_decode(lost, [i for i in range(n)
                                           if i not in lost])
        except ErasureCodeError:
            return False
        return True

    out = [list(c) for r in (1, 2) if r <= m
           for c in itertools.combinations(range(n), r)
           if recoverable(list(c))]
    drawn: set = set()
    for _ in range(100 * PLUGIN_PATTERNS if m > 2 else 0):
        lost = tuple(sorted(int(i) for i in rng.choice(n, m, replace=False)))
        if lost not in drawn and recoverable(list(lost)):
            drawn.add(lost)
            if len(drawn) == PLUGIN_PATTERNS:
                break
    return out + [list(p) for p in sorted(drawn)]


def plugin_codecs(registry, plugin: str, profile: dict):
    """(codec on the device path, host oracle) of one profile: the first
    with its TorchBackend pinned to the device (host_cutover 1 on the
    instance), the second built with the profile's `backend=host`."""
    dev = registry.factory(plugin, dict(profile))
    host = registry.factory(plugin, {**profile, "backend": "host"})
    be = dev.device_backend()
    if be is None or host.device_backend() is not None:
        raise AssertionError(f"{plugin} {profile}: device backend {be}, "
                             f"host oracle's {host.device_backend()}")
    be.HOST_CUTOVER_BYTES = 1
    return dev, host


def phase_plugins(rng, registry, cuda_ec, tally) -> list:
    """Phase 16 (see the module docstring); returns each config's line.
    Each config's ops run with the launch counts set to 0 just before
    and read just after, warm-ups excluded, and are added to `tally`."""
    rows = []
    for config, plugin, profile, (S, L) in PLUGIN_CONFIGS:
        t_start = time.perf_counter()
        dev, host = plugin_codecs(registry, plugin, profile)
        be = dev.device_backend()
        k, n = dev.get_data_chunk_count(), dev.get_chunk_count()
        data = rng.integers(0, 256, (k, L) if S is None else (S, k, L),
                            dtype=np.uint8)
        # decodes: chunk i of the first stripes, up to PLUGIN_DECODE_CHUNK
        # (all 128 of #1's 4 KiB stripes, the first of #2's)
        stripes = max(1, min(S or 1, PLUGIN_DECODE_CHUNK // L))
        chunk = L * stripes
        patterns = erasure_patterns(dev, rng)
        # every device shape of the ops below warm before the counts: the
        # encode's (the batch's first of device_shapes), the decodes'
        encode = dev.stripe_encode_shapes(L) if S is None \
            else dev.device_shapes([S], L)[:1]
        warm = encode + dev.decode_shapes(
            chunk, sorted({len(p) for p in patterns}))
        warm_s = sum(wait_warm(lambda s=s: s.backend.device_fn_if_ready(
            s.kind, s.matrix, s.extra, s.shape), f"config #{config} "
            f"{s.kind} {s.shape}") for s in warm)

        torch.cuda.synchronize()
        cuda_ec.reset_launches()
        before = routing_samples(be)
        parity = np.asarray(dev.encode_chunks(data))
        want = np.asarray(host.encode_chunks(data))
        if not np.array_equal(parity, want):
            raise AssertionError(f"config #{config}: device encode != "
                                 f"host oracle")
        enc = time_ms(lambda x: dev.encode_chunks(x), [data] * TIMED_RUNS)
        allc = np.concatenate([data, parity], axis=-2)
        if S is not None:
            allc = allc[:stripes]
        chunks = [np.ascontiguousarray(allc[..., i, :]).reshape(-1)
                  for i in range(n)]
        for lost in patterns:
            have = {i: c for i, c in enumerate(chunks) if i not in lost}
            got = dev.decode(lost, have, chunk)
            bad = [c for c in lost if not np.array_equal(got[c], chunks[c])]
            if bad:
                raise AssertionError(f"config #{config}: decode of {lost} "
                                     f"rebuilt {bad} wrong")
        lost0 = patterns[0]
        have0 = {i: c for i, c in enumerate(chunks) if i not in lost0}
        dec = time_ms(lambda h: dev.decode(lost0, h, chunk),
                      [have0] * TIMED_RUNS)
        torch.cuda.synchronize()
        launches = cuda_ec.launch_counts()
        after = routing_samples(be)
        routed = {p: after[p] - before[p] for p in after}
        if routed["host"]:
            raise AssertionError(f"config #{config}: {routed['host']} "
                                 f"calls served by the host")
        # gf_encode runs the byte matrices; packets stay plain PyTorch
        kernel = encode[0].kind
        want_launches = dict.fromkeys(launches, 0)
        if kernel == "bytes":
            want_launches["gf_encode"] = routed["dev"]
        if launches != want_launches or not routed["dev"]:
            raise AssertionError(f"config #{config}: launches {launches}, "
                                 f"want {want_launches} (device calls "
                                 f"{routed['dev']})")
        for name, k_ in launches.items():
            tally[name] += k_
        host_enc = host_ms(lambda: host.encode_chunks(data), PLUGIN_HOST_RUNS)
        host_dec = host_ms(lambda: host.decode(lost0, have0, chunk),
                           PLUGIN_HOST_RUNS)
        row = dict(
            config=config, plugin=plugin, profile=profile,
            shape=list(data.shape), chunk_bytes=chunk, kind=kernel,
            patterns=len(patterns), tolerance=0, max_abs_err=0,
            encode={"ms": enc["ms"], "b2b_ms": enc["b2b_ms"],
                    "gbs": data.nbytes / enc["ms"] / 1e6},
            decode={"lost": lost0, "ms": dec["ms"], "b2b_ms": dec["b2b_ms"],
                    "gbs": k * chunk / dec["ms"] / 1e6,
                    "route": "dev" if dev.decode_shapes(
                        chunk, [len(lost0)]) else "host"},
            host_oracle_cpu_ms={"encode": host_enc, "decode": host_dec,
                                "note": "host clock, this machine's CPU, "
                                "native AVX2 GF kernels"},
            routed_calls=routed, launches=launches, warm_s=warm_s,
            note="ms: CUDA events around the codec call (numpy in and "
            f"out: H2D, kernel, D2H), median of {TIMED_RUNS}",
            elapsed_s=time.perf_counter() - t_start)
        emit("plugin_codec", **row)
        rows.append(row)
    return rows


# -- phase 17: the five configs as EC pools of phase 14's process cluster --

PLUGIN_POOL_PG_NUM = 16
PLUGIN_POOL_OBJECTS = 16             # 4 MiB each, per pool
PLUGIN_POOL_SAMPLE = 8               # objects whose shards are checked
PLUGIN_POOL_TAG = 40                 # object_payload tags: 40, 42, ...
PLUGIN_QUIET_S = 3.0                 # counters still: nothing rebuilding
PLUGIN_POOL_TIMEOUT = 180.0          # a new pool clean


def plugin_shard_digests(codec, sinfo, payload: bytes) -> dict:
    """{shard: (sha256, crc, crc_prefix, size)} of `payload`'s shard files
    and HashInfo as the host oracle `codec` encodes them at `sinfo`."""
    from ceph_tpu_torch.ops import crc32c as crc_mod
    from ceph_tpu_torch.osd import ecutil
    shards, _crcs = ecutil.encode_object_ex(codec, sinfo, payload)
    full = len(payload) // sinfo.stripe_width * sinfo.chunk_size
    out = {}
    for i, mv in enumerate(shards):
        b = bytes(mv)
        out[i] = (hashlib.sha256(b).hexdigest(), crc_mod.crc32c(0, b),
                  crc_mod.crc32c(0, b[:full]), len(payload))
    return out


def settle(cluster, live, timeout: float) -> float:
    """Until every PG of every pool is active+clean and the OSDs'
    counters stood still for PLUGIN_QUIET_S (a restarted OSD's shards
    rebuilt: the PG map reads clean once its members are up); returns
    the seconds until the last change."""
    t0 = time.perf_counter()
    for pool in cluster.osdmap().pools.values():
        cluster.wait_clean(pool.id, pool.pg_num, timeout)
    last, changed = osd_counters(cluster, live), time.perf_counter()
    while time.perf_counter() - changed < PLUGIN_QUIET_S:
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"counters still moving after {timeout} s")
        time.sleep(0.25)
        now = osd_counters(cluster, live)
        if now != last:
            last, changed = now, time.perf_counter()
    return changed - t0


def shards_landed(cluster, osd: int, osdmap, pool_id: int, lost: dict,
                  shard_bytes: int, size: int) -> int:
    """How many of `lost` ({object index: shard}) osd.<osd> holds whole:
    the shard file at `shard_bytes` with a HashInfo of the object's
    `size` (`dump_shard` over its admin socket)."""
    from ceph_tpu_torch.utils.admin_socket import admin_command
    n = 0
    for i, shard in lost.items():
        pgid = osdmap.object_to_pg(pool_id, f"obj{i}")
        got = admin_command(cluster.asok(f"osd.{osd}"), {
            "prefix": "dump_shard", "pgid": str(pgid),
            "oid": f"obj{i}.s{shard}"})
        n += (got.get("bytes") == shard_bytes
              and (got.get("hinfo") or {}).get("size") == size)
    return n


def pool_routing(cluster, osds, profile_name: str) -> dict:
    """The pool codec's measured routing summed over the OSDs' perf
    dumps: device and host samples, and each OSD's crossover_bytes."""
    out = {"dev": 0, "host": 0, "crossover_bytes": {}}
    for i in osds:
        codec = cluster.perf(f"osd.{i}")["ec_codecs"].get(profile_name, {})
        for key, ent in codec.get("routing", {}).items():
            path = key.split(":")[0]
            if path in ("dev", "host"):
                out[path] += ent["n"]
        if "crossover_bytes" in codec:
            out["crossover_bytes"][i] = codec["crossover_bytes"]
    return out


def burst_pools(cluster, live: list, pools) -> dict:
    """Each (config, plugin, profile, name) of `pools` as a profile and
    an EC pool, every command sent back to back; then the mon's osdmap
    polled until every pool is clean.  Fails if the map shows an OSD of
    `live` down at any poll, or the cluster log has an OSD marked down
    after the first command.  Returns the maps of the burst and of the
    whole window, and the seconds."""
    t0, stamp = time.perf_counter(), time.time()
    first = cluster.osdmap().epoch
    for _config, plugin, profile, name in pools:
        cli(cluster, "osd", "erasure-code-profile", "set", name,
            f"plugin={plugin}", *(f"{k}={v}" for k, v in profile.items()))
        cli(cluster, "osd", "pool", "create", name,
            str(PLUGIN_POOL_PG_NUM), str(PLUGIN_POOL_PG_NUM), "erasure",
            name)
    sent_s = time.perf_counter() - t0
    burst_maps = cluster.osdmap().epoch - first
    polls = 0
    while True:
        polls += 1
        osdmap = cluster.osdmap()
        down = [i for i in live if not osdmap.is_up(i)]
        if down:
            raise AssertionError(f"osds {down} marked down in the burst of "
                                 f"pools, epoch {osdmap.epoch}")
        rv, out, data = cluster.admin.mon_command({"prefix": "pg dump"})
        if rv != 0:
            raise AssertionError(f"pg dump: {rv} {out}")
        states = json.loads(data)
        if all(len([st for pgid, st in states.items()
                    if pgid.split(".")[0] == str(pool.id)
                    and st.get("state") == "active+clean"])
               == PLUGIN_POOL_PG_NUM for pool in (
                   osdmap.pool_by_name(p[3]) for p in pools)):
            break
        if time.perf_counter() - t0 > PLUGIN_POOL_TIMEOUT:
            raise TimeoutError(f"the burst's pools not clean in "
                               f"{PLUGIN_POOL_TIMEOUT} s")
        time.sleep(0.25)
    rv, out, _ = cluster.admin.mon_command({"prefix": "log last",
                                            "num": 10000})
    marked = [line for line in out.splitlines()
              if "marked down" in line and float(line.split()[0]) >= stamp]
    if rv != 0 or marked:
        raise AssertionError(f"OSDs marked down in the burst: {rv} {marked}")
    return {"maps": burst_maps, "window_maps": osdmap.epoch - first,
            "sent_s": sent_s, "clean_s": time.perf_counter() - t0,
            "polls": polls}


def phase_plugin_pools(cluster, rng, live: list, out_osd: int,
                       down_osd: int) -> dict:
    """Phase 17 (see the module docstring) on phase 14's cluster, `live`
    its OSDs up; `out_osd` phase 14's killed and out-marked OSD,
    `down_osd` phase 15's killed one."""
    from ceph_tpu_torch.erasure.registry import registry
    from ceph_tpu_torch.osd.backend_ec import pool_stripe_info
    t_start = time.perf_counter()
    n, nbytes = PLUGIN_POOL_OBJECTS, CLUSTER_OBJECT_BYTES
    grace = float(CLUSTER_CONF["osd_heartbeat_grace"])
    setup = {}
    # phases 14-15's victims started again (their MemStores empty) and
    # the out one marked in: 13 OSDs up and in, phases 14-15's pools
    # backfilled onto them before the new pools exist
    t0 = time.perf_counter()
    names = [f"osd.{v}" for v in (down_osd, out_osd)]
    for name in names:
        cluster.spawn(name, cluster.args[name])
    cluster.wait_up(names, DAEMONS_BOOT_TIMEOUT)
    setup["boot_s"] = time.perf_counter() - t0
    live += [down_osd, out_osd]
    cli(cluster, "osd", "in", str(out_osd))
    cluster.wait_osds(lambda m: all(m.is_up(i) and m.is_in(i)
                                    for i in range(CLUSTER_OSDS)),
                      CLUSTER_TIMEOUT, "every OSD up and in")
    setup["rebuilt_s"] = settle(cluster, live, CLUSTER_RECOVERY_TIMEOUT)
    setup["restart_s"] = time.perf_counter() - t0
    # profiles and pools through the CLI, back to back: a burst of ten
    # maps, polled until every pool is clean with no OSD marked down.
    # Each profile is validated by instantiating its plugin in the mon,
    # which must not touch the card
    t0 = time.perf_counter()
    mib_before = card_used_mib()
    pools = [(config, plugin, profile, f"plugin{config}")
             for config, plugin, profile, _shape in PLUGIN_CONFIGS]
    burst = burst_pools(cluster, live, pools)
    osdmap = cluster.osdmap()
    setup["pools_s"] = time.perf_counter() - t0
    setup["burst"] = burst
    setup["mon_mgr_card_mib"] = card_used_mib() - mib_before
    if setup["mon_mgr_card_mib"] > 0:
        raise AssertionError(f"card memory rose {setup['mon_mgr_card_mib']}"
                             f" MiB while the mons validated the profiles")
    emit("plugin_pools_setup", gpu=gpu_identity(), osds=len(live),
         restarted=[down_osd, out_osd],
         pools=[p[3] for p in pools], pg_num=PLUGIN_POOL_PG_NUM,
         objects=n, object_bytes=nbytes, clients=CLUSTER_CLIENTS, **setup,
         elapsed_s=time.perf_counter() - t_start)

    out = {"setup": setup, "pools": {}}
    sample = sorted(int(i) for i in rng.choice(n, PLUGIN_POOL_SAMPLE,
                                               replace=False))
    items = [(f"obj{i}", i, nbytes, 0) for i in range(n)]
    clients = ClientProcs(cluster.conf_path, pools[0][3], CLUSTER_CLIENTS,
                          SEED)
    try:
        want: dict = {}
        shard_sizes: dict = {}
        for j, (config, plugin, profile, name) in enumerate(pools):
            t_pool = time.perf_counter()
            tag = PLUGIN_POOL_TAG + 2 * j
            pool = osdmap.pool_by_name(name)
            oracle = registry.factory(plugin, {**profile, "backend": "host"})
            sinfo = pool_stripe_info(osdmap, pool, oracle)
            shard = shard_sizes[name] = \
                sinfo.logical_size_to_shard_size(nbytes)
            warm = ec_warm(cluster, live, name, (shard,))
            # -- window: writes, read back -----------------------------------
            before = osd_counters(cluster, live)
            w_wall, w_lat = clients.run("write", items, tag=tag, pool=name)
            d_write = counters_delta(before, osd_counters(cluster, live))
            r_wall, r_lat = clients.run("read", items, tag=tag, pool=name)
            want[name] = {i: plugin_shard_digests(
                oracle, sinfo, object_payload(SEED, i, nbytes, tag))
                for i in sample}
            bad = {i: b for i in sample if (b := doors_shards(
                cluster, osdmap, pool.id, f"obj{i}", want[name][i]))}
            if bad:
                raise AssertionError(f"{name}: shards != host oracle {bad}")
            if config in (1, 2) and \
                    window_launches(d_write).get("gf_encode", 0) < 1:
                raise AssertionError(f"{name}: no gf_encode launch in the "
                                     f"write window: {d_write}")
            # -- window: deep scrub ------------------------------------------
            before = osd_counters(cluster, live)
            s_wall, results = deep_scrub_procs(cluster, pool.id,
                                               CLUSTER_TIMEOUT)
            d_scrub = counters_delta(before, osd_counters(cluster, live))
            bad = {p: r for p, r in results.items() if r["inconsistent"]}
            crc = window_launches(d_scrub)
            if bad or not (crc.get("crc32c_segments") and
                           crc.get("crc32c_chain")):
                raise AssertionError(f"{name} deep scrub: {bad}, "
                                     f"launches {crc}")
            row = dict(
                config=config, plugin=plugin, profile=profile,
                stripe_unit=sinfo.chunk_size, shard_bytes=shard,
                ec_warm=warm,
                write_gbs=n * nbytes / w_wall / 1e9,
                write_lat_ms=percentiles_ms(w_lat),
                read_gbs=n * nbytes / r_wall / 1e9,
                read_lat_ms=percentiles_ms(r_lat),
                shards_checked_objects=len(sample),
                write_launches=window_launches(d_write),
                write_host_dispatches=d_write["host_dispatches"],
                scrub_s=s_wall, scrub_checked=sum(
                    r["checked"] for r in results.values()),
                scrub_launches=crc,
                scrub_host_dispatches=d_scrub["host_dispatches"],
                routing=pool_routing(cluster, live, name),
                elapsed_s=time.perf_counter() - t_pool)
            emit("plugin_pool", pool=name, **row)
            out["pools"][name] = row

        # -- a process death: degraded reads, restart, recovery ----------------
        victim = sorted(live)[int(rng.integers(len(live)))]
        lost = {name: lost_shards(osdmap, osdmap.pool_by_name(name).id,
                                  victim, n) for *_x, name in pools}
        down_s = kill_and_wait_down(cluster, victim, grace)
        live.remove(victim)
        degraded = {}
        for j, (*_x, name) in enumerate(pools):
            before = osd_counters(cluster, live)
            wall, lat = clients.run("read", items,
                                    tag=PLUGIN_POOL_TAG + 2 * j, pool=name)
            d = counters_delta(before, osd_counters(cluster, live))
            degraded[name] = {"gbs": n * nbytes / wall / 1e9,
                              "lat_ms": percentiles_ms(lat),
                              "launches": window_launches(d),
                              "host_dispatches": d["host_dispatches"]}
            out["pools"][name]["degraded_read"] = degraded[name]
        before = osd_counters(cluster, live)
        t0 = time.perf_counter()
        cluster.start_daemon(f"osd.{victim}", None)
        live.append(victim)
        # recovery: until the restarted OSD holds every shard it lost
        while sum(shards_landed(
                cluster, victim, osdmap, osdmap.pool_by_name(name).id,
                lost[name], shard_sizes[name], nbytes)
                for *_x, name in pools) < sum(len(v) for v in lost.values()):
            if time.perf_counter() - t0 > CLUSTER_RECOVERY_TIMEOUT:
                raise TimeoutError(f"osd.{victim}: lost shards not rebuilt")
            time.sleep(0.25)
        recovery_s = time.perf_counter() - t0
        all_s = settle(cluster, live, CLUSTER_RECOVERY_TIMEOUT)
        d_rec = counters_delta(before, osd_counters(cluster, live))
        # the restarted OSD's shards rebuilt: the sample against the
        # oracle again
        t0 = time.perf_counter()
        osdmap = cluster.osdmap()
        for *_x, name in pools:
            pool_id = osdmap.pool_by_name(name).id
            for i in sample:
                while bad := doors_shards(cluster, osdmap, pool_id,
                                          f"obj{i}", want[name][i]):
                    if time.perf_counter() - t0 > CLUSTER_RECOVERY_TIMEOUT:
                        raise AssertionError(f"{name} obj{i}: shards {bad} "
                                             f"!= host oracle after "
                                             f"recovery")
                    time.sleep(0.25)
        step = dict(victim=victim, marked_down_s=down_s,
                    lost_shards={k: len(v) for k, v in lost.items()},
                    degraded=degraded, recovery_s=recovery_s,
                    all_pools_settled_s=all_s,
                    routing_after={name: pool_routing(cluster, live, name)
                                   for *_x, name in pools},
                    recovery_launches=window_launches(d_rec),
                    recovery_pushes=d_rec["recovery_pushes"],
                    elapsed_s=time.perf_counter() - t_start)
        emit("plugin_pools_recovery", **step)
        out.update(step)
    finally:
        clients.close()
    return out


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
    ap.add_argument("--daemons-only", action="store_true",
                    help="build the kernels and run phases 14, 15 and 17 "
                    "alone (phase 9's cluster as mon, OSD and mgr "
                    "processes, phase 10's doors on it with the MDS and "
                    "RGW as processes, then BASELINE.md configs #1-#5 as "
                    "EC pools on it)")
    ap.add_argument("--plugins-only", action="store_true",
                    help="build the kernels and run phase 16 alone "
                    "(BASELINE.md configs #1-#5 through the port's "
                    "jerasure, isa, shec and lrc codecs)")
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
    if args.daemons_only:
        run_daemons_phase(np.random.default_rng(SEED))
        print(ident, flush=True)
        return 0
    if args.plugins_only:
        counts = dict.fromkeys(cuda_ec.launches, 0)
        phase_plugins(np.random.default_rng([SEED, 16]), registry, cuda_ec,
                      counts)
        emit("plugins_only_launches", launches=counts)
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
    step, cluster = phase_cluster(rng, cuda_ec, ec_pipeline, hbm_cache,
                                  native, crc_mod, device, counts)
    doors10 = phase_doors(cluster, step["victim"], rng, cuda_ec,
                          ec_pipeline, hbm_cache, native, crc_mod, device,
                          counts)
    phase_mesh(rng, device, cuda_ec, ec_kernels, gf, registry, native,
               crc_mod, ec_pipeline, ecutil, counts)
    phase_tools(rng, cuda_ec, ec_pipeline, device, counts)
    # its own generator: phases 14-17 draw their victims from `rng` as
    # they did before phase 16 existed
    phase_plugins(np.random.default_rng([SEED, 16]), registry, cuda_ec,
                  counts)
    by_source = {src: sum(n for name, n in counts.items()
                          if name.startswith(src)) for src in cuda_ec.SOURCES}
    emit("main_path_launches", launches=counts, by_source=by_source)
    idle = [n for n in KERNEL_META if counts[n] < 1]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    phase_reference_suite(cuda_ec, ec_pipeline, hbm_cache, device)
    run_daemons_phase(rng, doors10)

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
