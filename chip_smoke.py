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
     to the device): fused encode+CRC and a three-erasure rebuild,
     checked against the host oracle (native GF + CRC32C);
  4. the object path: ecutil.encode_object / decode_object of a seeded
     64 MiB payload at 1 MiB and at the default 4 KiB stripe unit.

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
    got = dict(cuda_ec.launches)
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


def phase_codec(rng, registry, native, crc_mod, cuda_ec, tally):
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

    d2h0 = be.bytes_d2h
    t0 = time.perf_counter()
    allc, crcs = counted(cuda_ec, tally, ENCODE_LAUNCHES, "codec encode",
                         lambda: codec.encode_stripes_with_crcs(stripes))
    enc_s = time.perf_counter() - t0
    d2h = be.bytes_d2h - d2h0
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
         encode_gbs=stripes.nbytes / enc_s / 1e9,
         decode_gbs=surv.nbytes / dec_s / 1e9,
         note="host clock, includes H2D of inputs and D2H of outputs")
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


# the kernels of the main path (crc32c_segments, the scrub CRC of rows
# alone, is not on it: phase 2 holds and times it)
KERNEL_META = {
    "gf_encode": ("ceph_tpu_torch/csrc/gf_encode.cu",
                  "ceph_tpu/ops/pallas_ec.py:55"),
    "gf_encode_crc": ("ceph_tpu_torch/csrc/gf_encode.cu",
                      "ceph_tpu/ops/pallas_ec.py:55"),
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
    from ceph_tpu_torch.ops import cuda_ec, ec_kernels, gf
    from ceph_tpu_torch.osd import ecutil

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
    codec = phase_codec(rng, registry, native, crc_mod, cuda_ec, counts)
    phase_objects(rng, codec, ecutil, crc_mod, cuda_ec, counts)
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
