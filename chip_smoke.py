"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives ceph_tpu_torch's EC write, scrub-CRC and rebuild path on the card
at BASELINE.md config #2 (reed_sol_van k=8 m=3, 1 MiB chunks, 32-stripe
batches: 256 MiB of data, 96 MiB of parity on the device):

  1. device and build: the card's name and power limit, the kernels
     built from ceph_tpu_torch/csrc with nvcc;
  2. each CUDA kernel against its plain PyTorch version on the same
     device tensors (byte-exact), at the main-path shape and at a ragged
     one, with CUDA-event times beside the memory bound, the plain
     version and a device-to-device copy of the same bytes;
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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
K, M, L_MAIN, B_MAIN = 8, 3, 1 << 20, 32
RAGGED = (3, 1000)                   # (B, L)
ERASED = (0, 4, 9)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
NONTENSOR_OPS_PER_S = 67e12          # H100 SXM outside the tensor cores
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


def time_ms(fn, inputs) -> float:
    """Median CUDA-event time of fn(x) over distinct inputs, after one
    warm-up launch."""
    fn(inputs[0])
    torch.cuda.synchronize()
    times = []
    for x in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
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
    return time_ms(lambda s: dst.copy_(s), [src] * TIMED_RUNS)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_kernels(device, gen, cuda_ec, ec_kernels, gf):
    """Every kernel against its plain version at the main-path shape and
    a ragged one; returns per-kernel timing rows."""
    coding = gf.reed_sol_van_matrix(K, M)
    present = [i for i in range(K + M) if i not in ERASED][:K]
    want = [i for i in ERASED if i < K]
    inv = gf.decode_matrix(gf.systematic_generator(coding, K), K, present)
    dmat = inv[want]
    rows = {}
    for B, L in ((B_MAIN, L_MAIN), RAGGED):
        main = (B, L) == (B_MAIN, L_MAIN)
        inputs = [rand_u8((B, K, L), gen, device)
                  for _ in range(TIMED_RUNS if main else 2)]
        x = inputs[0]
        enc = cuda_ec.make_encode_fn(coding, L)
        crc = cuda_ec.make_crc_fn(L)
        fused = cuda_ec.make_encode_crc_fn(coding, L)
        dec = cuda_ec.make_encode_fn(dmat, L)
        plain_enc = ec_kernels.make_codec_fn(coding)
        plain_crc = ec_kernels.make_crc_fn(L)
        plain_fused = ec_kernels.make_encode_crc_fn(coding, L)
        plain_dec = ec_kernels.make_codec_fn(dmat)

        parity = enc(x)
        allc = torch.cat([x, parity], dim=1)
        survivors = allc[:, present].contiguous()
        flat = x.view(B * K, L)
        checks = {
            "gf_encode": (parity, plain_enc(x)),
            "crc32c": (crc(flat), plain_crc(flat)),
            "gf_decode": (dec(survivors), plain_dec(survivors)),
        }
        fp, fc = fused(x)
        pp, pc = plain_fused(x)
        checks["encode_crc"] = (fp, pp)
        errs = {name: max_abs_err(a, b) for name, (a, b) in checks.items()}
        errs["encode_crc"] = max(errs["encode_crc"], max_abs_err(fc, pc))
        if not torch.equal(checks["gf_decode"][0], x[:, want]):
            raise AssertionError(f"rebuild of {want} at {(B, L)} is wrong")
        torch.cuda.synchronize()
        bad = {n: e for n, e in errs.items() if e}
        if bad:
            raise AssertionError(f"kernel != plain at {(B, L)}: {bad}")
        emit("kernels_vs_plain", shape=[B, K, L], tolerance=0,
             max_abs_err=errs)
        if not main:
            continue

        flats = [t.view(B * K, L) for t in inputs]
        surv = [torch.cat([t, enc(t)], 1)[:, present].contiguous()
                for t in inputs]
        N = B * K
        work = {
            # name: (kernel fn, its inputs, plain fn, bytes, ops)
            "gf_encode": (enc, inputs, plain_enc,
                          B * (K + M) * L, B * M * K * L),
            "crc32c": (crc, flats, plain_crc, N * L + 4 * N, N * L),
            "encode_crc": (fused, inputs, plain_fused,
                           B * (K + M) * L + 4 * B * (K + M),
                           B * M * K * L + B * (K + M) * L),
            "gf_decode": (dec, surv, plain_dec,
                          B * (K + len(want)) * L, B * len(want) * K * L),
        }
        for name, (fn, xs, plain, nbytes, ops) in work.items():
            b_ms, b_by = bound(nbytes, ops)
            rows[name] = {
                "ms": time_ms(fn, xs),
                "plain_ms": time_ms(plain, xs[:PLAIN_RUNS]),
                "copy_ms": copy_ms(nbytes, device),
                "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": errs[name],
            }
            emit("kernel_time", name=name, shape=[B, K, L], **rows[name])
    return rows


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


ENCODE_LAUNCHES = {"gf_encode": 1, "crc32c": 2}    # the fused pass
DECODE_LAUNCHES = {"gf_encode": 1, "crc32c": 0}


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


KERNEL_META = {
    "gf_encode": ("ceph_tpu_torch/csrc/gf_encode.cu",
                  "ceph_tpu/ops/pallas_ec.py:55"),
    "crc32c": ("ceph_tpu_torch/csrc/crc32c.cu",
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
    rows = phase_kernels(device, gen, cuda_ec, ec_kernels, gf)

    # main path: each op is counted on its own, warm-ups excluded
    rng = np.random.default_rng(SEED)
    counts = dict.fromkeys(cuda_ec.launches, 0)
    codec = phase_codec(rng, registry, native, crc_mod, cuda_ec, counts)
    phase_objects(rng, codec, ecutil, crc_mod, cuda_ec, counts)
    emit("main_path_launches", launches=counts)
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
            "copy_ms": r["copy_ms"]})
    print(ident, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
