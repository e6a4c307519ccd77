"""Timing probe of the EC kernels on one CUDA card: the variants that
tell what bounds each kernel.  Its ``time_ms`` is also chip_smoke.py's.

    python3 ceph_tpu_torch/tools/kernel_probe.py [--root CHECKOUT]

`--root` times the ``ceph_tpu_torch`` of another checkout (an unpacked
parent commit, say) through the same public wrappers, so two versions
can be compared in one run on one card: run parent, change, change,
parent.  Every probe gives two times over distinct inputs of 256 MiB or
more (far past the 50 MB L2): ``ms``, the median of single calls each
timed alone (host launch work included, as a synchronous caller pays
it), and ``b2b_ms``, the mean CUDA-event time of back-to-back calls
(host launch work overlapped with the card's).  Prints the card's name
and power limit, then one JSON line per probe:

  * ``gf_rows``: gf_encode at (32, 8, 1 MiB) for 1, 2, 3, 4 and 8 output
    rows.  A kernel bound by device memory grows with the bytes it moves,
    (8 + r) / 11 of the r = 3 time; one bound by shared-memory lookups
    grows with the lookups it makes;
  * ``crc_shapes``: crc32c over the same 256 MiB as (256, 1 MiB) rows
    (256 segments a row to chain) and as (65536, 4 KiB) rows (nothing to
    chain): the difference is what the per-row chain costs;
  * ``fused``: the fused encode+CRC pass at (32, 8, 1 MiB), at
    (32, 4, 1 MiB) with k=4 m=2, and at (2048, 8, 4096);
  * ``chain``: the chain pass alone at 352 rows of 256 segments, where
    the checkout has the ``crc32c_chain`` wrapper;
  * ``copy``: a device-to-device copy of 352 MiB, the bandwidth yardstick.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUNS = 10


def time_ms(fn, inputs) -> dict:
    """CUDA-event times of fn over distinct inputs, after one warm-up
    call: {"ms": the median of single calls, each between its own pair
    of events, "b2b_ms": the mean of back-to-back calls}."""
    import torch

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
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for x in inputs:
        fn(x)
    ev[1].record()
    ev[1].synchronize()
    return {"ms": statistics.median(times),
            "b2b_ms": ev[0].elapsed_time(ev[1]) / len(inputs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--root", default=here,
                    help="checkout whose ceph_tpu_torch to time")
    args = ap.parse_args(argv)

    import torch  # without a card the first CUDA call below raises
    sys.path.insert(0, os.path.abspath(args.root))
    import ceph_tpu_torch
    from ceph_tpu_torch.ops import cuda_ec, gf

    dev = torch.device("cuda", 0)
    ceph_tpu_torch.set_device(dev)
    cuda_ec.build()
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(ident, flush=True)
    root = os.path.abspath(args.root)

    def emit(probe, **kv):
        print(json.dumps({"probe": probe, "root": root, **kv}), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rand(*shape):
        return [torch.randint(0, 256, shape, dtype=torch.uint8,
                              generator=gen, device=dev)
                for _ in range(RUNS)]

    data = rand(32, 8, 1 << 20)
    emit("gf_rows", shape=[32, 8, 1 << 20], ms={
        r: time_ms(cuda_ec.make_encode_fn(gf.reed_sol_van_matrix(8, r)),
                   data)
        for r in (1, 2, 3, 4, 8)})
    coding = gf.reed_sol_van_matrix(8, 3)
    fused_ms = {"32x8x1MiB": time_ms(
        cuda_ec.make_encode_crc_fn(coding, 1 << 20), data)}
    fused_ms["32x4x1MiB_m2"] = time_ms(
        cuda_ec.make_encode_crc_fn(gf.reed_sol_van_matrix(4, 2), 1 << 20),
        [x[:, :4].contiguous() for x in data])
    crc_ms = {"256x1MiB": time_ms(
        cuda_ec.make_crc_fn(1 << 20), [x.view(256, 1 << 20) for x in data])}
    crc_ms["65536x4KiB"] = time_ms(
        cuda_ec.make_crc_fn(4096), [x.view(65536, 4096) for x in data])
    emit("crc_shapes", ms=crc_ms)
    del data
    small = rand(2048, 8, 4096)
    fused_ms["2048x8x4096"] = time_ms(
        cuda_ec.make_encode_crc_fn(coding, 4096), small)
    emit("fused", ms=fused_ms)
    del small

    if hasattr(cuda_ec, "crc32c_chain"):
        N, nseg = 352, 256
        segs = [torch.randint(-2**31, 2**31 - 1, (N, nseg),
                              dtype=torch.int32, generator=gen,
                              device=dev).view(torch.uint32)
                for _ in range(RUNS)]
        emit("chain", rows=N, segments=nseg,
             ms=time_ms(cuda_ec.crc32c_chain, segs))
    src = torch.empty(176 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    emit("copy", mib=352, ms=time_ms(lambda s: dst.copy_(s), [src] * RUNS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
