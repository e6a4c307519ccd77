"""Entry points of the port: a single-device run of the flagship pass and
a multi-device dry run, the twin of the JAX package's
``__graft_entry__.py``.

``entry()`` returns the fused EC encode + per-chunk CRC32C pass
(``ops.cuda_ec.make_encode_crc_fn``, BASELINE.md's kernel) for the k=8
m=3 Reed-Solomon profile and an (8, 8, 4096) batch on the package
device.

``dryrun_multichip(n)`` runs the same step over a dp x shard plane of n
members: stripes are the data-parallel axis ("dp") and one stripe's k
data chunks are laid out across the "shard" axis.  Each member encodes
its k/shard chunks against its column slice of the generator
(``gf_encode``), the partial parities are XOR-reduced on the first
member (GF(2^8) addition), and the CRCs of the data and parity chunks
come from ``crc32c_rows``.  Every stripe's parity and every chunk CRC is
checked against the host oracle.  With fewer cards than n, members
share the cards there are; it never moves to the CPU unless the caller
set the package device to the CPU.

    python -c "import ceph_tpu_torch.graft_entry as g; print(g.dryrun_multichip(8))"
"""

from __future__ import annotations

import numpy as np
import torch

from . import get_device
from .ops import crc32c, cuda_ec, gf

K, M = 8, 3


def _data(batch: int, length: int) -> np.ndarray:
    data = np.arange(batch * K * length, dtype=np.uint64) % 251
    return data.astype(np.uint8).reshape(batch, K, length)


def entry():
    """(fn, example_args): the fused encode + CRC pass and an (8, 8,
    4096) batch on the package device."""
    fn = cuda_ec.make_encode_crc_fn(gf.reed_sol_van_matrix(K, M), 4096)
    return fn, (torch.from_numpy(_data(8, 4096)).to(get_device()),)


def members(n_devices: int) -> list[torch.device]:
    """The dry run's n members: one card each while there are cards,
    shared round-robin beyond that; n CPU members on a CPU package
    device."""
    dev = get_device()
    if dev.type != "cuda":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dry run: the package device is cuda but no "
                           "CUDA device is visible")
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def _run_sharded(n_devices: int):
    """Run the chunk-sharded step on n members and return (data, parity,
    crcs, matrix) as host arrays."""
    devs = members(n_devices)
    # dp x shard plane: the shard axis divides the k chunk slots
    shard = next(c for c in (4, 2, 1)
                 if n_devices % c == 0 and K % c == 0)
    n_dp = n_devices // shard
    length = 512
    batch = 4 * n_dp
    per_dp, k_local = batch // n_dp, K // shard
    matrix = gf.reed_sol_van_matrix(K, M)
    data = _data(batch, length)
    first = devs[0]
    rows = []
    for i in range(n_dp):
        acc = None
        for j in range(shard):
            cols = slice(j * k_local, (j + 1) * k_local)
            local = torch.from_numpy(np.ascontiguousarray(
                data[i * per_dp:(i + 1) * per_dp, cols])).to(
                    devs[i * shard + j])
            part = cuda_ec.gf_transform(
                np.ascontiguousarray(matrix[:, cols]), local).to(first)
            acc = part if acc is None else torch.bitwise_xor(acc, part)
        rows.append(acc)
    parity = torch.cat(rows)
    chunks = torch.cat([torch.from_numpy(data).to(first), parity], dim=1)
    crcs = cuda_ec.crc32c_rows(chunks.reshape(-1, length))
    crcs = crcs.view(torch.int32).cpu().numpy().view(np.uint32)
    parity = parity.cpu().numpy()
    assert parity.shape == (batch, M, length)
    return data, parity, crcs.reshape(batch, K + M), matrix


def verify_against_oracle(data, parity, crcs, matrix) -> None:
    """Every stripe's parity and every chunk CRC against the host oracle
    (the port's own gf.encode_np and crc32c_sw)."""
    host_parity = np.stack([gf.encode_np(matrix, data[b])
                            for b in range(data.shape[0])])
    np.testing.assert_array_equal(parity, host_parity)
    allc = np.concatenate([data, host_parity], axis=1)
    host_crcs = np.array(
        [[crc32c.crc32c_sw(0, c) for c in stripe]
         for stripe in allc], dtype=np.uint32)
    np.testing.assert_array_equal(crcs, host_crcs)


def dryrun_multichip(n_devices: int) -> dict:
    """Run one sharded step on n members and check every stripe and
    every chunk CRC against the host oracle.  Returns {"devices": n,
    "oracle": True, "mode": ...}, the mode naming where the members ran:
    "cpu", "cuda" (a card each) or "cuda-shared" (fewer cards than
    members)."""
    data, parity, crcs, matrix = _run_sharded(n_devices)
    verify_against_oracle(data, parity, crcs, matrix)
    devs = members(n_devices)
    mode = devs[0].type
    if mode == "cuda" and len(set(devs)) < n_devices:
        mode = "cuda-shared"
    return {"devices": n_devices, "oracle": True, "mode": mode}
