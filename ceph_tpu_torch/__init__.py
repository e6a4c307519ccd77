"""ceph-tpu on PyTorch: the ``ceph_tpu`` daemons (mons, OSDs, mgr, MDS,
RGW), librados clients, front doors and erasure-code path ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a)
under every EC byte.  Wire format and on-disk layout are ``ceph_tpu``'s.

Layout mirrors the JAX package so each module's counterpart is easy to
find:
  ops/       GF(2^8) and CRC32C host math, plain PyTorch transforms
             (ec_kernels), the CUDA kernel wrappers (cuda_ec), the EC
             dispatch pipeline on CUDA streams (pipeline) and the HBM
             stripe cache (hbm_cache)
  csrc/      CUDA C++ sources, built with nvcc at first use
  erasure/   erasure-code plugin framework (tpu/jerasure/isa/shec/lrc)
  osd/       the OSD: PGs, peering, replicated and EC backends, scrub,
             recovery, stripe math (ecutil)
  mon/       paxos monitors (maps, health, EC profiles)
  client/    objecter + librados-style client API, librbd's
             ObjectCacher, the flat B-tree
  rgw/       S3/Swift gateway (SigV4, multisite sync agent)
  fs/        CephFS client and MDS;  rbd/ block images, rbd-mirror
  journal/   the Journaler (RBD journaling, mirroring)
  msg/       typed messenger (blocking and event-loop stacks)
  store/     ObjectStore backends (memstore, filestore, kstore,
             blockstore)
  crush/     CRUSH placement; kv/ key/value stores; auth/ cephx;
             cls/ object classes; compressor/; mgr/
  utils/     config, logging, fault injection, counters, op tracing
  native/    C++ host kernels (AVX2 GF math, hw CRC32C)
  vstart.py  MiniCluster (mons + OSDs + mgr, MDS, RGW in one process);
  daemons.py the mon, osd, mgr, mds and rgw entry points

Device: every entry point runs on ``cuda`` unless the caller asks for
the CPU with :func:`set_device`.  There is no silent fallback: on a
machine without a card, the default device raises at first use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

_device = torch.device("cuda")


def set_device(device) -> torch.device:
    """Set the package's default device ("cuda", "cuda:1", "cpu");
    returns the previous one."""
    global _device
    prev = _device
    _device = torch.device(device)
    return prev


def get_device() -> torch.device:
    """The package's default device (``cuda`` unless set otherwise)."""
    return _device
