"""ceph-tpu on PyTorch: the erasure-code write, scrub-CRC and rebuild
path of ``ceph_tpu`` ported to PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

Layout mirrors the JAX package so each module's counterpart is easy to
find:
  ops/       GF(2^8) and CRC32C host math, plain PyTorch transforms
             (ec_kernels), the CUDA kernel wrappers (cuda_ec), the EC
             dispatch pipeline on CUDA streams (pipeline) and the HBM
             stripe cache (hbm_cache)
  csrc/      CUDA C++ sources, built with nvcc at first use
  erasure/   erasure-code plugin framework (tpu/jerasure/isa/shec/lrc)
  osd/       stripe math + whole-object encode/decode (ecutil)
  utils/     logging, fault injection, copy audit, buffer lists
  native/    C++ host kernels (AVX2 GF math, hw CRC32C)

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
