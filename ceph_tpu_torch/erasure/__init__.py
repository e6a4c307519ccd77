"""Erasure-code plugin framework.

The reference's erasure-code tier (src/erasure-code/): the same
plugin/profile/chunk semantics as ceph_tpu — init from a profile,
systematic k+m chunking with padding, minimum_to_decode, encode/decode
over chunk maps — with the hot math on hand-written CUDA kernels
(ceph_tpu_torch.ops.cuda_ec) instead of per-arch SIMD assembly.

Plugins (mirroring ErasureCodePluginRegistry's dlopen set):
  tpu       — the north-star device backend (all matrix techniques)
  jerasure  — numpy-exact port of jerasure techniques (correctness oracle)
  isa       — ISA-L matrix semantics (reed_sol_van / cauchy), table cache
  shec      — shingled EC with exhaustive decoding-matrix search
  lrc       — locally repairable codes by layered composition
"""

from .interface import ErasureCode, ErasureCodeError, ErasureCodeInterface
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry, registry

__all__ = [
    "ErasureCodeInterface",
    "ErasureCode",
    "ErasureCodeError",
    "ErasureCodePlugin",
    "ErasureCodePluginRegistry",
    "registry",
]
