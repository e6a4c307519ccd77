"""ISA-L-compatible plugin (matrix semantics, device-routed).

Mirrors the reference isa plugin's API surface
(src/erasure-code/isa/ErasureCodeIsa.cc:107,117 —
techniques reed_sol_van and cauchy, defaults k=7 m=3, LRU-cached
decode tables): same generator constructions (powers-of-g rows /
gf_inv(i^j) cauchy).  Region math rides the measured host/device
router (TorchBackend) like every plugin — the reference's runtime SIMD
tier selection (arch/ probe -> AVX2 asm) generalized to measured
host-vs-device routing; `backend=host` pins the pure-host oracle.  The
decode-matrix LRU of the reference (ErasureCodeIsaTableCache.cc) maps
to MatrixErasureCode._decode_cache.
"""

from __future__ import annotations

from .matrix_codec import TECHNIQUES, MatrixErasureCode, TorchBackend
from .plugin_jerasure import backend_from_profile
from .registry import ErasureCodePlugin

ISA_TECHNIQUES = {
    "reed_sol_van": TECHNIQUES["isa_reed_sol_van"],
    "cauchy": TECHNIQUES["isa_cauchy"],
}


class ErasureCodeIsa(MatrixErasureCode):
    DEFAULT_K = 7
    DEFAULT_M = 3

    def __init__(self, backend=None):
        super().__init__(backend=backend or TorchBackend(),
                         techniques=ISA_TECHNIQUES)


class ErasureCodeIsaPlugin(ErasureCodePlugin):
    def factory(self, profile):
        return ErasureCodeIsa(backend=backend_from_profile(profile))


def __erasure_code_init__(registry, name):
    registry.add(name, ErasureCodeIsaPlugin())
