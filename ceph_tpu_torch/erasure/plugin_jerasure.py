"""jerasure-compatible plugin with device-routed region math.

Technique set and defaults follow the reference plugin
(src/erasure-code/jerasure/ErasureCodePluginJerasure.cc:39-55,
ErasureCodeJerasure.cc:78-80 — defaults k=2, m=1, w=8): reed_sol_van,
reed_sol_r6_op as GF(2^8) matrix codes; cauchy_orig / cauchy_good as
packetized bitmatrix codes.  The chunk layout is bit-identical to the
pure-host oracle (pinned by tests/data/encode_corpus.json); the REGION
MATH rides the measured host/device router (TorchBackend), the analog of
the reference's per-arch plugin flavors ec_jerasure_{generic,sse3,
sse4,neon} (jerasure/CMakeLists.txt:94-97) — the fastest kernel for
the size wins, chosen by measurement instead of cpuid.  `backend=host`
in the profile pins the pure-host oracle path.

Bit-matrix techniques (liberation w prime, blaum_roth w+1 prime,
liber8tion w=8 — all m=2 RAID-6 codes, ErasureCodeJerasure.h:176-259)
run as native GF(2) bit-matrices on the packetized path; liber8tion's
matrix entries are an equivalent MDS construction, not jerasure's
published table (see ops/gf.py liber8tion_bitmatrix docstring).
"""

from __future__ import annotations

from .matrix_codec import (TECHNIQUES, MatrixErasureCode, NumpyBackend,
                           TorchBackend)
from .registry import ErasureCodePlugin

JERASURE_TECHNIQUES = {
    name: TECHNIQUES[name]
    for name in ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                 "cauchy_good", "liberation", "blaum_roth", "liber8tion")
}


def backend_from_profile(profile) -> object:
    """Measured host/device router by default; `backend=host` pins the
    pure-host (numpy + native C) oracle path."""
    if (profile or {}).get("backend") == "host":
        return NumpyBackend()
    return TorchBackend()


class ErasureCodeJerasure(MatrixErasureCode):
    DEFAULT_K = 2
    DEFAULT_M = 1

    def __init__(self, backend=None):
        super().__init__(backend=backend or TorchBackend(),
                         techniques=JERASURE_TECHNIQUES)


class ErasureCodeJerasurePlugin(ErasureCodePlugin):
    def factory(self, profile):
        return ErasureCodeJerasure(
            backend=backend_from_profile(profile))


def __erasure_code_init__(registry, name):
    registry.add(name, ErasureCodeJerasurePlugin())
