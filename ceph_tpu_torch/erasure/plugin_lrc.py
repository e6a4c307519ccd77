"""LRC plugin: Locally Repairable Codes via layered composition.

Semantics follow the reference
(src/erasure-code/lrc/ErasureCodeLrc.cc): a `mapping`
string assigns every chunk position a role ('D' data, anything else
coding/pad), and `layers` is a JSON list of [layer_mapping, profile]
pairs, each layer an independent sub-code run by another plugin over the
positions its mapping marks 'D' (inputs) and 'c' (outputs).  The
convenience k/m/l form generates one global layer plus
(k+m)/l local layers exactly like parse_kml (:280-360), so a local
failure repairs from l chunks instead of k.

minimum_to_decode picks, per missing chunk, the cheapest layer that can
reconstruct it from available chunks (:554).
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np

from .interface import ErasureCode, ErasureCodeError
from .registry import ErasureCodePlugin


class _Layer:
    def __init__(self, mapping: str, codec, positions: list[int]):
        self.mapping = mapping           # over global positions
        self.codec = codec               # sub-plugin instance
        self.data_positions = [p for p in positions if mapping[p] == "D"]
        self.coding_positions = [p for p in positions if mapping[p] == "c"]
        # codec chunk id order: data chunks first, then coding chunks
        self.positions = self.data_positions + self.coding_positions

    def local_index(self, global_pos: int) -> int:
        return self.positions.index(global_pos)


class ErasureCodeLrc(ErasureCode):
    DEFAULT_SUBPLUGIN = "jerasure"

    def __init__(self, registry):
        self._registry = registry
        self.mapping = ""
        self.layers: list[_Layer] = []
        self._full_matrix: np.ndarray | None = None
        self._backend = None

    # -- init --------------------------------------------------------------

    def init(self, profile: Mapping[str, str]) -> None:
        profile = dict(profile)
        has_kml = any(profile.get(x, "-1") != "-1" for x in ("k", "m", "l"))
        if has_kml:
            if "layers" in profile or "mapping" in profile:
                raise ErasureCodeError(
                    "layers/mapping cannot be combined with k/m/l")
            self._generate_kml(profile)
        if "mapping" not in profile or "layers" not in profile:
            raise ErasureCodeError("lrc requires mapping + layers (or k/m/l)")
        self.mapping = profile["mapping"]
        try:
            layer_desc = json.loads(profile["layers"])
        except json.JSONDecodeError as e:
            raise ErasureCodeError(f"layers is not valid JSON: {e}") from e
        if not isinstance(layer_desc, list) or not layer_desc:
            raise ErasureCodeError("layers must be a non-empty JSON list")
        self.k = sum(1 for ch in self.mapping if ch == "D")
        self.m = len(self.mapping) - self.k
        self.layers = []
        for entry in layer_desc:
            if not isinstance(entry, list) or len(entry) < 1:
                raise ErasureCodeError(f"bad layer entry {entry!r}")
            lmap = entry[0]
            lprofile = self._parse_layer_profile(
                entry[1] if len(entry) > 1 else "")
            if len(lmap) != len(self.mapping):
                raise ErasureCodeError(
                    f"layer mapping {lmap!r} length != {len(self.mapping)}")
            positions = [i for i, ch in enumerate(lmap) if ch in ("D", "c")]
            lk = sum(1 for ch in lmap if ch == "D")
            lm = sum(1 for ch in lmap if ch == "c")
            lprofile.setdefault("plugin", self.DEFAULT_SUBPLUGIN)
            # layers are many SMALL codes (locals are single-XOR
            # rows): the per-matrix device jit warm-up would dwarf the
            # work, so sub-codecs pin the native host path — which
            # runs XOR rows at memcpy speed — unless the profile
            # explicitly asks for a device-routed layer backend
            lprofile.setdefault("backend", "host")
            lprofile["k"] = str(lk)
            lprofile["m"] = str(lm)
            sub = self._registry.factory(lprofile.pop("plugin"), lprofile)
            self.layers.append(_Layer(lmap, sub, positions))
        # sanity: every coding position must be produced by some layer
        produced = set()
        for layer in self.layers:
            produced |= set(layer.coding_positions)
        missing = [i for i, ch in enumerate(self.mapping)
                   if ch != "D" and i not in produced]
        if missing:
            raise ErasureCodeError(
                f"mapping positions {missing} produced by no layer")
        self._compose_matrix()
        # the composed matrix's region math rides the same measured
        # router as the matrix plugins (`backend=host` pins the host
        # oracle); layer sub-codecs stay host-pinned for repair paths
        from .plugin_jerasure import backend_from_profile
        self._backend = (None if self._full_matrix is None
                         else backend_from_profile(profile))

    def _compose_matrix(self) -> None:
        """Flatten the layer composition into ONE (m_total x k) coding
        matrix over GF(2^8): the layered code is linear, so every
        coding position is a fixed linear combination of the k data
        chunks.  encode_chunks then runs a single region multiply —
        one native/device dispatch instead of per-layer fancy-index
        copies + sub-encodes (which cost more in memcpy than math).

        Composition walks layers in order, tracking for each global
        position its row vector over the data chunks (D positions are
        unit vectors; a layer's parity rows are its coding matrix
        times the rows of its data positions — matrix-matrix over
        GF(2^8), so locals-over-parity compose correctly too)."""
        from ..ops import gf
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        k = len(data_pos)
        n = len(self.mapping)
        rows: dict[int, np.ndarray] = {}
        for ci, pos in enumerate(data_pos):
            unit = np.zeros(k, dtype=np.uint8)
            unit[ci] = 1
            rows[pos] = unit
        tbl = gf.mul_table()
        for layer in self.layers:
            if not layer.coding_positions:
                continue
            cm = getattr(layer.codec, "coding_matrix", None)
            # only plain GF(2^8) byte-matrix layers compose: a
            # packetized/bitmatrix technique's coding_matrix has
            # different region semantics (REP_PACKETS expands to a
            # GF(2) schedule at apply time) and composing its entries
            # as byte coefficients would encode garbage
            rep = getattr(layer.codec, "rep", "bytes")
            if cm is None or rep != "bytes" or any(
                    p not in rows for p in layer.data_positions):
                self._full_matrix = None     # non-byte-matrix layer:
                return                       # keep the layered path
            src = np.stack([rows[p] for p in layer.data_positions])
            # parity rows = cm (lm x lk) x src (lk x k) over GF(2^8)
            for ri, pos in enumerate(layer.coding_positions):
                acc = np.zeros(k, dtype=np.uint8)
                for j in range(src.shape[0]):
                    acc ^= tbl[cm[ri, j]][src[j]]
                rows[pos] = acc
        coding_pos = [i for i, ch in enumerate(self.mapping)
                      if ch != "D"]
        self._full_matrix = np.stack([rows[p] for p in coding_pos])

    @staticmethod
    def _parse_layer_profile(text: str) -> dict[str, str]:
        out: dict[str, str] = {}
        for tok in text.split():
            if "=" not in tok:
                raise ErasureCodeError(f"bad layer profile token {tok!r}")
            key, val = tok.split("=", 1)
            out[key] = val
        return out

    def _generate_kml(self, profile: dict) -> None:
        k = self.profile_int(profile, "k", -1)
        m = self.profile_int(profile, "m", -1)
        l = self.profile_int(profile, "l", -1)
        if -1 in (k, m, l):
            raise ErasureCodeError("all of k, m, l must be set")
        if (k + m) % l:
            raise ErasureCodeError("k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups or m % groups:
            raise ErasureCodeError("k and m must be multiples of (k+m)/l")
        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = [["".join(("D" * kg + "c" * mg + "_") for _ in range(groups)),
                   ""]]
        for i in range(groups):
            row = ""
            for j in range(groups):
                row += ("D" * l + "c") if i == j else "_" * (l + 1)
            layers.append([row, ""])
        profile["layers"] = json.dumps(layers)
        for key in ("k", "m", "l"):
            profile.pop(key, None)

    # -- geometry ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_chunk_mapping(self) -> list[int]:
        # data chunk i lives at the i-th 'D' position; coding chunk ids map
        # to the remaining positions in order
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        other_pos = [i for i, ch in enumerate(self.mapping) if ch != "D"]
        return data_pos + other_pos

    def get_alignment(self) -> int:
        return self.k * max(layer.codec.get_alignment() // max(layer.codec.k, 1)
                            for layer in self.layers)

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        padded = -(-object_size // alignment) * alignment
        return padded // self.k

    # -- encode ------------------------------------------------------------

    def encode(self, want_to_encode, data) -> dict[int, np.ndarray]:
        chunks = self.encode_prepare(data)      # (k, L)
        L = chunks.shape[1]
        n = self.get_chunk_count()
        buf = np.zeros((n, L), dtype=np.uint8)
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        for i, pos in enumerate(data_pos):
            buf[pos] = chunks[i]
        for layer in self.layers:
            if not layer.coding_positions:
                continue
            lin = buf[np.asarray(layer.data_positions)]
            parity = layer.codec.encode_chunks(lin)
            for idx, pos in enumerate(layer.coding_positions):
                buf[pos] = parity[idx]
        mapping = self.get_chunk_mapping()
        out = {}
        for i in want_to_encode:
            if not 0 <= i < n:
                raise ErasureCodeError(f"chunk id {i} out of range")
            out[i] = buf[mapping[i]]
        return out

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data_chunks = np.asarray(data_chunks, dtype=np.uint8)
        if self._full_matrix is not None:
            return self._backend.apply_bytes(self._full_matrix,
                                             data_chunks)
        L = data_chunks.shape[1]
        n = self.get_chunk_count()
        buf = np.zeros((n, L), dtype=np.uint8)
        data_pos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        for i, pos in enumerate(data_pos):
            buf[pos] = data_chunks[i]
        for layer in self.layers:
            if not layer.coding_positions:
                continue
            lin = buf[np.asarray(layer.data_positions)]
            parity = layer.codec.encode_chunks(lin)
            for idx, pos in enumerate(layer.coding_positions):
                buf[pos] = parity[idx]
        other_pos = [i for i, ch in enumerate(self.mapping) if ch != "D"]
        return buf[np.asarray(other_pos)]

    # -- device shapes -----------------------------------------------------

    def device_backend(self):
        from .matrix_codec import TorchBackend
        be = self._backend
        return be if isinstance(be, TorchBackend) else None

    def stripe_encode_shapes(self, unit: int) -> list:
        if self._full_matrix is not None:
            be = self.device_backend()
            return [] if be is None else be.sync_shapes(
                "bytes", self._full_matrix, (), (self.k, unit))
        return [s for layer in self.layers if layer.coding_positions
                for s in layer.codec.stripe_encode_shapes(unit)]

    def decode_shapes(self, unit: int, lost) -> list:
        # decode_chunks rebuilds one position at a time, each through
        # the cheapest layer that holds it
        if not list(lost):
            return []
        return [s for layer in self.layers
                for s in layer.codec.decode_shapes(unit, (1,))]

    # -- decode ------------------------------------------------------------

    def _position_of(self, chunk_id: int) -> int:
        return self.get_chunk_mapping()[chunk_id]

    def minimum_to_decode(self, want_to_read, available) -> list[int]:
        mapping = self.get_chunk_mapping()
        inv = {pos: cid for cid, pos in enumerate(mapping)}
        want_pos = {mapping[int(i)] for i in want_to_read}
        avail_pos = {mapping[int(i)] for i in available}
        need = set(p for p in want_pos if p in avail_pos)
        missing = want_pos - avail_pos
        for pos in sorted(missing):
            best = None
            for layer in self.layers:
                lset = set(layer.positions)
                if pos not in lset:
                    continue
                lavail = [layer.local_index(p) for p in lset & avail_pos]
                try:
                    lmin = layer.codec.minimum_to_decode(
                        [layer.local_index(pos)], lavail)
                except ErasureCodeError:
                    continue
                cost = {layer.positions[i] for i in lmin}
                if best is None or len(cost) < len(best):
                    best = cost
            if best is None:
                raise ErasureCodeError(
                    f"cannot decode position {pos} from {sorted(avail_pos)}")
            need |= best
        return sorted(inv[p] for p in need)

    def decode_chunks(self, want_to_read, chunks) -> dict[int, np.ndarray]:
        mapping = self.get_chunk_mapping()
        inv = {pos: cid for cid, pos in enumerate(mapping)}
        have_pos = {mapping[int(i)]: np.asarray(b, dtype=np.uint8)
                    for i, b in chunks.items()}
        want = [int(i) for i in want_to_read]
        # iterate layers until every wanted position is materialized:
        # repairing one position may unlock another layer's repair
        progress = True
        want_pos = {mapping[i] for i in want}
        while progress and not want_pos <= have_pos.keys():
            progress = False
            for layer in self.layers:
                lset = set(layer.positions)
                for p in sorted(lset - have_pos.keys()):
                    lhave = {layer.local_index(q): have_pos[q]
                             for q in lset & have_pos.keys()}
                    try:
                        rebuilt = layer.codec.decode_chunks(
                            [layer.local_index(p)], lhave)
                    except ErasureCodeError:
                        continue
                    arr = rebuilt[layer.local_index(p)]
                    have_pos[p] = np.asarray(arr, dtype=np.uint8)
                    progress = True
        missing = [i for i in want if mapping[i] not in have_pos]
        if missing:
            raise ErasureCodeError(f"cannot reconstruct chunks {missing}")
        return {i: have_pos[mapping[i]] for i in want}


class ErasureCodeLrcPlugin(ErasureCodePlugin):
    def __init__(self, registry):
        self._registry = registry

    def factory(self, profile):
        return ErasureCodeLrc(self._registry)


def __erasure_code_init__(registry, name):
    registry.add(name, ErasureCodeLrcPlugin(registry))
