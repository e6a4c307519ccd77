"""Compression plugin framework (compressor/Compressor.{h,cc} +
CompressionPlugin.h analog).

The reference registers snappy/zlib plugins through the generic
PluginRegistry and BlueStore/messenger call compress()/decompress()
through the abstract Compressor.  Here plugins are stdlib-backed
(zlib, bz2, lzma — snappy is not in this image) behind the same
factory surface; blobs are framed with a one-byte algorithm tag +
raw length so decompression is self-describing and a corrupted or
unknown frame errors instead of passing through.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib

_HDR = struct.Struct("<BQ")      # algorithm id, raw length


class CompressorError(Exception):
    pass


class Compressor:
    """One algorithm; subclasses provide _compress/_decompress."""

    NAME = "none"
    ID = 0

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        return _HDR.pack(self.ID, len(data)) + self._compress(data)

    def decompress(self, blob: bytes) -> bytes:
        if len(blob) < _HDR.size:
            raise CompressorError("short compressed blob")
        alg, raw_len = _HDR.unpack_from(blob)
        if alg != self.ID:
            raise CompressorError(
                f"blob is {_by_id(alg)}, not {self.NAME}")
        try:
            out = self._decompress(blob[_HDR.size:])
        except Exception as e:
            raise CompressorError(f"decompress failed: {e}") from e
        if len(out) != raw_len:
            raise CompressorError(
                f"length mismatch: {len(out)} != {raw_len}")
        return out

    def _compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def _decompress(self, data: bytes) -> bytes:
        raise NotImplementedError


class ZlibCompressor(Compressor):
    NAME, ID = "zlib", 1

    def _compress(self, data: bytes) -> bytes:
        return zlib.compress(data, level=1)

    def _decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class Bz2Compressor(Compressor):
    NAME, ID = "bz2", 2

    def _compress(self, data: bytes) -> bytes:
        return bz2.compress(data, compresslevel=1)

    def _decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)


class LzmaCompressor(Compressor):
    NAME, ID = "lzma", 3

    def _compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=0)

    def _decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)


_PLUGINS: dict[str, type[Compressor]] = {
    c.NAME: c for c in (ZlibCompressor, Bz2Compressor, LzmaCompressor)}


def _by_id(alg_id: int) -> str:
    for cls in _PLUGINS.values():
        if cls.ID == alg_id:
            return cls.NAME
    return f"unknown({alg_id})"


def create(name: str) -> Compressor:
    """Compressor::create: factory by algorithm name."""
    cls = _PLUGINS.get(name)
    if cls is None:
        raise CompressorError(
            f"unknown compressor {name!r}; have {sorted(_PLUGINS)}")
    return cls()


def decompress_any(blob: bytes) -> bytes:
    """Decompress a self-describing frame regardless of algorithm."""
    if len(blob) < _HDR.size:
        raise CompressorError("short compressed blob")
    alg, _ = _HDR.unpack_from(blob)
    return create(_by_id(alg)).decompress(blob)


def algorithms() -> list[str]:
    return sorted(_PLUGINS)
