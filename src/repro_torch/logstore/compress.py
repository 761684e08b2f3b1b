"""Batch compression for the log store (§5: zStandard, batched records).

zstandard is optional: containers without it fall back to stdlib zlib
(same batched-blob protocol, slightly worse ratio).  Blobs are tagged
with a 1-byte header so the codecs can coexist; zlib-tagged blobs are
readable everywhere, zstd-tagged blobs need zstandard installed (a
clear RuntimeError says so).  A zstd context is not safe to share
between threads, so each thread (a writer, serving readers) keeps its own.
"""
from __future__ import annotations

import threading
import zlib

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - depends on container
    zstd = None
    HAVE_ZSTD = False

_LOCAL = threading.local()


def _cctx():
    if not hasattr(_LOCAL, "cctx"):
        _LOCAL.cctx = zstd.ZstdCompressor(level=3)
    return _LOCAL.cctx


def _dctx():
    if not hasattr(_LOCAL, "dctx"):
        _LOCAL.dctx = zstd.ZstdDecompressor()
    return _LOCAL.dctx


_TAG_ZSTD = b"z"
_TAG_ZLIB = b"d"


def compress_batch(lines: list[str]) -> bytes:
    raw = "\n".join(lines).encode("utf-8")
    if HAVE_ZSTD:
        return _TAG_ZSTD + _cctx().compress(raw)
    return _TAG_ZLIB + zlib.compress(raw, 6)


def decompress_batch(blob: bytes) -> list[str]:
    tag, payload = blob[:1], blob[1:]
    if tag == _TAG_ZLIB:
        raw = zlib.decompress(payload)
    else:  # zstd-tagged, or legacy untagged zstd blob
        if not HAVE_ZSTD:
            raise RuntimeError(
                "this store was written with zstandard; install it to read")
        raw = _dctx().decompress(payload if tag == _TAG_ZSTD else blob)
    return raw.decode("utf-8").split("\n")
