"""ctypes binding to the system libzstd (a copy of
sdrplusplusbrown_tpu/utils/zstd.py; host code) — true zstd wire-format
parity.

reference: core/src/server.cpp:447-459 compresses every baseband/FFT
packet one-shot with ``ZSTD_compressCCtx(cctx, dst, cap, src, n, 1)``
and the sdrpp_server_source client decompresses with a DCtx.  This
module binds the same one-shot simple API from ``libzstd.so.1`` so the
frames we emit/accept are byte-identical in format to the reference's
(same library, same level), with no build step.

``available()`` gates everything; callers fall back to zlib when the
shared library is absent (``ops/compression.py``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"  # little-endian 0xFD2FB528
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_lib: Optional[ctypes.CDLL] = None
_lib_err = None
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:  # pragma: no cover - env without libzstd
            _lib_err = e
            return None
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes, level: int = 1) -> bytes:
    """One-shot zstd frame (content size recorded in the frame header)."""
    lib = _load()
    if lib is None:  # pragma: no cover
        raise RuntimeError(f"libzstd unavailable: {_lib_err}")
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(dst, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compress failed")
    return dst.raw[:n]


def decompress(data: bytes, max_output: int = 1 << 28) -> bytes:
    """One-shot decode of a single zstd frame.

    Frames written by ``compress`` (and by the reference server, which
    uses the same simple API) carry the content size in the header; for
    headerless frames we retry with a doubling buffer up to
    ``max_output``.
    """
    lib = _load()
    if lib is None:  # pragma: no cover
        raise RuntimeError(f"libzstd unavailable: {_lib_err}")
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        if size > max_output:
            raise ValueError(f"frame content size {size} > cap {max_output}")
        dst = ctypes.create_string_buffer(max(int(size), 1))
        n = lib.ZSTD_decompress(dst, int(size), data, len(data))
        if lib.ZSTD_isError(n) or n != size:
            raise ValueError("zstd frame decode failed")
        return dst.raw[:n]
    cap = max(4 * len(data), 1 << 16)
    while cap <= max_output:
        dst = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_decompress(dst, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            return dst.raw[:n]
        cap *= 2
    raise ValueError("zstd frame larger than max_output")
