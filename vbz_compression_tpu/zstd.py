"""The zstd stage's binding: ctypes over the system ``libzstd.so.1``.

One binding serves every caller of the entropy stage; it needs no Python
package beyond the standard library. Frames follow the reference's use of
the library (``ZSTD_compress`` / ``ZSTD_getFrameContentSize`` /
``ZSTD_decompress``, ``vbz/vbz.cpp:194-273``): content size written, no
checksum.
"""

from __future__ import annotations

import ctypes
import functools

from .errors import VBZ_ZSTD_ERROR, VbzError

# zstd.h: ZSTD_cParameter and ZSTD_strategy values (stable API since 1.4.0).
_C_COMPRESSION_LEVEL = 100
_C_WINDOW_LOG = 101
_C_HASH_LOG = 102
_C_CHAIN_LOG = 103
_C_SEARCH_LOG = 104
_C_MIN_MATCH = 105
_C_TARGET_LENGTH = 106
_C_STRATEGY = 107
_C_CONTENT_SIZE_FLAG = 200
_C_CHECKSUM_FLAG = 201
_STRATEGY_DFAST = 2
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

# Level-1 profile tuned on the signal corpus: the double-fast matcher with a
# 512 KiB window compresses StreamVByte payloads tighter than stock level 1
# (and than the reference's zstd 1.4.8 level 1) at the same speed. The level
# is an encoder-only knob; any zstd decoder reads the frames.
LEVEL1_PARAMS = (
    (_C_WINDOW_LOG, 19), (_C_CHAIN_LOG, 14), (_C_HASH_LOG, 16),
    (_C_SEARCH_LOG, 1), (_C_MIN_MATCH, 5), (_C_TARGET_LENGTH, 0),
    (_C_STRATEGY, _STRATEGY_DFAST),
)


@functools.cache
def lib() -> ctypes.CDLL:
    z = ctypes.CDLL("libzstd.so.1")
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for name, res, args in (
            ("ZSTD_versionNumber", ctypes.c_uint, []),
            ("ZSTD_maxCLevel", ctypes.c_int, []),
            ("ZSTD_minCLevel", ctypes.c_int, []),
            ("ZSTD_compressBound", size_t, [size_t]),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_createCCtx", ptr, []),
            ("ZSTD_freeCCtx", size_t, [ptr]),
            ("ZSTD_CCtx_setParameter", size_t, [ptr, ctypes.c_int,
                                                ctypes.c_int]),
            ("ZSTD_compress2", size_t, [ptr, ptr, size_t, ptr, size_t]),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ptr, size_t]),
            ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t])):
        fn = getattr(z, name)
        fn.restype, fn.argtypes = res, args
    return z


def _check(code: int) -> int:
    z = lib()
    if z.ZSTD_isError(code):
        raise VbzError(VBZ_ZSTD_ERROR, z.ZSTD_getErrorName(code).decode())
    return code


def compress(data: bytes, level: int) -> bytes:
    """One zstd frame of ``data`` at ``level`` (level 1: the tuned profile
    above), with the content size and no checksum."""
    z = lib()
    data = bytes(data)
    level = max(min(int(level), z.ZSTD_maxCLevel()), z.ZSTD_minCLevel())
    params = LEVEL1_PARAMS if level == 1 else (
        (_C_COMPRESSION_LEVEL, level),)
    cctx = z.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx failed")
    try:
        for key, value in params + ((_C_CONTENT_SIZE_FLAG, 1),
                                    (_C_CHECKSUM_FLAG, 0)):
            _check(z.ZSTD_CCtx_setParameter(cctx, key, value))
        dst = ctypes.create_string_buffer(z.ZSTD_compressBound(len(data)))
        n = _check(z.ZSTD_compress2(cctx, dst, len(dst), data, len(data)))
        return dst.raw[:n]
    finally:
        z.ZSTD_freeCCtx(cctx)


def frame_content_size(data: bytes) -> int:
    """``ZSTD_getFrameContentSize``; raises ``VbzError`` when the frame is
    invalid or does not record its size (``vbz/vbz.cpp:236-240``)."""
    data = bytes(data)
    size = lib().ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise VbzError(VBZ_ZSTD_ERROR, "invalid zstd frame")
    if size == _CONTENTSIZE_UNKNOWN:
        raise VbzError(VBZ_ZSTD_ERROR, "unknown frame content size")
    return int(size)


def decompress(data: bytes, capacity: int) -> bytes:
    """Decode the frames in ``data`` into at most ``capacity`` bytes."""
    data = bytes(data)
    dst = ctypes.create_string_buffer(max(int(capacity), 1))
    n = _check(lib().ZSTD_decompress(dst, len(dst), data, len(data)))
    return dst.raw[:n]
