"""zstd through ctypes on libzstd's stable C API: the package's one zstd
binding.

Only the shared library (``libzstd.so.1``) is needed: no Python zstd
package and no development headers. The standalone C reader
(agc_capi.cpp) declares the same functions and links the same library.
Errors, including corrupt or truncated frames, raise ValueError.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

_lock = threading.Lock()
_lib = None
_tls = threading.local()

_SIZE = ctypes.c_size_t
_PTR = ctypes.c_void_p
_CONTENTSIZE_ERROR = (1 << 64) - 2  # this and UNKNOWN (2^64-1): no size


class _Buffer(ctypes.Structure):
    """ZSTD_inBuffer / ZSTD_outBuffer (same layout)."""

    _fields_ = [("ptr", _PTR), ("size", _SIZE), ("pos", _SIZE)]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = None
        for name in ("libzstd.so.1", ctypes.util.find_library("zstd")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        if lib is None:
            raise ImportError("libzstd (libzstd.so.1) not found")
        for fn, res, args in (
            ("ZSTD_createCCtx", _PTR, []),
            ("ZSTD_freeCCtx", _SIZE, [_PTR]),
            ("ZSTD_compressBound", _SIZE, [_SIZE]),
            ("ZSTD_compressCCtx", _SIZE,
             [_PTR, _PTR, _SIZE, _PTR, _SIZE, ctypes.c_int]),
            ("ZSTD_createDCtx", _PTR, []),
            ("ZSTD_freeDCtx", _SIZE, [_PTR]),
            ("ZSTD_DCtx_reset", _SIZE, [_PTR, ctypes.c_int]),
            ("ZSTD_decompressStream", _SIZE,
             [_PTR, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [_PTR, _SIZE]),
            ("ZSTD_isError", ctypes.c_uint, [_SIZE]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [_SIZE]),
        ):
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _lib = lib
        return lib


class _Ctx:
    """A per-thread libzstd context, freed when its thread ends."""

    def __init__(self, create, free):
        self.ptr = create()
        if not self.ptr:
            raise MemoryError("libzstd could not allocate a context")
        self._free = free

    def __del__(self):
        self._free(self.ptr)


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data, level: int) -> bytes:
    """One zstd frame (content size recorded, no checksum) at ``level``."""
    lib = _load()
    cctx = getattr(_tls, "cctx", None)
    if cctx is None:
        cctx = _tls.cctx = _Ctx(lib.ZSTD_createCCtx, lib.ZSTD_freeCCtx)
    src = bytes(data)
    cap = lib.ZSTD_compressBound(len(src))
    dst = ctypes.create_string_buffer(cap)
    n = _check(
        lib,
        lib.ZSTD_compressCCtx(cctx.ptr, dst, cap, src, len(src), level),
        "compress",
    )
    return dst.raw[:n]


def decompress(data) -> bytes:
    """The first zstd frame of ``data``; bytes after it are ignored.

    Streams into buffers sized by the frame's recorded content size
    (capped at 64 MiB per step), so a damaged size field cannot drive a
    huge allocation: output grows only as real data decodes."""
    lib = _load()
    dctx = getattr(_tls, "dctx", None)
    if dctx is None:
        dctx = _tls.dctx = _Ctx(lib.ZSTD_createDCtx, lib.ZSTD_freeDCtx)
    lib.ZSTD_DCtx_reset(dctx.ptr, 1)  # ZSTD_reset_session_only
    src = bytes(data)
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    step = 1 << 20 if size >= _CONTENTSIZE_ERROR else min(max(size, 1), 1 << 26)
    inb = _Buffer(ctypes.cast(ctypes.c_char_p(src), _PTR), len(src), 0)
    chunks = []
    while True:
        buf = ctypes.create_string_buffer(step)
        outb = _Buffer(ctypes.addressof(buf), step, 0)
        ret = _check(
            lib,
            lib.ZSTD_decompressStream(
                dctx.ptr, ctypes.byref(outb), ctypes.byref(inb)
            ),
            "decompress",
        )
        chunks.append(buf.raw[: outb.pos])
        if ret == 0:  # frame complete
            return b"".join(chunks)
        if inb.pos == inb.size and outb.pos < outb.size:
            raise ValueError("zstd decompress: truncated frame")
