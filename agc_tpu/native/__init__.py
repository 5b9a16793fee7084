"""Native (C++) fast paths, loaded via ctypes.

The shared library is built on demand from lz_native.cpp with g++; when no
toolchain is available the pure-Python implementations in agc_tpu.core.lz
are used instead (same token grammar, slower).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lz_native.cpp")
_SRC_CAPI = os.path.join(_DIR, "agc_capi.cpp")
_LIB = os.path.join(_DIR, "liblznative.so")
_LIB_CAPI = os.path.join(_DIR, "libagcnative.so")

_lock = threading.Lock()
_lib = None
_tried = False
_capi_lib = None
_capi_tried = False


def _compile(srcs: list[str], out: str, extra: list[str]) -> bool:
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-march=native", *srcs, "-o", out + ".tmp", *extra]
        res = subprocess.run(cmd, capture_output=True, timeout=240)
        if res.returncode != 0:
            cmd.remove("-march=native")
            res = subprocess.run(cmd, capture_output=True, timeout=240)
            if res.returncode != 0:
                return False
        os.replace(out + ".tmp", out)
        return True
    except Exception:
        return False


def _build() -> bool:
    return _compile([_SRC], _LIB, [])


def _build_capi() -> bool:
    # the library by its runtime name: no libzstd.so dev link is needed
    return _compile([_SRC, _SRC_CAPI], _LIB_CAPI, ["-l:libzstd.so.1"])


def get_capi_path() -> str | None:
    """Build (if needed) and return the path of the C-API shared library
    (the reference's libagc equivalent: agc_open/agc_get_ctg_seq/...)."""
    global _capi_tried
    with _lock:
        stale = not os.path.exists(_LIB_CAPI) or os.path.getmtime(
            _LIB_CAPI
        ) < max(os.path.getmtime(_SRC), os.path.getmtime(_SRC_CAPI))
        if stale:
            if _capi_tried:
                return None
            _capi_tried = True
            if not _build_capi():
                return None
        return _LIB_CAPI


def get_capi():
    """ctypes handle to the C API library (or None)."""
    global _capi_lib
    path = get_capi_path()
    if path is None:
        return None
    with _lock:
        if _capi_lib is not None:
            return _capi_lib
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.agc_open.restype = ctypes.c_void_p
        lib.agc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.agc_close.argtypes = [ctypes.c_void_p]
        lib.agc_n_sample.argtypes = [ctypes.c_void_p]
        lib.agc_n_ctg.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.agc_get_ctg_len.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.agc_get_ctg_seq.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.agc_reference_sample.restype = ctypes.c_void_p
        lib.agc_reference_sample.argtypes = [ctypes.c_void_p]
        lib.agc_list_sample.restype = ctypes.POINTER(ctypes.c_char_p)
        lib.agc_list_sample.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        lib.agc_list_ctg.restype = ctypes.POINTER(ctypes.c_char_p)
        lib.agc_list_ctg.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ]
        lib.agc_list_destroy.argtypes = [ctypes.POINTER(ctypes.c_char_p)]
        lib.agc_string_destroy.argtypes = [ctypes.c_void_p]
        _capi_lib = lib
        return _capi_lib


def get_lib():
    """Return the loaded ctypes library or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(
            _SRC
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.lz_create.restype = ctypes.c_void_p
        lib.lz_create.argtypes = [ctypes.c_uint32]
        lib.lz_destroy.argtypes = [ctypes.c_void_p]
        lib.lz_prepare.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.lz_assure_index.argtypes = [ctypes.c_void_p]
        lib.lz_ref_ptr.restype = ctypes.c_void_p
        lib.lz_ref_ptr.argtypes = [ctypes.c_void_p]
        lib.lz_ref_len.restype = ctypes.c_uint64
        lib.lz_ref_len.argtypes = [ctypes.c_void_p]
        lib.lz_ctx_bytes.restype = ctypes.c_uint64
        lib.lz_ctx_bytes.argtypes = [ctypes.c_void_p]
        lib.lz_set_v1.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lz_encode.restype = ctypes.c_int64
        lib.lz_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            u8p,
            ctypes.c_uint64,
        ]
        lib.lz_estimate.restype = ctypes.c_uint64
        lib.lz_estimate.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.lz_cost_vector.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int,
            u32p,
        ]
        lib.fasta_preprocess.restype = ctypes.c_uint64
        lib.fasta_preprocess.argtypes = [u8p, ctypes.c_uint64, u8p, u8p]
        lib.fasta_preprocess2.restype = ctypes.c_int64
        lib.fasta_preprocess2.argtypes = [
            u8p, ctypes.c_uint64, u8p, u8p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ref_payload_tuples.restype = ctypes.c_int64
        lib.ref_payload_tuples.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.POINTER(ctypes.c_int32),
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.lz_anchor_diags.restype = ctypes.c_int64
        lib.lz_anchor_diags.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, i32p,
        ]
        lib.lz_encode_anchored.restype = ctypes.c_int64
        lib.lz_encode_anchored.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, i32p, ctypes.c_uint32,
            u8p, ctypes.c_uint64,
        ]
        lib.lz_encode_anchor_host.restype = ctypes.c_int64
        lib.lz_encode_anchor_host.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, u8p, ctypes.c_uint64,
        ]
        lib.lz_encode_anchor_ctx.restype = ctypes.c_int64
        lib.lz_encode_anchor_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            u8p, ctypes.c_uint64,
        ]
        lib.pack_nibbles.restype = None
        lib.pack_nibbles.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.tuples_to_bytes.restype = ctypes.c_uint64
        lib.tuples_to_bytes.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p]
        lib.rc_numeric.restype = None
        lib.rc_numeric.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.lz_split_point.restype = ctypes.c_int64
        lib.lz_split_point.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.numeric_to_fasta.restype = ctypes.c_uint64
        lib.numeric_to_fasta.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint32, u8p,
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kmer_canon_all.restype = None
        lib.kmer_canon_all.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, u64p, u8p,
        ]
        lib.kmer_canon_fill.restype = ctypes.c_int64
        lib.kmer_canon_fill.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, u64p,
        ]
        lib.kmer_scan_members.restype = ctypes.c_int64
        lib.kmer_scan_members.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            u64p, ctypes.c_int64,
            i64p, u64p, u64p, ctypes.c_int64,
        ]
        lib.kmer_discover_splitters.restype = ctypes.c_int64
        lib.kmer_discover_splitters.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            u64p, ctypes.c_int64, ctypes.c_int64,
            i64p, u64p, ctypes.c_int64,
        ]
        lib.rans_compress.restype = ctypes.c_int64
        lib.rans_compress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.rans_decompress.restype = ctypes.c_int64
        lib.rans_decompress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        for fn in (lib.lz_decode_v2, lib.lz_decode_v1):
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_uint32,
                u8p,
                ctypes.c_uint64,
            ]
        _lib = lib
        return _lib
