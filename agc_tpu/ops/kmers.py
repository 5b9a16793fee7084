"""Rolling canonical k-mer kernels.

Vectorized replacements for the reference's per-thread rolling CKmer
loops (reference: src/core/kmer.h, agc_compressor.cpp:636-660, 707-760,
1997-2051): every position's canonical k-mer is computed in one vectorized
pass over the contig chunk instead of a serial rolling loop.

Membership scans avoid per-position gathers: a compare-all XOR-mix
prefilter for small tables, a sort-merge join for large ones, with exact
host-side verification of the few candidate hits. Whether a gather-based
probe is cheaper on a GPU is an open measurement.

K-mer value convention matches the reference exactly so splitter sets are
interchangeable with reference archives: the canonical code is
min(dir, rc) where

    dir = (sum_j w[j] * 4^(k-1-j)) << (64 - 2k)     (kmer.h insert_canonical)
    rc  = (sum_j (3-w[j]) * 4^j)   << (64 - 2k)

for window w[0..k-1]. All kernels return *left-aligned* u64 codes.
"""

from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import agc_tpu.ops  # noqa: F401  (ensures x64 config side effect)


def _shift_for(k: int) -> int:
    return 64 - 2 * k


def _shift_index(arr: jnp.ndarray, p: int) -> jnp.ndarray:
    """arr[i - p] with zero fill (static p): prepend p zeros, drop tail."""
    if p == 0:
        return arr
    return jnp.concatenate([jnp.zeros(p, dtype=arr.dtype), arr[: arr.shape[0] - p]])


def _shl64_pair(lo: jnp.ndarray, hi: jnp.ndarray, s: int):
    """(lo, hi) u32 pair << s (static s, 0 <= s < 64)."""
    if s == 0:
        return lo, hi
    if s < 32:
        return lo << jnp.uint32(s), (hi << jnp.uint32(s)) | (lo >> jnp.uint32(32 - s))
    z = jnp.zeros_like(lo)
    if s == 32:
        return z, lo
    return z, lo << jnp.uint32(s - 32)


def _dir_halves(codes: jnp.ndarray, k: int):
    """Per-position direct-orientation k-mer codes as u32 halves, via
    log-doubling.

    dir[i] = sum_{t=0..k-1} codes[i-t] * 4^t  (the reference's
    insert-symbol chain, kmer.h:284-301, unshifted). Built in
    O(log k + popcount k) vector steps instead of k: with
    D_m[i] = last-m-symbols code, D_{2m}[i] = D_m[i] | D_m[i-m] << 2m,
    and the remaining bits of k composed the same way. Every step is a
    static slice + shift/or on native u32 lanes.

    Returns (dlo, dhi, valid). The reverse-complement code is NOT
    computed here: rc = complement(bit-pair-reverse(dir)) (see
    _revcomp_u64 / host _revcomp_np), so scan kernels only need dir.
    """
    n = codes.shape[0]
    sym = jnp.where(codes > 3, jnp.uint32(0), codes.astype(jnp.uint32))
    zeros = jnp.zeros(n, dtype=jnp.uint32)
    # doubling ladder: D_1, D_2, D_4, ...
    powers = {1: (sym, zeros)}
    m = 1
    while 2 * m <= k:
        lo, hi = powers[m]
        blo = _shift_index(lo, m)
        bhi = _shift_index(hi, m)
        slo, shi = _shl64_pair(blo, bhi, 2 * m)
        powers[2 * m] = (lo | slo, hi | shi)
        m *= 2
    # compose k = m + remaining powers of two
    res_lo, res_hi = powers[m]
    acc = m
    rem = k - m
    b = 1
    while rem:
        if rem & b:
            plo, phi = powers[b]
            slo, shi = _shl64_pair(
                _shift_index(plo, acc), _shift_index(phi, acc), 2 * acc
            )
            res_lo = res_lo | slo
            res_hi = res_hi | shi
            acc += b
            rem &= ~b
        b <<= 1
    inv = (codes > 3).astype(jnp.int32)
    csum = jnp.cumsum(inv)
    if n >= k:
        csum_shift = jnp.concatenate([jnp.zeros(k, dtype=jnp.int32), csum[:-k]])
    else:
        csum_shift = jnp.zeros(n, jnp.int32)
    idx = jnp.arange(n)
    valid = ((csum - csum_shift) == 0) & (idx >= k - 1)
    return res_lo, res_hi, valid


def _revcomp_u64(dir_u: jnp.ndarray, k: int) -> jnp.ndarray:
    """rc code from an UNSHIFTED dir code (both u64):
    rc = (4^k - 1) - bitpair_reverse(dir): the rc symbol at exponent
    k-1-t is the complement of dir's symbol at exponent t."""
    x = dir_u
    m32 = jnp.uint64(0xFFFFFFFF00000000)
    x = ((x & m32) >> jnp.uint64(32)) | ((x & ~m32) << jnp.uint64(32))
    m16 = jnp.uint64(0xFFFF0000FFFF0000)
    x = ((x & m16) >> jnp.uint64(16)) | ((x & ~m16) << jnp.uint64(16))
    m8 = jnp.uint64(0xFF00FF00FF00FF00)
    x = ((x & m8) >> jnp.uint64(8)) | ((x & ~m8) << jnp.uint64(8))
    m4 = jnp.uint64(0xF0F0F0F0F0F0F0F0)
    x = ((x & m4) >> jnp.uint64(4)) | ((x & ~m4) << jnp.uint64(4))
    m2 = jnp.uint64(0xCCCCCCCCCCCCCCCC)
    x = ((x & m2) >> jnp.uint64(2)) | ((x & ~m2) << jnp.uint64(2))
    x = x >> jnp.uint64(64 - 2 * k)  # align pair-reversed code
    return (jnp.uint64((1 << (2 * k)) - 1) if k < 32 else jnp.uint64(2**64 - 1)) - x


def _revcomp_np(dir_u: np.ndarray, k: int) -> np.ndarray:
    """Host-side _revcomp_u64 (numpy), for decoding scan hits."""
    x = dir_u.astype(np.uint64)
    for bits, mask in (
        (32, 0xFFFFFFFF00000000),
        (16, 0xFFFF0000FFFF0000),
        (8, 0xFF00FF00FF00FF00),
        (4, 0xF0F0F0F0F0F0F0F0),
        (2, 0xCCCCCCCCCCCCCCCC),
    ):
        m = np.uint64(mask)
        x = ((x & m) >> np.uint64(bits)) | ((x & ~m) << np.uint64(bits))
    x >>= np.uint64(64 - 2 * k)
    full = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(2**64 - 1)
    return full - x


def dir_rc_kmers_np(codes: np.ndarray, k: int):
    """Host (numpy) per-position k-mer codes, both orientations:
    (udir, urc, valid), left-aligned u64 — the host counterpart of the
    device ``contig_kmers_dir_rc`` (the matcher and -f fallback
    bookkeeping need orientation, kmer.h:545-560)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, bool)
    sym = np.where(codes > 3, 0, codes).astype(np.uint64)

    def shift_index(arr, p):
        out = np.zeros_like(arr)
        out[p:] = arr[: len(arr) - p]
        return out

    powers = {1: sym}
    m = 1
    while 2 * m <= k:
        d = powers[m]
        powers[2 * m] = d | (shift_index(d, m) << np.uint64(2 * m))
        m *= 2
    res = powers[m]
    acc = m
    rem = k - m
    b = 1
    while rem:
        if rem & b:
            res = res | (shift_index(powers[b], acc) << np.uint64(2 * acc))
            acc += b
            rem &= ~b
        b <<= 1
    rc = _revcomp_np(res, k)
    shift = np.uint64(_shift_for(k))
    inv = (codes > 3).astype(np.int32)
    csum = np.cumsum(inv)
    csum_shift = np.zeros(n, np.int32)
    csum_shift[k:] = csum[:-k]
    valid = ((csum - csum_shift) == 0) & (np.arange(n) >= k - 1)
    return res << shift, rc << shift, valid


def canon_kmers_np(codes: np.ndarray, k: int):
    """Host canonical k-mers: (canon, valid), left-aligned u64. Native
    one-pass rolling kernel when the toolchain is available (the numpy
    log-doubling twin costs ~15 passes over 8-byte arrays — seconds per
    16 M positions on a bandwidth-starved core); numpy otherwise. Used
    by host splitter discovery and adaptive new-splitter discovery."""
    from ..native import get_lib

    n = len(codes)
    if n < k:  # numpy twin returns empty arrays below one window
        z = np.zeros(0, np.uint64)
        return z, np.zeros(0, bool)
    lib = get_lib()
    if lib is not None and n:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        c = np.ascontiguousarray(codes)
        canon = np.empty(n, dtype=np.uint64)
        valid = np.empty(n, dtype=np.uint8)
        lib.kmer_canon_all(
            c.ctypes.data_as(u8p), n, k,
            canon.ctypes.data_as(u64p), valid.ctypes.data_as(u8p),
        )
        return canon, valid.astype(bool)
    udir, urc, valid = dir_rc_kmers_np(codes, k)
    return np.minimum(udir, urc), valid


def _kmer_halves(codes: jnp.ndarray, k: int):
    """Per-position k-mer codes as native 32-bit halves:
    (dlo, dhi, rlo, rhi, valid), all unshifted. dir via log-doubling,
    rc via the complement-of-pair-reverse identity."""
    dlo, dhi, valid = _dir_halves(codes, k)
    dir_u = (dhi.astype(jnp.uint64) << jnp.uint64(32)) | dlo.astype(jnp.uint64)
    rc_u = _revcomp_u64(dir_u, k)
    rlo = (rc_u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    rhi = (rc_u >> jnp.uint64(32)).astype(jnp.uint32)
    return dlo, dhi, rlo, rhi, valid


def _halves_to_u64(hi: jnp.ndarray, lo: jnp.ndarray, k: int) -> jnp.ndarray:
    """(hi, lo) u32 halves of an unshifted code -> left-aligned u64."""
    return (
        (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    ) << jnp.uint64(_shift_for(k))


def _kmer_core(codes: jnp.ndarray, k: int):
    """Shared body: per-position (udir, urc, valid), left-aligned u64."""
    dlo, dhi, rlo, rhi, valid = _kmer_halves(codes, k)
    return (
        _halves_to_u64(dhi, dlo, k),
        _halves_to_u64(rhi, rlo, k),
        valid,
    )


@partial(jax.jit, static_argnums=(1,))
def contig_kmers_dir_rc(codes: jnp.ndarray, k: int):
    """Per-position (udir, urc, valid) — both orientations, for cut-point
    k-mer bookkeeping (the matcher needs orientation, kmer.h:545-560)."""
    return _kmer_core(codes, k)


@partial(jax.jit, static_argnums=(1,))
def contig_kmers_dir_rc_with_membership(codes, k, sorted_set):
    udir, urc, valid = _kmer_core(codes, k)
    canon = jnp.minimum(udir, urc)
    idx = jnp.searchsorted(sorted_set, canon)
    idx_c = jnp.clip(idx, 0, max(sorted_set.shape[0] - 1, 0))
    member = valid & (sorted_set[idx_c] == canon)
    return udir, urc, valid, member


@partial(jax.jit, static_argnums=(1,))
def contig_kmers(codes: jnp.ndarray, k: int):
    """Per-position canonical k-mers of a numeric contig chunk.

    Args:
        codes: uint8[N] numeric symbols (0..3 bases, >3 = non-ACGT).
        k: k-mer length (17..32).

    Returns:
        canon: uint64[N]; canon[i] is the left-aligned canonical code of the
            k-mer *ending* at position i (valid only where ``valid``).
        valid: bool[N]; window is fully in-bounds and ACGT-only.
        dir_oriented: bool[N]; dir <= rc (reference: kmer.h:545-551).
    """
    udir, urc, valid = _kmer_core(codes, k)
    canon = jnp.minimum(udir, urc)
    dir_oriented = udir <= urc
    return canon, valid, dir_oriented


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# nibble-packed transfer: 2 symbols/byte host->device. Only the
# invalid marker matters beyond ACGT, so symbols > 3 collapse to 15.
# ---------------------------------------------------------------------------


def pack4_np(codes: np.ndarray) -> np.ndarray:
    """Host pack: u8[n] -> u8[(n+1)//2], low nibble first; >3 -> 15.
    Uses the GIL-free C++ packer when available."""
    from ..native import get_lib

    n = len(codes)
    out = np.empty((n + 1) // 2, dtype=np.uint8)
    lib = get_lib()
    if lib is not None and n:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pack_nibbles(
            np.ascontiguousarray(codes).ctypes.data_as(u8p),
            n,
            out.ctypes.data_as(u8p),
        )
        return out
    c = np.where(codes > 3, 15, codes).astype(np.uint8)
    if n % 2:
        c = np.concatenate([c, np.full(1, 15, np.uint8)])
    return (c[0::2] | (c[1::2] << 4)).astype(np.uint8)


def _unpack4_dev(packed: jnp.ndarray) -> jnp.ndarray:
    """In-kernel unpack: u8[m] -> u8[2m] numeric symbols (15 = invalid)."""
    lo = packed & jnp.uint8(15)
    hi = packed >> jnp.uint8(4)
    return jnp.stack([lo, hi], axis=-1).reshape(packed.shape[0] * 2)


@partial(jax.jit, static_argnums=(1,))
def canon_kmers_window_p4(packed, k, lo, hi):
    """canon_kmers_chunk with positions outside [lo, hi) masked to the
    sentinel; traced lo/hi so one compiled shape serves all chunks."""
    codes = _unpack4_dev(packed)
    udir, urc, valid = _kmer_core(codes, k)
    canon = jnp.minimum(udir, urc)
    idx = jnp.arange(codes.shape[0])
    keep = valid & (idx >= lo) & (idx < hi)
    return jnp.where(keep, canon, SENTINEL)


def _hits_out_vec(member, dlo, dhi, cap: int):
    """Shared hit extraction: top_k positions (gather-free) + dir halves
    at hits. ONE u32 vector: [count, pos[cap] (ascending, leading fills),
    dlo[cap], dhi[cap]]."""
    n = member.shape[0]
    count = jnp.sum(member.astype(jnp.int32))
    iota = jnp.arange(n, dtype=jnp.int32)
    desc = jax.lax.top_k(jnp.where(member, iota, -1), cap)[0]
    pos = desc[::-1]  # ascending; -1 fills lead
    safe = jnp.clip(pos, 0, n - 1)
    return jnp.concatenate(
        [
            count[None].astype(jnp.uint32),
            pos.astype(jnp.uint32),
            dlo[safe],
            dhi[safe],
        ]
    )


def _scan_compact_body(codes, k, tlo, cap: int):
    """Membership scan against a small table, gather-free.

    Membership is a broadcast compare-all instead of a searchsorted
    (N*log T dependent gathers). The compared value is the XOR-MIX of the direct code's two halves
    (lo ^ hi: depends on all k symbols — a suffix-only prefilter would
    flood on repetitive sequence like poly-A runs), against a table of
    mixes for both orientations (make_scan_table). ~T/2^32 false-positive
    rate; the host verifies exact canonical membership when decoding
    (_decode_scan_vec). Only the dir rolling chain runs (no rc chain) and
    the compare is one u32 wide.
    """
    dlo, dhi, valid = _dir_halves(codes, k)
    mix = dlo ^ dhi
    member = valid & jnp.any(mix[:, None] == tlo[None, :], axis=1)
    return _hits_out_vec(member, dlo, dhi, cap)


def _scan_join_body(codes, k, thi, tlo, cap: int):
    """Membership scan against a LARGE table via sort-merge join.

    Compare-all scales linearly with table size and binary search
    serializes on gathers, so big tables (adaptive collections grow the
    splitter set into the 10^5 range) use a sort: table halves (both
    orientations) and per-position dir halves are sorted together with
    table rows ordered first inside equal-key runs; a boolean associative
    scan then propagates 'run starts at a table row' to every run member.
    O((n + T) log(n + T)) vectorized work, no serialized gathers.
    """
    n = codes.shape[0]
    dlo, dhi, valid = _dir_halves(codes, k)
    t = thi.shape[0]
    keys_hi = jnp.concatenate([thi, dhi])
    keys_lo = jnp.concatenate([tlo, dlo])
    # payload: -1 for table rows (sorts before any position inside a run)
    payload = jnp.concatenate(
        [
            jnp.full(t, -1, dtype=jnp.int32),
            jnp.where(valid, jnp.arange(n, dtype=jnp.int32), -2),
        ]
    )
    s_hi, s_lo, s_pay = jax.lax.sort(
        (keys_hi, keys_lo, payload), num_keys=3, is_stable=False
    )
    eq_prev = jnp.concatenate(
        [
            jnp.zeros(1, dtype=bool),
            (s_hi[1:] == s_hi[:-1]) & (s_lo[1:] == s_lo[:-1]),
        ]
    )
    prev_is_table = jnp.concatenate(
        [jnp.zeros(1, dtype=bool), s_pay[:-1] == -1]
    )
    # hit[i] = eq_prev[i] & (prev_is_table[i] | hit[i-1]); associative:
    # (c2,m2)o(c1,m1) = (c2 | m2&c1, m2&m1)
    c = eq_prev & prev_is_table
    m = eq_prev

    def combine(a, b):
        c1, m1 = a
        c2, m2 = b
        return c2 | (m2 & c1), m2 & m1

    hit_c, _ = jax.lax.associative_scan(combine, (c, m))
    member_sorted = hit_c & (s_pay >= 0)
    # top_k over original positions of sorted-domain hits
    vals = jnp.where(member_sorted, s_pay, -1)
    count = jnp.sum(member_sorted.astype(jnp.int32))
    desc = jax.lax.top_k(vals, cap)[0]
    pos = desc[::-1]
    safe = jnp.clip(pos, 0, n - 1)
    return jnp.concatenate(
        [
            count[None].astype(jnp.uint32),
            pos.astype(jnp.uint32),
            dlo[safe],
            dhi[safe],
        ]
    )


@partial(jax.jit, static_argnums=(1, 3))
def scan_chunk_compact_p4(packed, k, tlo, cap: int):
    """Single-chunk scan: one small u32 vector per chunk round-trip."""
    return _scan_compact_body(_unpack4_dev(packed), k, tlo, cap)


@partial(jax.jit, static_argnums=(1, 4))
def scan_chunk_join_p4(packed, k, thi, tlo, cap: int):
    return _scan_join_body(_unpack4_dev(packed), k, thi, tlo, cap)


def _decode_scan_vec(vec: np.ndarray, cap: int, table: "ScanTable"):
    """Host decode + exact verification of a scan vector ->
    (count, pos i64[H], udir u64[H], urc u64[H]).

    ``count`` is the device's candidate count (drives cap-overflow retry);
    the returned hits are exact (prefilter false positives removed by a
    binary search in the original canonical table)."""
    k = table.k
    count = int(vec[0])
    cnt = min(count, cap)
    sl = slice(cap - cnt, cap)
    pos = vec[1 : 1 + cap][sl].astype(np.int64)
    dlo = vec[1 + cap : 1 + 2 * cap][sl].astype(np.uint64)
    dhi = vec[1 + 2 * cap : 1 + 3 * cap][sl].astype(np.uint64)
    dir_u = (dhi << np.uint64(32)) | dlo
    rc_u = _revcomp_np(dir_u, k)
    shift = np.uint64(_shift_for(k))
    canon = np.minimum(dir_u, rc_u) << shift
    tbl = table.canon_np
    ix = np.searchsorted(tbl, canon)
    ok = (ix < tbl.size) & (tbl[np.minimum(ix, tbl.size - 1)] == canon)
    return count, pos[ok], (dir_u << shift)[ok], (rc_u << shift)[ok]


# tables with more entries than this use the sorted (binary search) kernel
_COMPARE_ALL_MAX = 8192


class ScanTable:
    """Device membership table for the scan kernels.

    kind 'cmp': compare-all prefilter table — unique XOR-mixes of both
    orientations' halves, padded to a power of two (min 128).
    kind 'join': (hi, lo) half pairs of both orientations for the
    sort-merge join kernel (large splitter sets), power-of-two padded.
    canon_np: the original host canonical array, for exact verification.

    Device arrays (.tlo/.thi) upload LAZILY on first access, so a
    host-engine create never touches the device.
    """

    __slots__ = ("kind", "k", "canon_np", "_tlo_np", "_thi_np",
                 "_tlo", "_thi")

    def __init__(self, kind, k, canon_np, tlo=None, thi=None):
        self.kind = kind
        self.k = k
        self.canon_np = canon_np
        self._tlo_np = tlo
        self._thi_np = thi
        self._tlo = None
        self._thi = None

    @property
    def tlo(self):
        if self._tlo is None and self._tlo_np is not None:
            self._tlo = jnp.asarray(self._tlo_np)
        return self._tlo

    @property
    def thi(self):
        if self._thi is None and self._thi_np is not None:
            self._thi = jnp.asarray(self._thi_np)
        return self._thi


def make_scan_table(sorted_u64, k: int):
    """Build the device membership table from sorted left-aligned u64
    canonical splitter codes. Returns a ScanTable or None for an empty
    set."""
    arr = np.asarray(sorted_u64, dtype=np.uint64)
    if arr.size == 0:
        return None
    shift = np.uint64(_shift_for(k))
    u = arr >> shift
    rc = _revcomp_np(u, k)
    low = np.uint64(0xFFFFFFFF)
    if arr.size <= _COMPARE_ALL_MAX:
        mixes = np.unique(
            np.concatenate(
                [(u & low) ^ (u >> np.uint64(32)), (rc & low) ^ (rc >> np.uint64(32))]
            )
        ).astype(np.uint32)
        b = 128
        while b < mixes.size:
            b <<= 1
        # pad value: arbitrary constant; a padding match is just another
        # prefilter false positive, removed by host verification
        tmix = np.full(b, 0xDEADBEEF, dtype=np.uint32)
        tmix[: mixes.size] = mixes
        return ScanTable("cmp", k, arr, tlo=tmix)
    both = np.unique(np.concatenate([u, rc]))
    b = 1 << 14
    while b < both.size:
        b <<= 1
    # pad pairs: arbitrary constant (a fake table row; matches are false
    # positives removed by host verification). NOT an equal pair: the
    # global join keys on tlo^thi, and an equal pair would mix to 0 — the
    # poly-A dir mix, which occurs in dense runs in real genomes.
    thi = np.full(b, 0xDEADBEEF, dtype=np.uint32)
    tlo = np.zeros(b, dtype=np.uint32)
    thi[: both.size] = (both >> np.uint64(32)).astype(np.uint32)
    tlo[: both.size] = (both & low).astype(np.uint32)
    return ScanTable("join", k, arr, tlo=tlo, thi=thi)


_POS_INF = np.uint64(0x7FFFFFFFFFFFFFFF)


_GREEDY_W = 2048  # probe window length for the greedy chain


@partial(jax.jit, static_argnums=(1, 3, 4))
def splitter_greedy_kernel(packed, k, table, seg_size: int, cap: int, t0=0):
    """Whole-contig greedy splitter emission on device.

    Device analogue of the reference's sequential find_splitters_in_contig
    walk (agc_compressor.cpp:762-825). The candidate table is large
    (~one entry per reference base), so a full-contig membership scan
    would cost n*log T serialized gathers. Hits against the singleton
    table are DENSE (most genome k-mers are unique), so the greedy
    'emit one splitter every >= seg_size bases' chain instead probes only
    a _GREEDY_W-wide window per emission: searchsorted over W positions,
    first hit emitted, jump seg_size. Total gathers ~ (n/seg_size)*W*log T
    instead of n*log T.

    Returns one u64 vector:
        [count, pos[cap], kmer[cap], tail_pos, tail_kmer]
    where tail_* is the rightmost hit of the whole contig (the
    rightmost-candidate fallback, agc_compressor.cpp:817-824), found by
    probing windows backward from the end; tail_pos = 2^63-1 when absent.
    """
    codes = _unpack4_dev(packed)
    dlo, dhi, valid = _dir_halves(codes, k)
    dir_u = (dhi.astype(jnp.uint64) << jnp.uint64(32)) | dlo.astype(jnp.uint64)
    canon = jnp.minimum(dir_u, _revcomp_u64(dir_u, k)) << jnp.uint64(_shift_for(k))
    canon = jnp.where(valid, canon, SENTINEL)
    return _greedy_over_canon(
        canon, codes.shape[0], table, seg_size, cap, t0, singleton=False
    )


_GREEDY_SPEC = max(1, int(os.environ.get("AGC_TPU_GREEDY_SPEC", "8")))


def _greedy_over_canon(canon, n_real, table, seg_size, cap, t0, singleton):
    """Shared greedy chain over a per-position canonical-code array.

    ``singleton=False``: hit = membership in ``table``. ``singleton=True``:
    ``table`` is the full sorted k-mer pool; hit = value occurs EXACTLY
    once (sorted-neighbor check — replaces the separate singleton-table
    sorts of remove_non_singletons, agc_compressor.cpp:664-705).
    ``n_real`` may be traced (loops stop there, not at the padded length).

    Window width: singleton hits are dense (most genome k-mers are
    unique), so a narrow window almost always contains the next emission
    and each probe costs 8x fewer serialized gathers; the membership mode
    keeps the wide window for sparse-hit tables.
    """
    W = 256 if singleton else _GREEDY_W
    S = _GREEDY_SPEC  # speculative windows per loop iteration
    n_real = jnp.asarray(n_real, jnp.int64)
    canon_pad = jnp.concatenate([canon, jnp.full(W, SENTINEL, dtype=jnp.uint64)])
    T = max(table.shape[0], 1)

    def probe(offs):
        """Hit masks + codes for S windows [offs[i], offs[i]+W).

        One searchsorted serves all S*W lanes, so the log2(T) serial
        gather rounds amortize over the whole speculative block.
        dynamic_slice clamps out-of-range starts; any hit a clamped
        window produces lies at p >= n_real and is discarded by the
        commit guard below."""
        ws = jnp.stack(
            [
                jax.lax.dynamic_slice(canon_pad, (offs[i],), (W,))
                for i in range(S)
            ]
        )
        ix = jnp.clip(jnp.searchsorted(table, ws.reshape(-1)), 0, T - 1)
        hit = (table[ix] == ws.reshape(-1)) & (ws.reshape(-1) != SENTINEL)
        if singleton:
            # searchsorted('left') => table[ix-1] < w, so only the right
            # neighbor can be a duplicate
            nxt = table[jnp.clip(ix + 1, 0, T - 1)]
            hit &= (nxt != ws.reshape(-1)) | (ix + 1 >= T)
        return hit.reshape(S, W), ws

    out_pos = jnp.full(cap, _POS_INF, dtype=jnp.uint64)
    out_kmer = jnp.zeros(cap, dtype=jnp.uint64)

    def cond(state):
        t, count, _, _ = state
        return (t < n_real) & (count < cap)

    def body(state):
        """SPECULATIVE chain block: probe S windows at t, t+seg, ...,
        t+(S-1)*seg in one shot, then commit sequentially in registers.
        Window i's eligibility floor is the previous commit's in-window
        offset D (prev emission p = t+(i-1)*seg+D, so the next target
        p+seg = t+i*seg+D), which always stays < W — the exact walk the
        one-window-per-iteration loop performed, at 1/S the serial loop
        iterations and 1/S the searchsorted launch rounds. A window with
        no eligible hit resumes scanning at its end (t+i*seg+W), exactly
        like the original no-hit step, and discards the rest of the
        block (their assumed start positions are stale)."""
        t, count, out_pos, out_kmer = state
        offs = [t + i * seg_size for i in range(S)]
        hit, ws = probe(offs)
        iota = jnp.arange(W, dtype=jnp.int64)
        alive = jnp.bool_(True)
        t_next = t + W  # overwritten below (S >= 1 always executes)
        D = jnp.int64(0)
        for i in range(S):
            elig = hit[i] & (iota >= D)
            found = jnp.any(elig)
            p_rel = jnp.argmax(elig).astype(jnp.int64)
            p = offs[i] + p_rel
            ok = alive & found & (p < n_real) & (count < cap)
            out_pos = jnp.where(
                ok, out_pos.at[count].set(p.astype(jnp.uint64)), out_pos
            )
            out_kmer = jnp.where(
                ok, out_kmer.at[count].set(ws[i][p_rel]), out_kmer
            )
            count = count + jnp.where(ok, 1, 0)
            D = jnp.where(ok, p_rel, D)
            t_next = jnp.where(
                ok,
                p + seg_size,
                jnp.where(alive, offs[i] + W, t_next),
            )
            alive = alive & ok
        return t_next, count, out_pos, out_kmer

    _, count, out_pos, out_kmer = jax.lax.while_loop(
        cond, body, (jnp.asarray(t0, jnp.int64), jnp.int64(0), out_pos, out_kmer)
    )

    def probe1(off):
        """Single window [off, off+W) (the tail walk probes backward one
        window at a time)."""
        w = jax.lax.dynamic_slice(canon_pad, (off,), (W,))
        ix = jnp.clip(jnp.searchsorted(table, w), 0, T - 1)
        hit = (table[ix] == w) & (w != SENTINEL)
        if singleton:
            nxt = table[jnp.clip(ix + 1, 0, T - 1)]
            hit &= (nxt != w) | (ix + 1 >= T)
        return hit, w

    # rightmost hit: backward windows from the end (dense hits -> 1 probe)
    def tail_cond(state):
        s, best = state
        return (best < 0) & (s > -W)

    def tail_body(state):
        s, _ = state
        off = jnp.maximum(s, jnp.int64(0))
        hit, _ = probe1(off)
        hit &= (off + jnp.arange(W, dtype=jnp.int64)) < n_real
        found = jnp.any(hit)
        r_rel = jnp.int64(W - 1) - jnp.argmax(hit[::-1]).astype(jnp.int64)
        best = jnp.where(found, off + r_rel, jnp.int64(-1))
        return s - W, best

    _, best = jax.lax.while_loop(
        tail_cond, tail_body, (n_real - W, jnp.int64(-1))
    )
    tail_pos = jnp.where(best >= 0, best.astype(jnp.uint64), _POS_INF)
    tail_kmer = canon[jnp.clip(best, 0, canon.shape[0] - 1)]

    return jnp.concatenate(
        [
            count.astype(jnp.uint64)[None],
            out_pos,
            out_kmer,
            tail_pos[None],
            tail_kmer[None],
        ]
    )


@partial(jax.jit, static_argnums=(3, 4))
def splitter_greedy_canon_kernel(canon, n_real, pool, seg_size: int, cap: int,
                                 t0=0):
    """Greedy chain over an already-resident canonical array, probing the
    full sorted k-mer pool with exactly-once (singleton) semantics."""
    return _greedy_over_canon(
        canon, n_real, pool, seg_size, cap, t0, singleton=True
    )


@partial(jax.jit, static_argnums=(1,))
def canon_rows_p4(packed_mat, k: int):
    """Per-row canonical k-mers over a matrix of nibble-packed rows
    (row-packed contigs with invalid-symbol seams): windows touching a
    seam or pad are invalid automatically, so no per-part masking is
    needed. Returns u64[rows, row_len] with SENTINEL at invalid windows."""
    def one(packed):
        codes = _unpack4_dev(packed)
        udir, urc, valid = _kmer_core(codes, k)
        canon = jnp.minimum(udir, urc)
        return jnp.where(valid, canon, SENTINEL)

    return jax.vmap(one)(packed_mat)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def splitter_greedy_packed_batch(canon_flat, starts, n_reals, bucket: int,
                                 seg_size: int, cap: int, singleton: bool,
                                 table=None):
    """Greedy emission chains for contigs that live at ``starts`` offsets
    inside one flat packed canon array: each row dynamic-slices its
    window (contiguous DMA, not a gather) and runs the chain. One
    compiled shape per (bucket, seg, cap) regardless of where contigs
    landed in the packing."""
    def one(start, n_real):
        window = jax.lax.dynamic_slice(canon_flat, (start,), (bucket,))
        return _greedy_over_canon(
            window, n_real, table, seg_size, cap, 0, singleton=singleton
        )

    return jax.vmap(one)(starts, n_reals)


@partial(jax.jit, static_argnums=(3, 4, 5))
def splitter_greedy_canon_batch(canon_rows, n_reals, table, seg_size: int,
                                cap: int, singleton: bool):
    """Batched greedy emission: one dispatch runs the per-contig chains of
    a whole batch of (equal-bucket) contigs via vmap — contigs are
    independent, so a many-contig reference costs a handful of dispatches
    instead of one round-trip per contig."""
    return jax.vmap(
        lambda c, nr: _greedy_over_canon(
            c, nr, table, seg_size, cap, 0, singleton=singleton
        )
    )(canon_rows, n_reals)


def find_splitter_emissions_batched(per_contig_recs, lens, k, table,
                                    seg_size: int, singleton: bool,
                                    codes_list=None):
    """Greedy emissions for MANY contigs: single-chunk contigs are grouped
    by canon-bucket size and emitted in batched vmap dispatches; rare
    multi-chunk (>CHUNK) contigs take the sequential chunk-grouped path
    (singleton pool) or the packed-upload chain (membership table, needs
    ``codes_list``).

    per_contig_recs: one collect_kmers_device record list per contig.
    Returns a list of (pos i64[E], kmers u64[E], tail_pos|None, tail_kmer)
    in contig order.
    """
    # the host walk enforces BOTH spacings: >= seg_size and >= k (the
    # reference resets its rolling k-mer at each cut) — equivalent to a
    # single max(seg_size, k) jump; also covers format-1.x archives
    # that carry no segment size
    seg_size = max(1, seg_size, k)
    results: list = [None] * len(per_contig_recs)
    by_bucket: dict[int, list[int]] = {}
    for i, recs in enumerate(per_contig_recs):
        if lens[i] < k or not recs:
            results[i] = (
                np.empty(0, np.int64), np.empty(0, np.uint64), None, 0,
            )
        elif len(recs) == 1 and recs[0][1] == 0 and recs[0][3] == 0:
            by_bucket.setdefault(int(recs[0][0].shape[0]), []).append(i)
        elif singleton:
            # multi-chunk contig: sequential host-carried chain
            results[i] = find_splitter_emissions_from_chunks(
                recs, lens[i], k, table, seg_size
            )
        else:
            results[i] = find_splitter_emissions(
                codes_list[i], k, table, seg_size
            )
    for b, idxs in by_bucket.items():
        cap = b // seg_size + 2
        max_rows = max(1, (32 << 20) // b)
        for s in range(0, len(idxs), max_rows):
            group = idxs[s : s + max_rows]
            # pad the row count to a power of two (dummy rows have
            # n_real=0 and exit their chains immediately): the compiled
            # executable set stays bounded instead of one shape per
            # distinct contig count
            n_rows = 1
            while n_rows < len(group):
                n_rows <<= 1
            arrs = [per_contig_recs[i][0][0] for i in group]
            reals = [per_contig_recs[i][0][2] for i in group]
            while len(arrs) < n_rows:
                arrs.append(arrs[0])
                reals.append(0)
            rows = jnp.stack(arrs)
            n_reals = jnp.asarray(reals, dtype=jnp.int64)
            vecs = np.asarray(
                splitter_greedy_canon_batch(
                    rows, n_reals, table, seg_size, cap, singleton
                )
            )
            for row, i in enumerate(group):
                vec = vecs[row]
                count = int(vec[0])
                pos = vec[1 : 1 + cap][:count].astype(np.int64)
                kms = vec[1 + cap : 1 + 2 * cap][:count].astype(np.uint64)
                t_tail = int(vec[1 + 2 * cap])
                if t_tail < lens[i]:
                    results[i] = (pos, kms, t_tail, np.uint64(vec[2 + 2 * cap]))
                else:
                    results[i] = (pos, kms, None, 0)
    return results


MAX_WHOLE_CONTIG = 1 << 25  # whole-contig greedy bucket ceiling (32 Mbase)


def find_splitter_emissions_from_chunks(chunk_recs, n: int, k: int, pool,
                                        seg_size: int):
    """Greedy splitter emissions driven by ALREADY-RESIDENT canonical
    chunk records (collect_kmers_device output) probing the full sorted
    k-mer ``pool`` with singleton semantics — no re-upload and no separate
    singleton-table sorts. Returns (positions, kmers, tail_pos|None,
    tail_kmer) like find_splitter_emissions.
    """
    # max(seg_size, k): the host walk also skips emissions closer than
    # k (rolling k-mer reset at the cut); 1 covers format-1.x archives
    seg_size = max(1, seg_size, k)
    if n < k or not chunk_recs:
        return np.empty(0, np.int64), np.empty(0, np.uint64), None, 0
    positions: list[int] = []
    kmers: list[int] = []
    tail_pos = None
    tail_kmer = np.uint64(0)
    e = None  # last emission (global position)

    # group chunk slices into <= MAX_WHOLE_CONTIG spans (contiguous in
    # global coordinates; halo overlap was handled at canon build time)
    groups: list[list] = [[]]
    acc = 0
    for rec in chunk_recs:
        _, kf, real, _ = rec
        ln = real - kf
        if acc + ln > MAX_WHOLE_CONTIG and groups[-1]:
            groups.append([])
            acc = 0
        groups[-1].append(rec)
        acc += ln

    for group in groups:
        g_start = group[0][3]
        slices = [arr[kf:real] for arr, kf, real, _ in group]
        total = sum(real - kf for _, kf, real, _ in group)
        b = _MIN_BUCKET
        while b < total:
            b <<= 1
        if b != total:
            slices.append(jnp.full(b - total, SENTINEL, dtype=jnp.uint64))
        canon = jnp.concatenate(slices) if len(slices) > 1 else slices[0]
        t_global = g_start if e is None else e + seg_size
        t0 = max(t_global - g_start, 0)
        cap = b // seg_size + 2
        vec = np.asarray(
            splitter_greedy_canon_kernel(canon, total, pool, seg_size, cap, t0)
        )
        count = int(vec[0])
        pos = vec[1 : 1 + cap][:count].astype(np.int64) + g_start
        kms = vec[1 + cap : 1 + 2 * cap][:count].astype(np.uint64)
        for pp, kk in zip(pos.tolist(), kms.tolist()):
            positions.append(pp)
            kmers.append(np.uint64(kk))
            e = pp
        t_tail = int(vec[1 + 2 * cap])
        if t_tail < total:
            tail_pos = t_tail + g_start
            tail_kmer = np.uint64(vec[2 + 2 * cap])
    return (
        np.asarray(positions, dtype=np.int64),
        np.asarray(kmers, dtype=np.uint64),
        tail_pos,
        tail_kmer,
    )


def find_splitter_emissions(contig_codes: np.ndarray, k: int, table, seg_size: int):
    """Greedy splitter emissions for one contig: returns
    (positions i64[E], kmers u64[E], tail_pos or None, tail_kmer).

    One device dispatch for contigs up to MAX_WHOLE_CONTIG; larger contigs
    run the jump chain across sequential whole-bucket dispatches with the
    emission state carried on host.
    """
    n = len(contig_codes)
    seg_size = max(1, seg_size, k)  # see find_splitter_emissions_from_chunks
    if n < k:
        return np.empty(0, np.int64), np.empty(0, np.uint64), None, 0
    if n <= MAX_WHOLE_CONTIG:
        b = _MIN_BUCKET
        while b < n:
            b <<= 1
        padded = np.full(b, _PAD_SYMBOL, dtype=np.uint8)
        padded[:n] = contig_codes
        cap = b // seg_size + 2
        vec = np.asarray(
            splitter_greedy_kernel(
                jnp.asarray(pack4_np(padded)), k, table, seg_size, cap
            )
        )
        count = int(vec[0])
        pos = vec[1 : 1 + cap][:count].astype(np.int64)
        kmers = vec[1 + cap : 1 + 2 * cap][:count].astype(np.uint64)
        tail_pos = int(vec[1 + 2 * cap])
        tail_kmer = np.uint64(vec[2 + 2 * cap])
        if tail_pos >= n:
            return pos, kmers, None, 0
        return pos, kmers, tail_pos, tail_kmer
    # huge contig: sequential whole-bucket dispatches; the jump-chain state
    # (next allowed emission position) is carried on the host between them
    positions: list[int] = []
    kmers: list[int] = []
    tail_pos = None
    tail_kmer = np.uint64(0)
    e = None  # last emission (global)
    start = 0
    while start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + MAX_WHOLE_CONTIG, n)
        sub = np.ascontiguousarray(contig_codes[lo:end])
        b = _MIN_BUCKET
        while b < len(sub):
            b <<= 1
        padded = np.full(b, _PAD_SYMBOL, dtype=np.uint8)
        padded[: len(sub)] = sub
        cap = b // seg_size + 2
        # chain start within this chunk (global carry -> local coordinates)
        t_global = start if e is None else e + seg_size
        t0 = max(t_global - lo, 0)
        vec = np.asarray(
            splitter_greedy_kernel(
                jnp.asarray(pack4_np(padded)), k, table, seg_size, cap, t0,
            )
        )
        count = int(vec[0])
        p_loc = vec[1 : 1 + cap][:count].astype(np.int64) + lo
        k_loc = vec[1 + cap : 1 + 2 * cap][:count].astype(np.uint64)
        for pp, kk in zip(p_loc.tolist(), k_loc.tolist()):
            if pp >= end:  # emission in the next chunk's territory: redo there
                break
            positions.append(pp)
            kmers.append(np.uint64(kk))
            e = pp
        t_chunk_tail = int(vec[1 + 2 * cap])
        if t_chunk_tail < len(sub) and t_chunk_tail + lo >= start:
            tail_pos = t_chunk_tail + lo
            tail_kmer = np.uint64(vec[2 + 2 * cap])
        start = end
    pos_arr = np.asarray(positions, dtype=np.int64)
    kmer_arr = np.asarray(kmers, dtype=np.uint64)
    return pos_arr, kmer_arr, tail_pos, tail_kmer


def collect_kmers_device_packed(contigs: list, k: int):
    """Canonical k-mers for MANY (<= CHUNK-sized) contigs in a handful of
    dispatches: contigs are bin-packed into CHUNK-wide rows on the host
    (first-fit decreasing, _SEAM invalid symbols between parts), nibble-
    packed, uploaded once, and canonized with one vmapped kernel. Returns
    (canon_flat u64[rows*CHUNK + CHUNK], placements) where placements[i] =
    (flat_start, n) for contig i; canon_flat is SENTINEL-padded so any
    ``dynamic_slice(start, bucket)`` stays in bounds.

    Seam/pad windows come out SENTINEL automatically (any window touching
    an invalid symbol is invalid), so the flat array doubles as the k-mer
    pool: sentinels sort to the end like explicit padding."""
    order = sorted(range(len(contigs)), key=lambda i: -len(contigs[i]))
    rows: list[list] = []
    used: list[int] = []
    placements = [None] * len(contigs)
    for i in order:
        n = len(contigs[i])
        placed = False
        for r, u in enumerate(used):
            off = (u + _SEAM + 1) & ~1
            if off + n <= CHUNK:
                rows[r].append((i, off))
                used[r] = off + n
                placed = True
                break
        if not placed:
            rows.append([(i, 0)])
            used.append(len(contigs[i]))
    n_rows = 1
    while n_rows < max(1, len(rows)):
        n_rows <<= 1
    mat = np.full((n_rows, CHUNK // 2), 0xFF, dtype=np.uint8)
    for r, row in enumerate(rows):
        for i, off in row:
            pk = pack4_np(np.ascontiguousarray(contigs[i]))
            mat[r, off // 2 : off // 2 + len(pk)] = pk
            placements[i] = (r * CHUNK + off, len(contigs[i]))
    canon = canon_rows_p4(jnp.asarray(mat), k)
    # keep only the real rows (the pow2 row pad exists for the kernel
    # shape); one trailing sentinel CHUNK keeps every dynamic_slice of
    # up to CHUNK in bounds
    canon_flat = jnp.concatenate(
        [
            canon[: max(1, len(rows))].reshape(-1),
            jnp.full(CHUNK, SENTINEL, dtype=jnp.uint64),
        ]
    )
    return canon_flat, placements


def find_splitter_emissions_packed(canon_flat, placements, k: int, table,
                                   seg_size: int, singleton: bool):
    """Greedy emissions for packed contigs (see
    collect_kmers_device_packed): contigs grouped by pow2 window bucket,
    each group one vmapped dynamic-slice dispatch. Returns the same
    per-contig tuples as find_splitter_emissions_batched."""
    seg_size = max(1, seg_size, k)  # see find_splitter_emissions_from_chunks
    results: list = [None] * len(placements)
    by_bucket: dict[int, list[int]] = {}
    for i, (start, n) in enumerate(placements):
        if n < k:
            results[i] = (
                np.empty(0, np.int64), np.empty(0, np.uint64), None, 0,
            )
        else:
            b = _MIN_BUCKET
            while b < n:
                b <<= 1
            by_bucket.setdefault(b, []).append(i)
    for b, idxs in by_bucket.items():
        cap = b // seg_size + 2
        max_rows = max(1, (32 << 20) // b)
        for s in range(0, len(idxs), max_rows):
            group = idxs[s : s + max_rows]
            n_rows = 1
            while n_rows < len(group):
                n_rows <<= 1
            starts = [placements[i][0] for i in group]
            reals = [placements[i][1] for i in group]
            while len(starts) < n_rows:
                starts.append(0)
                reals.append(0)
            vecs = np.asarray(
                splitter_greedy_packed_batch(
                    canon_flat,
                    jnp.asarray(starts, dtype=jnp.int64),
                    jnp.asarray(reals, dtype=jnp.int64),
                    b, seg_size, cap, singleton, table=table,
                )
            )
            for row, i in enumerate(group):
                vec = vecs[row]
                count = int(vec[0])
                pos = vec[1 : 1 + cap][:count].astype(np.int64)
                kms = vec[1 + cap : 1 + 2 * cap][:count].astype(np.uint64)
                t_tail = int(vec[1 + 2 * cap])
                n = placements[i][1]
                if t_tail < n:
                    results[i] = (pos, kms, t_tail, np.uint64(vec[2 + 2 * cap]))
                else:
                    results[i] = (pos, kms, None, 0)
    return results


def collect_kmers_device(contig_codes: np.ndarray, k: int) -> list:
    """Upload a contig and return its canonical k-mers as device-resident
    chunk records (sentinel-masked); nothing is transferred back.

    Each record is (canon_dev, keep_from, real, start): canon_dev[j] is
    the canonical code of the window ending at global position
    start - keep_from + j, valid for j in [keep_from, real).

    Full-CHUNK chunks batch into ONE vmapped canonization dispatch (one
    upload, one kernel) instead of a dispatch per chunk. Ragged tails
    keep the single-chunk path."""
    n = len(contig_codes)
    out = []
    if n < k:
        return out
    # plan the chunk windows first
    plans = []  # (lo, end, keep_from, start)
    start = 0
    while start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + CHUNK, n)
        plans.append((lo, end, start - lo, start))
        start = end
    full = [p for p in plans if p[1] - p[0] == CHUNK]
    rest = [p for p in plans if p[1] - p[0] != CHUNK]
    recs: dict[int, tuple] = {}
    if len(full) > 1:
        mat = np.empty((len(full), CHUNK), dtype=np.uint8)
        for j, (lo, end, _kf, _st) in enumerate(full):
            mat[j] = contig_codes[lo:end]
        packed = jnp.asarray(
            pack4_np(mat.reshape(-1)).reshape(len(full), CHUNK // 2)
        )
        kfs = jnp.asarray(
            np.array([p[2] for p in full], dtype=np.int32)
        )
        rows = jax.vmap(
            lambda p, kf: canon_kmers_window_p4(p, k, kf, CHUNK)
        )(packed, kfs)
        for j, (lo, end, kf, st) in enumerate(full):
            recs[st] = (rows[j], kf, CHUNK, st)
    else:
        rest = plans
    for lo, end, kf, st in rest:
        padded, real = _padded(np.ascontiguousarray(contig_codes[lo:end]))
        arr = canon_kmers_window_p4(
            jnp.asarray(pack4_np(padded)), k, kf, real
        )
        recs[st] = (arr, kf, real, st)
    return [recs[p[3]] for p in plans]


@jax.jit
def candidate_tables(kmers: jnp.ndarray):
    """Sort the k-mer pool and split into singleton / duplicated tables.

    Device analogue of RadixSortMSD + remove_non_singletons
    (reference: agc_compressor.cpp:490, 664-705). Returns
    (singletons_sorted_with_sentinel_tail u64[N], n_singletons,
     duplicated_sorted_with_sentinel_tail u64[N], n_duplicated);
    sentinel-padded so shapes stay static -- membership searches treat the
    sentinel tail as misses.
    """
    x = jnp.sort(kmers)
    n = x.shape[0]
    ne_prev = jnp.concatenate([jnp.ones(1, dtype=bool), x[1:] != x[:-1]])
    ne_next = jnp.concatenate([x[:-1] != x[1:], jnp.ones(1, dtype=bool)])
    not_sent = x != SENTINEL
    singleton = ne_prev & ne_next & not_sent
    first_dup = ne_prev & ~ne_next & not_sent
    singles = jnp.sort(jnp.where(singleton, x, SENTINEL))
    dups = jnp.sort(jnp.where(first_dup, x, SENTINEL))
    return (
        singles,
        jnp.sum(singleton.astype(jnp.int32)),
        dups,
        jnp.sum(first_dup.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnums=(1, 2))
def sample_compact_kmers(canon_chunk: jnp.ndarray, frac_bits: int,
                         out_size: int) -> jnp.ndarray:
    """Value-based 1/2^frac_bits subsample of a canonical-kmer chunk,
    compacted (sorted, sentinel-padded) to ``out_size`` entries.

    Sampling keys on a mix of the VALUE, so every occurrence of a given
    k-mer is kept or dropped together — singleton/duplicate detection on
    the sampled pool stays exact. Used when a reference's full k-mer pool
    would not fit device memory (the reference tool instead holds all
    k-mers in host RAM for raduls; agc_compressor.cpp:441-490)."""
    x = canon_chunk
    # murmur64 finalizer (same mixing as the host-side murmur64)
    h = x
    h ^= h >> jnp.uint64(33)
    h *= jnp.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> jnp.uint64(33)
    h *= jnp.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> jnp.uint64(33)
    keep = (h >> jnp.uint64(64 - frac_bits)) == jnp.uint64(0)
    vals = jnp.where(keep & (x != SENTINEL), x, SENTINEL)
    return jnp.sort(vals)[:out_size]


@jax.jit
def sort_kmers(kmers: jnp.ndarray) -> jnp.ndarray:
    """Device sort of a k-mer array (replaces raduls::RadixSortMSD;
    reference: agc_compressor.cpp:490)."""
    return jnp.sort(kmers)


@jax.jit
def singleton_filter(sorted_kmers: jnp.ndarray):
    """Mask of elements occurring exactly once in a sorted array
    (reference: remove_non_singletons, agc_compressor.cpp:664-705)."""
    x = sorted_kmers
    n = x.shape[0]
    if n == 0:
        return jnp.zeros(0, dtype=bool), jnp.zeros(0, dtype=bool)
    ne_prev = jnp.concatenate([jnp.ones(1, dtype=bool), x[1:] != x[:-1]])
    ne_next = jnp.concatenate([x[:-1] != x[1:], jnp.ones(1, dtype=bool)])
    singleton = ne_prev & ne_next
    first_of_dup = ne_prev & ~ne_next
    return singleton, first_of_dup


# ---------------------------------------------------------------------------
# host-side helpers around the kernels
# ---------------------------------------------------------------------------

# Positions per device dispatch. Large chunks amortize per-dispatch
# overhead.
CHUNK = 4 << 20
_MIN_BUCKET = 1 << 12
_PAD_SYMBOL = 255  # invalid -> windows touching padding are masked out


def _bucket_size(n: int) -> int:
    """Round up to a power-of-two bucket to bound the number of compiled
    kernel shapes (distinct shapes would otherwise trigger a compile per
    contig length)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return min(b, CHUNK)


def _padded(chunk: np.ndarray) -> tuple[np.ndarray, int]:
    n = len(chunk)
    b = _bucket_size(n)
    if b == n:
        return chunk, n
    out = np.full(b, _PAD_SYMBOL, dtype=np.uint8)
    out[:n] = chunk
    return out, n


def collect_kmers(contig_codes: np.ndarray, k: int) -> np.ndarray:
    """All valid canonical k-mers of a contig (host array in, host array out).

    Chunked with (k-1) overlap so chunk boundaries don't lose windows
    (mirrors the reference's contig_part_size chunking with k-1 overlap;
    agc_compressor.cpp:462-469).
    """
    n = len(contig_codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    out = []
    start = 0
    while start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + CHUNK, n)
        padded, real = _padded(np.ascontiguousarray(contig_codes[lo:end]))
        canon, valid, _ = contig_kmers(jnp.asarray(padded), k)
        # only keep windows ending inside [start, end)
        valid = np.asarray(valid)[:real]
        canon = np.asarray(canon)[:real]
        keep_from = start - lo
        out.append(canon[keep_from:][valid[keep_from:]])
        start = end
    return np.concatenate(out) if out else np.empty(0, dtype=np.uint64)


def scan_contig(
    contig_codes: np.ndarray, k: int, sorted_set: np.ndarray
):
    """Per-position (canon, udir, urc, valid, member) for a whole contig,
    chunked through the device kernel. Returns host numpy arrays."""
    n = len(contig_codes)
    canon = np.empty(n, dtype=np.uint64)
    udir = np.empty(n, dtype=np.uint64)
    urc = np.empty(n, dtype=np.uint64)
    valid = np.zeros(n, dtype=bool)
    member = np.zeros(n, dtype=bool)
    empty_table = len(sorted_set) == 0
    table = jnp.asarray(_padded_table(sorted_set)) if not empty_table else None
    start = 0
    while start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + CHUNK, n)
        padded, real = _padded(np.ascontiguousarray(contig_codes[lo:end]))
        chunk = jnp.asarray(padded)
        if empty_table:
            cd, cr, v = contig_kmers_dir_rc(chunk, k)
            m = np.zeros(real, dtype=bool)
        else:
            cd, cr, v, m = contig_kmers_dir_rc_with_membership(chunk, k, table)
            m = np.asarray(m)[:real]
        keep_from = start - lo
        cd = np.asarray(cd)[:real]
        cr = np.asarray(cr)[:real]
        udir[start:end] = cd[keep_from:]
        urc[start:end] = cr[keep_from:]
        canon[start:end] = np.minimum(cd, cr)[keep_from:]
        valid[start:end] = np.asarray(v)[:real][keep_from:]
        member[start:end] = m[keep_from:]
        start = end
    return canon, udir, urc, valid, member


_SCAN_CAP = 256


@partial(jax.jit, static_argnums=(1, 3))
def scan_batch_compact_p4(packed2d, k, tlo, cap: int):
    """Batched scan: B contig chunks per dispatch (amortizes per-dispatch
    RPC overhead). packed2d: u8[B, n/2] nibble-packed; returns
    u32[B, 1 + 3*cap] rows in _scan_compact_body layout."""

    def one(p):
        return _scan_compact_body(_unpack4_dev(p), k, tlo, cap)

    return jax.vmap(one)(packed2d)


@partial(jax.jit, static_argnums=(1, 4))
def scan_batch_join_global_p4(packed2d, k, thi, tlo, cap_total: int):
    """Batched large-table membership via ONE flattened sort-merge join.

    A vmapped per-row join would re-sort the table once per row (and its
    compile blows up at 1024 rows); instead the whole batch's dir halves
    are sorted once, each table row's equal-key run is located with a
    searchsorted over the sorted batch (2T log(Bn) gathers — T is small),
    and run coverage is painted with a scatter-add + prefix sum.

    Output is ONE u32 vector over the whole dispatch:
        [count, gpos[cap_total] (ascending; fills lead), dlo[...], dhi[...]]
    where gpos = row * n + pos (host splits rows; see
    _decode_scan_vec_global).
    """
    B, half = packed2d.shape
    n = half * 2

    def halves_row(p):
        codes = _unpack4_dev(p)
        return _dir_halves(codes, k)

    dlo, dhi, valid = jax.vmap(halves_row)(packed2d)
    flat = B * n
    dlo = dlo.reshape(flat)
    dhi = dhi.reshape(flat)
    payload = jnp.where(
        valid.reshape(flat), jnp.arange(flat, dtype=jnp.int32), -1
    )
    # join on the 32-bit XOR mix (single-key sort, ~30% cheaper than the
    # 64-bit pair): collisions are prefilter false positives, removed by
    # the host's exact verification like in the compare-all path
    mix = dlo ^ dhi
    s_mix, s_pay = jax.lax.sort((mix, payload), num_keys=1)
    tmix = jnp.sort(thi ^ tlo)
    lo_ix = jnp.searchsorted(s_mix, tmix, side="left")
    hi_ix = jnp.searchsorted(s_mix, tmix, side="right")
    cover = jnp.zeros(flat + 1, dtype=jnp.int32)
    cover = cover.at[lo_ix].add(1).at[hi_ix].add(-1)
    member = (jnp.cumsum(cover[:flat]) > 0) & (s_pay >= 0)
    count = jnp.sum(member.astype(jnp.int32))
    desc = jax.lax.top_k(jnp.where(member, s_pay, -1), cap_total)[0]
    gpos = desc[::-1]
    safe = jnp.clip(gpos, 0, flat - 1)
    return jnp.concatenate(
        [
            count[None].astype(jnp.uint32),
            gpos.astype(jnp.uint32),
            dlo[safe],
            dhi[safe],
        ]
    )


def _decode_scan_vec_global(vec: np.ndarray, cap: int, table: "ScanTable",
                            n_per_row: int):
    """Decode + verify a global join vector -> (count, rows, pos, udir,
    urc) with rows/pos split out of the global positions."""
    count, gpos, udir, urc = _decode_scan_vec(vec, cap, table)
    return count, gpos // n_per_row, gpos % n_per_row, udir, urc


def _cap_total_for(rows: int, b: int) -> int:
    """Global hit cap for one join dispatch: pow2 of ~32 hits/row."""
    c = 2048
    want = min(rows * 32, 131072)
    while c < want:
        c <<= 1
    return min(c, rows * b)


def _dispatch_scan_batch(mat, table: "ScanTable", cap: int):
    """Returns (out, is_global): cmp tables get per-row vectors; join
    tables get one global-join vector for the whole dispatch."""
    if table.kind == "cmp":
        return (
            scan_batch_compact_p4(jnp.asarray(mat), table.k, table.tlo, cap),
            False,
        )
    rows, half = mat.shape
    cap_total = _cap_total_for(rows, half * 2)
    return (
        scan_batch_join_global_p4(
            jnp.asarray(mat), table.k, table.thi, table.tlo, cap_total
        ),
        True,
    )


def _dispatch_scan_chunk(packed_dev, table: "ScanTable", cap: int):
    if table.kind == "cmp":
        return scan_chunk_compact_p4(packed_dev, table.k, table.tlo, cap)
    return scan_chunk_join_p4(packed_dev, table.k, table.thi, table.tlo, cap)


_XFER_POOL = None
_DL_POOL = None

# every DaemonPool registers here; an atexit hook stops them (bounded)
# so workers leave their loops before interpreter finalization
_ALL_POOLS: list = []


def _stop_all_pools():
    for p in list(_ALL_POOLS):
        try:
            p.stop(timeout=10.0)
        except Exception:
            pass


import atexit  # noqa: E402

atexit.register(_stop_all_pools)


class DaemonPool:
    """Minimal executor over DAEMON threads (submit -> Future).

    ThreadPoolExecutor's workers are non-daemon and joined at
    interpreter exit, so one job that never returns (an abandoned
    dispatch) hangs the whole process at shutdown. Daemon workers let
    the interpreter leave; the orphaned job dies with the process."""

    def __init__(self, n: int, name: str):
        import queue
        import threading as _th

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._n = n
        self._threads = []
        for i in range(n):
            t = _th.Thread(
                target=self._run, daemon=True, name=f"{name}-{i}"
            )
            t.start()
            self._threads.append(t)
        _ALL_POOLS.append(self)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:  # atexit stop sentinel
                return
            fut, fn, args, kw = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kw))
            except BaseException as e:  # noqa: BLE001 - mirrored to Future
                fut.set_exception(e)

    def stop(self, timeout: float = 10.0) -> None:
        """Send stop sentinels and join (BOUNDED): workers exit their
        loop before interpreter finalization, so no daemon thread is
        killed while inside runtime C++ ("FATAL: exception not
        rethrown"). A worker stuck in a job times out and is
        abandoned."""
        for _ in self._threads:
            self._q.put(None)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        # deregister: long-lived library processes creating many
        # Compressors (one match pool each) otherwise leak a list entry
        # + daemon thread per instance
        try:
            _ALL_POOLS.remove(self)
        except ValueError:
            pass

    def submit(self, fn, *args, **kw):
        from concurrent.futures import Future

        fut = Future()
        self._q.put((fut, fn, args, kw))
        return fut

    def shutdown(self, wait=True, cancel_futures=False, timeout=5.0):
        """ThreadPoolExecutor-compatible drain: cancel queued jobs and/
        or wait (BOUNDED — a stuck job must not hang teardown; the
        daemon worker dies with the process).
        The pool stays usable afterwards (workers are not torn down):
        callers use shutdown as a drain barrier, and module-level pools
        are process-lived anyway."""
        if cancel_futures:
            import queue

            try:
                while True:
                    item = self._q.get_nowait()
                    if item is None:  # stop sentinel (stop() raced us):
                        # preserve it for the worker loop
                        self._q.put(None)
                        break
                    item[0].cancel()
            except queue.Empty:
                pass
        if wait:
            barriers = [self.submit(lambda: None) for _ in range(self._n)]
            for f in barriers:
                try:
                    f.result(timeout=timeout)
                except Exception:
                    break


def _xfer_pool():
    """Background daemon threads for mat assembly + pack + upload +
    dispatch: keeps the main thread matching while transfers stage."""
    global _XFER_POOL
    if _XFER_POOL is None:
        # 2 threads: pack+upload of the next batch overlaps device execute
        _XFER_POOL = DaemonPool(2, "agc-xfer")
    return _XFER_POOL


def _dl_pool():
    """Dedicated daemon download thread: result matrices are pulled to
    host memory as soon as the device finishes, off the matcher thread
    and without blocking the upload/dispatch threads."""
    global _DL_POOL
    if _DL_POOL is None:
        _DL_POOL = DaemonPool(1, "agc-dl")
    return _DL_POOL


_BATCH_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


# ---------------------------------------------------------------------------
# scan engines. AGC_TPU_SCAN=device|host|auto (default auto, read when a
# ScanBatcher is made) pins the membership-scan engine: auto and device
# run the JAX kernels on whatever backend JAX uses, and a device error
# propagates; host runs the exact native rolling scan below, the plain
# reference the device path must reproduce.
# ---------------------------------------------------------------------------

# which engine did the work: symbols scanned on each, and splitter
# discoveries whose pool sort and greedy chain ran on the device
SCAN_STATS = {"device_syms": 0, "host_syms": 0, "device_discoveries": 0}


def scan_members_host(codes: np.ndarray, k: int, table):
    """Exact host membership scan: rolling canonical k-mer + one hash
    probe per window (native C++; numpy twin without a toolchain).
    Same result contract as ScanBatcher.collect: (pos, udir, urc) with
    ascending end-of-window positions and left-aligned u64 codes."""
    from ..native import get_lib

    n = len(codes)
    empty = (
        np.empty(0, dtype=np.int64),
        np.empty(0, dtype=np.uint64),
        np.empty(0, dtype=np.uint64),
    )
    if table is None or n < k:
        return empty
    tbl = table.canon_np
    lib = get_lib()
    if lib is not None:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c = np.ascontiguousarray(codes)
        t = np.ascontiguousarray(tbl)
        cap = max(4096, n // 4096)
        while True:
            pos = np.empty(cap, dtype=np.int64)
            ud = np.empty(cap, dtype=np.uint64)
            ur = np.empty(cap, dtype=np.uint64)
            cnt = lib.kmer_scan_members(
                c.ctypes.data_as(u8p), n, k,
                t.ctypes.data_as(u64p), len(t),
                pos.ctypes.data_as(i64p), ud.ctypes.data_as(u64p),
                ur.ctypes.data_as(u64p), cap,
            )
            if cnt <= cap:
                SCAN_STATS["host_syms"] += n
                return pos[:cnt], ud[:cnt], ur[:cnt]
            cap = cnt
    udir, urc, valid = dir_rc_kmers_np(codes, k)
    canon = np.minimum(udir, urc)
    ix = np.searchsorted(tbl, canon)
    ok = valid & (tbl[np.minimum(ix, tbl.size - 1)] == canon) & (ix < tbl.size)
    pos = np.nonzero(ok)[0].astype(np.int64)
    SCAN_STATS["host_syms"] += n
    return pos, udir[pos], urc[pos]

# eager device->host download of scan results on a dedicated thread
# (AGC_TPU_SYNC_DL=1 reverts to lazy downloads on the matcher thread)
_EAGER_DL = os.environ.get("AGC_TPU_SYNC_DL", "0") != "1"

# merge a flush's power-of-two bucket classes into one dispatch when the
# padding waste stays under 2x (see ScanBatcher.flush)
_COALESCE_BUCKETS = True

# bin-pack a flush's parts into fixed CHUNK-wide rows (with >=31 invalid
# symbols between parts so no k-mer window spans a seam): mixed-length
# contig collections then cost one dispatch per ~32 Mbase instead of one
# per power-of-two size class. Rows use EXACT counts (<=8 per dispatch, a
# bounded executable set) — a pow2 rows bucket would scan up to 2x
# padding. A small last row drops to its own pow2-width single-row
# dispatch so short flushes don't pay a full-width scan.
_PACK_ROWS = True
_SEAM = 32  # invalid symbols between packed parts (> max k - 1, even)
_PACK_CAP = 2048  # per-row hit cap for multi-part rows

# pack all-small multi-contig references for discovery (canon + greedy in
# a handful of dispatches); False falls back to per-contig records
_PACK_DISCOVERY = True


_BATCH_SYMBOL_BUDGET = 32 << 20  # max symbols per batched dispatch

# buffered symbols that trigger a flush: small enough that scans
# pipeline with matching, large enough that a dispatch fills the device.
# AGC_TPU_SCAN_FLUSH_MB pins it.
_SCAN_FLUSH_SYMBOLS = 8 << 20


class ScanBatcher:
    """Groups contig scans into batched multi-row dispatches.

    add() splits each contig into <=CHUNK pieces (k-1 overlap) and buffers
    them; flush() packs pieces of equal bucket size into one vmapped
    dispatch (up to 32 rows / 32 Mbase per dispatch). collect() downloads
    each dispatch's full result matrix ONCE (cached) and resolves every
    piece from its row — so a whole batch of contigs costs one kernel
    launch and one device->host transfer.

    ``table`` is a make_scan_table() tuple (or None for no splitters).
    """

    @staticmethod
    def _flush_quantum() -> int:
        """Buffered symbols per flush: AGC_TPU_SCAN_FLUSH_MB, or the
        fixed default."""
        env = os.environ.get("AGC_TPU_SCAN_FLUSH_MB")
        if env is not None:
            return int(float(env) * (1 << 20))
        return _SCAN_FLUSH_SYMBOLS

    def __init__(self, k: int, table):
        self.k = k
        self.table = table
        self._flush_symbols = self._flush_quantum()
        self._buf: list[dict] = []
        self._pending_syms = 0
        self._dl_cache: dict[int, np.ndarray] = {}
        # per-dispatch cache of cap-overflow re-runs (see collect)
        self._retry_cache: dict = {}
        self._host_mode = os.environ.get("AGC_TPU_SCAN", "auto") == "host"

    def add(self, codes: np.ndarray):
        """Returns a token dict resolved at flush/collect time."""
        n = len(codes)
        token = {"kind": "parts", "n": n, "parts": [], "codes": codes}
        if n < self.k or self.table is None:
            token["kind"] = "empty"
            return token
        if self._host_mode:
            # host engine: no device dispatch; collect() runs the exact
            # native host scan over the retained codes
            token["kind"] = "host"
            return token
        start = 0
        while start < n:
            lo = max(0, start - (self.k - 1))
            end = min(lo + CHUNK, n)
            part = {
                "start": start,
                "lo": lo,
                "real": end - lo,
                "codes": np.ascontiguousarray(codes[lo:end]),
            }
            token["parts"].append(part)
            self._buf.append(part)
            self._pending_syms += end - lo
            start = end
        if self._pending_syms >= self._flush_symbols:
            self.flush()
        return token

    def flush(self) -> None:
        if not self._buf:
            return
        if _PACK_ROWS:
            self._flush_packed()
            return
        self._pending_syms = 0
        by_bucket: dict[int, list] = {}
        for part in self._buf:
            b = _bucket_size(len(part["codes"]))
            by_bucket.setdefault(b, []).append(part)
        self._buf = []
        # coalesce bucket classes into the largest when the total padded
        # work (including the power-of-two ROWS bucket each dispatch pads
        # to) grows by < 40%: each dispatch has a fixed cost that
        # outweighs scanning some extra masked padding
        # (mixed-length contig collections otherwise split every flush
        # into one dispatch per power-of-two class)
        if _COALESCE_BUCKETS and len(by_bucket) > 1:
            def rows_bucket(n):
                for r in _BATCH_ROWS:
                    if r >= n:
                        return r
                return _BATCH_ROWS[-1]

            bmax = max(by_bucket)
            n_parts = sum(len(v) for v in by_bucket.values())
            cost_split = sum(
                b * rows_bucket(len(v)) for b, v in by_bucket.items()
            )
            cost_merged = bmax * rows_bucket(n_parts)
            if cost_merged * 10 <= cost_split * 14:
                merged: list = []
                for v in by_bucket.values():
                    merged.extend(v)
                by_bucket = {bmax: merged}
        for b, items in by_bucket.items():
            max_rows = max(1, min(_BATCH_ROWS[-1], _BATCH_SYMBOL_BUDGET // b))
            for start in range(0, len(items), max_rows):
                group = items[start : start + max_rows]
                rows = 1
                for r in _BATCH_ROWS:
                    if r >= len(group):
                        rows = r
                        break
                cap = min(_SCAN_CAP, b)

                def job(group=group, rows=rows, b=b, cap=cap):
                    # runs on the transfer thread: nibble-pack rows
                    # (GIL-free C++), upload, dispatch. Returns
                    # ((out_device_array, is_global), packed_mat).
                    mat = np.empty((rows, b // 2), dtype=np.uint8)
                    for row, part in enumerate(group):
                        pk = pack4_np(part.pop("codes"))
                        mat[row, : len(pk)] = pk
                        mat[row, len(pk):] = 0xFF  # invalid padding
                    if len(group) < rows:
                        mat[len(group):] = 0xFF
                    return _dispatch_scan_batch(mat, self.table, cap), mat

                def download(dispatch_fut):
                    # runs on the download thread once the dispatch job is
                    # queued: wait for the device and pull the compact
                    # result matrix to host memory, so collect() on the
                    # matcher thread never waits on a transfer.
                    (out, is_global), mat = dispatch_fut.result()
                    return (np.asarray(out), is_global), mat

                dispatch_fut = _xfer_pool().submit(job)
                if _EAGER_DL:
                    fut = _dl_pool().submit(download, dispatch_fut)
                else:
                    fut = dispatch_fut
                for row, part in enumerate(group):
                    part["out"] = fut
                    part["row"] = row
                    part["cap"] = cap
                    part["rows"] = rows
                    part["bucket"] = b

    def _flush_packed(self) -> None:
        """Bin-pack the buffered parts into CHUNK-wide rows (first-fit
        decreasing, _SEAM invalid symbols between parts) and dispatch
        exact-row-count batches; a lone small last row is re-bucketed to
        its own pow2 width."""
        parts = self._buf
        self._buf = []
        self._pending_syms = 0
        parts.sort(key=lambda p: -len(p["codes"]))
        rows: list[list] = []  # each: list of (part, offset)
        used: list[int] = []
        for part in parts:
            n = len(part["codes"])
            placed = False
            for r, u in enumerate(used):
                off = (u + _SEAM + 1) & ~1  # even offset (nibble packing)
                if off + n <= CHUNK:
                    rows[r].append((part, off))
                    used[r] = off + n
                    placed = True
                    break
            if not placed:
                rows.append([(part, 0)])
                used.append(n)

        # a small LAST row gets its own pow2-width single-row dispatch
        tail = None
        if rows and used[-1] <= CHUNK // 2:
            tail = (rows.pop(), used.pop())

        def submit(group_rows, width, cap):
            def job(group_rows=group_rows, width=width, cap=cap):
                mat = np.full((len(group_rows), width // 2), 0xFF,
                              dtype=np.uint8)
                for r, row in enumerate(group_rows):
                    for part, off in row:
                        pk = pack4_np(part.pop("codes"))
                        mat[r, off // 2 : off // 2 + len(pk)] = pk
                return _dispatch_scan_batch(mat, self.table, cap), mat

            def download(dispatch_fut):
                (out, is_global), mat = dispatch_fut.result()
                return (np.asarray(out), is_global), mat

            dispatch_fut = _xfer_pool().submit(job)
            fut = (
                _dl_pool().submit(download, dispatch_fut)
                if _EAGER_DL
                else dispatch_fut
            )
            for r, row in enumerate(group_rows):
                for part, off in row:
                    part["out"] = fut
                    part["row"] = r
                    part["offset"] = off
                    part["cap"] = cap
                    part["rows"] = len(group_rows)
                    part["bucket"] = width

        max_rows = max(1, _BATCH_SYMBOL_BUDGET // CHUNK)
        for s in range(0, len(rows), max_rows):
            group = rows[s : s + max_rows]
            multi = any(len(r) > 1 for r in group)
            cap = min(_PACK_CAP if multi else _SCAN_CAP, CHUNK)
            submit(group, CHUNK, cap)
        if tail is not None:
            row, u = tail
            width = _bucket_size(u)
            multi = len(row) > 1
            cap = min(_PACK_CAP if multi else _SCAN_CAP, width)
            submit([row], width, cap)

    def _resolve(self, fut):
        """Wait for a dispatch job, download its result once (cached
        briefly); returns (result_np, is_global, packed_mat).

        Keyed by the future OBJECT (a strong reference): an id()-based key
        would alias recycled ids after garbage collection and hand rows of
        the wrong dispatch to a token."""
        hit = self._dl_cache.get(fut)
        if hit is None:
            (out, is_global), packed_mat = fut.result()
            hit = (np.asarray(out), is_global, packed_mat)
            if len(self._dl_cache) >= 8:
                self._dl_cache.pop(next(iter(self._dl_cache)))
            self._dl_cache[fut] = hit
        return hit

    def collect(self, token):
        """Resolve a token to (pos, udir, urc)."""
        if token["kind"] == "precomputed":
            # hits known without a scan (e.g. the discovery reference's
            # own contigs: splitters are singletons at recorded positions)
            return token["hits"]
        if token["kind"] == "empty":
            return (
                np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.uint64),
                np.empty(0, dtype=np.uint64),
            )
        if token["kind"] == "host":
            return scan_members_host(token["codes"], self.k, self.table)
        all_pos, all_dir, all_rc = [], [], []
        for part in token["parts"]:
            if "out" not in part:
                self.flush()
            res, is_global, packed_mat = self._resolve(part["out"])
            cap = part["cap"]
            if is_global:
                b = part["bucket"]
                cap_total = _cap_total_for(part["rows"], b)
                count, rows_arr, pos, udir, urc = _decode_scan_vec_global(
                    res, cap_total, self.table, b
                )
                if count > cap_total and cap_total < part["rows"] * b:
                    # rare cap overflow: retry once per DISPATCH, not per
                    # part — all parts of the dispatch share the future,
                    # so the enlarged re-run is cached on it
                    retry = self._retry_cache.get(part["out"])
                    if retry is None:
                        cap_total = min(
                            1 << int(np.ceil(np.log2(count))),
                            part["rows"] * b,
                        )
                        vec = np.asarray(
                            scan_batch_join_global_p4(
                                jnp.asarray(packed_mat), self.table.k,
                                self.table.thi, self.table.tlo, cap_total,
                            )
                        )
                        if len(self._retry_cache) >= 8:
                            self._retry_cache.pop(
                                next(iter(self._retry_cache))
                            )
                        self._retry_cache[part["out"]] = (vec, cap_total)
                    else:
                        vec, cap_total = retry
                    count, rows_arr, pos, udir, urc = _decode_scan_vec_global(
                        vec, cap_total, self.table, b
                    )
                m = rows_arr == part["row"]
                pos, udir, urc = pos[m], udir[m], urc[m]
            else:
                vec = res[part["row"]]
                count, pos, udir, urc = _decode_scan_vec(vec, cap, self.table)
                if count > cap and cap < part["bucket"]:
                    # rare cap overflow: retry at next power-of-two >= count
                    cap = min(
                        1 << int(np.ceil(np.log2(count))), part["bucket"]
                    )
                    vec = np.asarray(
                        _dispatch_scan_chunk(
                            jnp.asarray(packed_mat[part["row"]]),
                            self.table, cap,
                        )
                    )
                    count, pos, udir, urc = _decode_scan_vec(
                        vec, cap, self.table
                    )
            part.pop("out", None)
            off = part.get("offset", 0)  # row-packed parts sit at an offset
            keep_from = part["start"] - part["lo"]
            m = (pos >= off + keep_from) & (pos < off + part["real"])
            all_pos.append(pos[m] - off - keep_from + part["start"])
            all_dir.append(udir[m])
            all_rc.append(urc[m])
        SCAN_STATS["device_syms"] += token["n"]
        return (
            np.concatenate(all_pos),
            np.concatenate(all_dir),
            np.concatenate(all_rc),
        )


def submit_scan_hits(contig_codes: np.ndarray, k: int, table):
    """Asynchronously dispatch splitter-hit scans for a whole contig.

    ``table`` is a make_scan_table() tuple. Returns an opaque token for
    collect_scan_hits. JAX queues the dispatches; nothing blocks here, so
    scans for many contigs can be in flight at once (hides the
    host<->device round-trip latency)."""
    n = len(contig_codes)
    pending = []
    if n < k or table is None:
        return (pending, k, table)
    start = 0
    while start < n:
        lo = max(0, start - (k - 1))
        end = min(lo + CHUNK, n)
        padded, real = _padded(np.ascontiguousarray(contig_codes[lo:end]))
        dev = jnp.asarray(pack4_np(padded))
        out = _dispatch_scan_chunk(dev, table, _SCAN_CAP)
        pending.append((out, dev, start, lo, real, len(padded)))
        start = end
    return (pending, k, table)


def collect_scan_hits(token):
    """Block on a submit_scan_hits token; returns (pos, udir, urc)."""
    pending, k, table = token
    all_pos = []
    all_dir = []
    all_rc = []
    for out, dev, start, lo, real, padded_len in pending:
        vec = np.asarray(out)  # single transfer
        cap = _SCAN_CAP
        count, pos, udir, urc = _decode_scan_vec(vec, cap, table)
        if count > cap and cap < padded_len:
            # rare overflow: retry at the next power-of-two >= count
            cap = min(1 << int(np.ceil(np.log2(count))), padded_len)
            vec = np.asarray(_dispatch_scan_chunk(dev, table, cap))
            count, pos, udir, urc = _decode_scan_vec(vec, cap, table)
        keep_from = start - lo
        m = (pos >= keep_from) & (pos < real)
        all_pos.append(pos[m] - keep_from + start)
        all_dir.append(udir[m])
        all_rc.append(urc[m])
    if not all_pos:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.uint64),
        )
    return (
        np.concatenate(all_pos),
        np.concatenate(all_dir),
        np.concatenate(all_rc),
    )


def scan_contig_hits(contig_codes: np.ndarray, k: int, sorted_set):
    """Positions + (udir, urc) of all splitter hits in a contig.

    ``sorted_set``: host np.uint64 sorted canonical codes, or a
    make_scan_table() ScanTable. Minimal-transfer path: uploads codes,
    downloads one compact vector per chunk. Returns (pos i64[H]
    ascending, udir u64[H], urc u64[H]).
    """
    n = len(contig_codes)
    if isinstance(sorted_set, np.ndarray):
        table = make_scan_table(sorted_set, k)
    else:
        table = sorted_set  # ScanTable or None
    if n < k or table is None:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.uint64),
        )
    return collect_scan_hits(submit_scan_hits(contig_codes, k, table))


def _padded_table(sorted_set: np.ndarray) -> np.ndarray:
    """Pad the sorted membership table to a power-of-two length with the
    all-ones sentinel (never a canonical k-mer: the canonical code is
    min(dir, rc) and the two orientations cannot both be all-T).

    Minimum 16K entries so small splitter sets of different sizes share
    one compiled kernel shape (binary-search cost is logarithmic)."""
    n = len(sorted_set)
    b = 1 << 14
    while b < n:
        b <<= 1
    if b == n:
        return sorted_set
    out = np.full(b, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    out[:n] = sorted_set
    return out
