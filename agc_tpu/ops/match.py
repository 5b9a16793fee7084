"""Batched device LZ-estimate kernels over a device-resident group-reference
bank — a data-parallel answer to the reference's serial candidate
estimator.

The reference ranks candidate groups for a segment by running a serial
byte-level greedy walk per (segment, candidate) pair under a shrinking
pruning bound (CLZDiff::Estimate, reference:
src/common/lz_diff.cpp:839-946, driven from
find_cand_segment_with_one_splitter, agc_compressor.cpp:1630-1808, and
find_cand_segment_using_fallback_minimizers, :1812-1963). That walk is
hash-probe + byte-extend at every position: a serial program with no
data-parallel form, and the exact shape of *decision* it does not need —
candidate search is a RANKING problem, and only the winner's tokens are
ever emitted.

Data-parallel rethink (SURVEY.md §7 step 7 "estimate-with-bound"):

- every group reference keeps a device-resident index: its LZ seed keys
  (``key_len = min_match_len - 3`` 2-bit-coded symbols, sampled every
  ``hashing_step = 4`` positions — the same sampled index the host
  encoder probes, lz_diff.cpp:16-25) packed into a dual min/max
  HASH-SLOT table (:class:`RefBank`, the "device-resident reference
  segment dictionary"). Slot tables, not sorted arrays: membership
  costs ONE probe, not the log2(m) dependent passes of a binary search
  (not yet measured on the GPU);
- a batch of segments is uploaded once (nibble-packed) and its seed keys
  for BOTH orientations are computed on device by the same log-doubling
  ladder the scan kernels use (O(log key_len) vector steps); probes are
  sampled every ``hashing_step`` segment positions too (4x fewer
  gathers; the reference's own -f fallback ranks groups from a ~1%
  k-mer sample, so stride-4 ranking fidelity is conservative);
- every (segment-orientation, candidate) pair is estimated at once:
  strided hash probes against the candidate's slot rows (gathered on
  device from one consolidated bank matrix), seed coverage painted with
  a strided-cumsum window upsampled by ``repeat`` (no scatter), covered
  runs and their diagonal jumps costed with the token grammar's digit
  lengths, and the uncovered ACGT positions counted as literals;
- the host exact-estimates only the short list that survives the device
  ranking (ties within a margin), so the final choice matches the
  host-only path whenever the true argmin is not decisively separated —
  in the one-splitter path the device removes the O(candidates) serial
  walks, not the decision.

The estimate is approximate BY DESIGN (coverage model over a lossy slot
table, not a replayed walk — numpy twins pin the model exactly);
:func:`shortlist` keeps candidate *choice* host-exact. The one
exception is :func:`split_point_device` (missing-middle split): its
coverage-model argmin IS the decision and can move the split point vs
the host's exact cost walk, so the compressor gates it separately
(AGC_TPU_DEVICE_SPLIT opt-in under auto; always on when
AGC_TPU_DEVICE_MATCH=1 forces the all-device path).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .kmers import (
    SENTINEL,
    _dir_halves,
    _revcomp_u64,
    _unpack4_dev,
    pack4_np,
)

HASHING_STEP = 4  # reference: lz_diff.h:38-42 (USE_SPARSE_HT)
_MIN_SEG_BUCKET = 1 << 12
_MIN_REF_KEY_BUCKET = 1 << 10

_U64 = jnp.uint64


def probe_stride(key_len: int | None = None) -> int:
    """Segment-side probe stride (positions between probed seed keys).
    Gathers are the device cost; stride 4 probes every index-aligned
    position, 8/16 trade ranking resolution for half/quarter the
    gathers. Must be a multiple of HASHING_STEP and (when known)
    < key_len — the env value is validated here so a bad override
    fails loudly instead of silently breaking the strided kernel's
    reshape and its numpy-twin parity."""
    raw = os.environ.get("AGC_TPU_MATCH_STRIDE", "4")
    try:
        stride = int(raw)
    except ValueError:
        raise ValueError(f"AGC_TPU_MATCH_STRIDE={raw!r} is not an integer")
    if stride <= 0 or stride % HASHING_STEP != 0 or (
        key_len is not None and stride >= key_len
    ):
        raise ValueError(
            f"AGC_TPU_MATCH_STRIDE={stride} invalid: must be a positive "
            f"multiple of {HASHING_STEP}"
            + (f" and < key_len={key_len}" if key_len is not None else "")
        )
    return stride

# slot-table geometry: H buckets = 2 x sampled-key bucket (load 0.5),
# each bucket keeps the MIN- and MAX-packed colliding entry (two scatter
# passes) — only middle entries of >=3-way bucket collisions are lost
# (~1% of keys at this load), which ranking tolerates and the twins model
_POS_BITS = 24            # ref positions < 16M (bank refuses larger refs)
_FP_BITS = 39
_HASH_MUL = 0x9E3779B97F4A7C15    # splitmix64 golden-ratio multiplier
_FP_MUL = 0xC2B2AE3D27D4EB4F      # xxhash64 prime_2
_SLOT_SENT = (1 << 63) - 1        # empty slot for the min table


def _bucket_of(keys, log2_h: int):
    """Bucket id of each (u64) seed key: top log2_h bits of key * GOLDEN."""
    return ((keys * _U64(_HASH_MUL)) >> _U64(64 - log2_h)).astype(jnp.int32)


def _fp_of(keys):
    """39-bit fingerprint (top bits of a second multiply), as int64."""
    return ((keys * _U64(_FP_MUL)) >> _U64(64 - _FP_BITS)).astype(jnp.int64)


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _pow4(n: int, lo: int) -> int:
    """4x shape ladder (compile-surface control): every static dimension
    of the estimate path quantizes to a 4x step, not 2x — the round-3
    A/B of the wide-candidate regime was killed by >30 min of fresh
    first-touch compiles from the pow2 x pow2 x pow2 product of (segment
    bucket, pair count, bank-row capacity) shapes (BASELINE.md). A 4x
    ladder squares down the number of reachable shapes at a bounded
    (<4x, typically ~1.6x) padding-compute cost that the device absorbs;
    compiles it does not."""
    b = lo
    while b < n:
        b <<= 2
    return b


# ---------------------------------------------------------------------------
# key construction (device)
# ---------------------------------------------------------------------------


def _start_keys(codes: jnp.ndarray, key_len: int):
    """Unshifted 2-bit seed keys at every window START (the host
    encoder's get_code, reference lz_diff.h:58-120): key[j] packs
    codes[j..j+key_len) with the first symbol highest. Invalid (any
    symbol > 3 or window out of bounds) -> SENTINEL."""
    dlo, dhi, valid_end = _dir_halves(codes, key_len)
    dir_end = (dhi.astype(_U64) << _U64(32)) | dlo.astype(_U64)
    kl = key_len
    # shift end-aligned -> start-aligned
    pad_u = jnp.full(kl - 1, SENTINEL, dtype=_U64)
    pad_b = jnp.zeros(kl - 1, dtype=bool)
    keys = jnp.concatenate([dir_end[kl - 1 :], pad_u])
    valid = jnp.concatenate([valid_end[kl - 1 :], pad_b])
    return jnp.where(valid, keys, SENTINEL), valid


def _rows_build(packed: jnp.ndarray, lens: jnp.ndarray, key_len: int):
    """(S, b/2) nibble-packed segment batch -> per-orientation seed keys
    + symbol classes (traced helper shared by the jitted row kernels).

    Returns (keys, acgt, isn), each (2S, b): row 2i is segment i in
    direct orientation, row 2i+1 its reverse complement (keys computed
    on device from the dir ladder via the complement-of-pair-reverse
    identity — the host never materializes the RC segment for
    estimation)."""

    def one(packed_row, n):
        codes = _unpack4_dev(packed_row)
        b = codes.shape[0]
        keys, valid = _start_keys(codes, key_len)
        acgt = codes <= 3
        # nibble packing collapses every symbol > 3 to 15; treat all of
        # them as N for costing (IUPAC codes are rare and cost ~the same)
        isn = (codes > 3) & (jnp.arange(b) < n)
        # rc keys: key at start j of the RC segment is the revcomp of the
        # dir key at start (n - key_len - j)
        f = keys[::-1]
        fv = valid[::-1]
        shift = b - 1 - n + key_len  # left-roll amount (traced)
        rf = jnp.roll(f, -shift)
        rfv = jnp.roll(fv, -shift)
        rkeys = jnp.where(rfv, _revcomp_u64(rf, key_len), SENTINEL)
        rc_ok = jnp.arange(b) <= n - key_len
        rkeys = jnp.where(rc_ok, rkeys, SENTINEL)
        facgt = jnp.roll(acgt[::-1], -(b - n))
        fisn = jnp.roll(isn[::-1], -(b - n))
        return keys, acgt, isn, rkeys, facgt, fisn

    keys, acgt, isn, rkeys, racgt, risn = jax.vmap(one)(packed, lens)
    out_keys = jnp.stack([keys, rkeys], axis=1).reshape(-1, packed.shape[1] * 2)
    out_acgt = jnp.stack([acgt, racgt], axis=1).reshape(out_keys.shape)
    out_isn = jnp.stack([isn, risn], axis=1).reshape(out_keys.shape)
    return out_keys, out_acgt, out_isn


@partial(jax.jit, static_argnames=("key_len",))
def _seg_rows_kernel(packed: jnp.ndarray, lens: jnp.ndarray, key_len: int):
    """Full-resolution per-orientation rows (split-point path)."""
    return _rows_build(packed, lens, key_len)


@partial(jax.jit, static_argnames=("key_len", "stride"))
def _seg_rows_strided_kernel(
    packed: jnp.ndarray, lens: jnp.ndarray, key_len: int, stride: int
):
    """Strided per-orientation row precomputation for batched
    estimation: everything PER-PAIR work needs, reduced to the probe
    grid so per-pair cost is O(b / stride) and gathered elements stay
    O(probes).

    Returns (keys_s (2S,T) strided seed keys; a_lo/a_hi (2S,T) int32
    per-block ACGT counts split at offset key_len % stride — the only
    within-block coverage boundary; nrun_tot (2S,) int32 total N-run
    token cost)."""
    keys, acgt, isn, = _rows_build(packed, lens, key_len)
    q2, b = keys.shape
    t = b // stride
    keys_s = keys[:, ::stride]
    r = key_len % stride
    blocks = acgt.reshape(q2, t, stride).astype(jnp.int32)
    a_lo = blocks[:, :, :r].sum(axis=2) if r else jnp.zeros(
        (q2, t), jnp.int32
    )
    a_hi = blocks[:, :, r:].sum(axis=2)
    prev_n = jnp.concatenate(
        [jnp.zeros((q2, 1), bool), isn[:, :-1]], axis=1
    )
    nrun_tot = 4 * jnp.sum((isn & ~prev_n).astype(jnp.int32), axis=1)
    return keys_s, a_lo, a_hi, nrun_tot


@partial(jax.jit, static_argnames=("key_len", "log2_h"))
def _ref_index_kernel(packed: jnp.ndarray, key_len: int, log2_h: int):
    """Nibble-packed reference -> dual min/max hash-slot tables over its
    seed keys sampled every HASHING_STEP positions (the device twin of
    the host encoder's make_index, reference lz_diff.cpp:117-146).
    Each slot packs (39-bit fingerprint << 24) | position as int64."""
    codes = _unpack4_dev(packed)
    keys, valid = _start_keys(codes, key_len)
    sk = keys[::HASHING_STEP]
    sv = valid[::HASHING_STEP]
    pos = jnp.arange(sk.shape[0], dtype=jnp.int64) * HASHING_STEP
    packed_e = (_fp_of(sk) << _POS_BITS) | pos
    packed_e = jnp.where(sv, packed_e, _SLOT_SENT)
    bkt = jnp.where(sv, _bucket_of(sk, log2_h), 0)
    h = 1 << log2_h
    ta = jnp.full(h, _SLOT_SENT, dtype=jnp.int64).at[bkt].min(
        packed_e, mode="drop"
    )
    tb = jnp.full(h, -1, dtype=jnp.int64).at[bkt].max(
        jnp.where(sv, packed_e, jnp.int64(-1)), mode="drop"
    )
    return ta, tb


def _digits(x: jnp.ndarray) -> jnp.ndarray:
    """ASCII digit count of a non-negative int32 (the token grammar
    spells positions/lengths in decimal; reference lz_diff.h:131-149)."""
    d = jnp.int32(1)
    for t in (10, 100, 1000, 10_000, 100_000, 1_000_000, 10_000_000):
        d = d + (x >= t).astype(jnp.int32)
    return d


def _pair_marginal_cost(q, a, nn, ta, tb, key_len):
    """Per-position marginal token cost of one (segment-row, candidate)
    pair under the coverage model: literal = uncovered ACGT position,
    match token cost attributed at its covered run's start, N-run cost
    at the N-run start. Summing gives the scalar estimate; cumulative
    sums give the prefix/suffix cost vectors the missing-middle split
    search needs (reference: GetCodingCostVector, lz_diff.cpp:159-284).

    Probes are STRIDED (every HASHING_STEP segment positions) against
    the candidate's dual slot tables (ta min-packed, tb max-packed):
    two gathers per probed position instead of a binary search."""
    log2_h = int(ta.shape[0]).bit_length() - 1
    qs = q[::HASHING_STEP]                    # (T,) strided seed keys
    t_valid = qs != SENTINEL
    bkt = jnp.where(t_valid, _bucket_of(qs, log2_h), 0)
    fp = _fp_of(qs)
    ea = ta[bkt]                              # gather 1
    eb = tb[bkt]                              # gather 2
    return _cost_given_probe(ea, eb, fp, t_valid, a, nn, key_len)


def _cost_given_probe(ea, eb, fp, t_valid, a, nn, key_len):
    """Marginal cost vector from already-gathered slot entries (the
    VPU-only tail of :func:`_pair_marginal_cost`)."""
    b = a.shape[0]
    hit_a = t_valid & (ea != _SLOT_SENT) & ((ea >> _POS_BITS) == fp)
    hit_b = t_valid & (eb >= 0) & ((eb >> _POS_BITS) == fp)
    hit = hit_a | hit_b
    rpos_t = jnp.where(
        hit_a, ea & ((1 << _POS_BITS) - 1), eb & ((1 << _POS_BITS) - 1)
    ).astype(jnp.int32)
    rpos_t = jnp.where(hit, rpos_t, 0)
    # strided coverage upsampled to full resolution: hit at strided
    # position 4t covers [4t, 4t + key_len); covered[i] == any hit in
    # [i - key_len + 1, i] == cum[i // 4] - cum[(i - key_len) // 4] > 0,
    # both terms as static-stride repeats (no gathers)
    cum = jnp.cumsum(hit.astype(jnp.int32))
    cum_rep = jnp.repeat(cum, HASHING_STEP, total_repeat_length=b)
    cum_shift = jnp.concatenate(
        [jnp.zeros(key_len, jnp.int32), cum_rep[:-key_len]]
    )
    covered = (cum_rep - cum_shift) > 0
    prev_cov = jnp.concatenate([jnp.zeros(1, bool), covered[:-1]])
    run_start = covered & ~prev_cov
    # diagonal at each run start (run starts land on strided hits)
    pos_full = jnp.arange(b, dtype=jnp.int32)
    rpos_rep = jnp.repeat(rpos_t, HASHING_STEP, total_repeat_length=b)
    diag = rpos_rep - (pos_full & ~jnp.int32(HASHING_STEP - 1))
    # previous run start's diagonal, gather-free: pack (position,
    # biased diag) so a cummax propagates the LATEST run start's value
    # (position is the high word, so later starts win), then shift by
    # one. cummax primitive, NOT associative_scan(maximum): the generic
    # scan unrolls log2(b) concat stages whose vmapped compile explodes
    # at 64x64k; cummax lowers to one reduce-window
    bias = jnp.int64(1) << 31
    packed_d = jnp.where(
        run_start,
        (pos_full.astype(jnp.int64) << 32) | (diag.astype(jnp.int64) + bias),
        jnp.int64(-1),
    )
    last = jax.lax.cummax(packed_d)
    prev_packed = jnp.concatenate([jnp.full(1, -1, jnp.int64), last[:-1]])
    prev_diag = jnp.where(
        prev_packed >= 0,
        (prev_packed & jnp.int64(0xFFFFFFFF)) - bias,
        0,
    ).astype(jnp.int32)
    dd = jnp.abs(diag - prev_diag)
    # match token ~ digits(|dpos|) + sign + ',' + len-field + '.'
    run_cost = _digits(dd) + 4
    prev_n = jnp.concatenate([jnp.zeros(1, bool), nn[:-1]])
    return (
        (a & ~covered).astype(jnp.int32)
        + jnp.where(run_start, run_cost, 0)
        + 4 * (nn & ~prev_n).astype(jnp.int32)
    )


def _shift_right(x: jnp.ndarray, k: int):
    """x shifted right along the last axis by k with zero fill."""
    if k <= 0:
        return x
    pad = jnp.zeros(x.shape[:-1] + (k,), x.dtype)
    return jnp.concatenate([pad, x[..., :-k]], axis=-1)


@partial(jax.jit, static_argnames=("key_len", "stride"))
def _estimate_kernel(
    keys_s: jnp.ndarray,    # (Q, T) u64 strided per-orientation seed keys
    a_lo: jnp.ndarray,      # (Q, T) i32 per-block ACGT counts, offsets < r
    a_hi: jnp.ndarray,      # (Q, T) i32 per-block ACGT counts, offsets >= r
    nrun_tot: jnp.ndarray,  # (Q,) i32 per-row N-run token cost
    rows: jnp.ndarray,      # (P,) i32: query row per pair
    cands: jnp.ndarray,     # (P,) i32: bank-matrix row per pair
    bta: jnp.ndarray,       # (R, H) i64 consolidated min slot tables
    btb: jnp.ndarray,       # (R, H) i64 consolidated max slot tables
    key_len: int,
    stride: int,
):
    """Approximate token-stream cost for each (segment-row, candidate)
    pair: literals = uncovered ACGT positions, matches = covered runs
    costed by their diagonal jump + average length field, N-runs ~4.
    Numerically identical to summing the full-resolution marginal
    vector (_pair_marginal_cost) at the same stride: coverage within a
    probe block changes only at offset r = key_len % stride, so the
    per-block ACGT split counts capture full-resolution literals.

    Candidate indexes are rows of one consolidated bank matrix; probes
    gather straight from its FLAT view at ``cand * H + bucket``. All
    per-pair arrays live on the probe grid (T = b/stride): the gathered
    element count is exactly 3 row-gathers + 2 probes per block,
    nothing full-res."""
    h = btb.shape[1]
    log2_h = int(h).bit_length() - 1
    t = keys_s.shape[1]
    qs = keys_s[rows]                         # (P, T)
    t_valid = qs != SENTINEL
    bkt = jnp.where(t_valid, _bucket_of(qs, log2_h), 0)
    # i32 flat indices: 64-bit index vectors gather measurably slower.
    # Past 2^31 flat elements (huge AGC_TPU_MATCH_BANK_BYTES) i32 would
    # silently wrap — the shape is static, so widen at trace time.
    if int(bta.shape[0]) * int(h) < (1 << 31):
        flat = cands[:, None] * jnp.int32(h) + bkt
    else:
        flat = (
            cands[:, None].astype(jnp.int64) * jnp.int64(h)
            + bkt.astype(jnp.int64)
        )
    ea = bta.reshape(-1)[flat]                # probe gather 1
    eb = btb.reshape(-1)[flat]                # probe gather 2
    fp = _fp_of(qs)
    hit_a = t_valid & (ea != _SLOT_SENT) & ((ea >> _POS_BITS) == fp)
    hit_b = t_valid & (eb >= 0) & ((eb >> _POS_BITS) == fp)
    hit = hit_a | hit_b
    rpos_t = jnp.where(
        hit_a, ea & ((1 << _POS_BITS) - 1), eb & ((1 << _POS_BITS) - 1)
    ).astype(jnp.int32)
    rpos_t = jnp.where(hit, rpos_t, 0)
    # block coverage: a hit at block u covers blocks [u, u+q0] fully and
    # offsets < r of block u+q0+1 (key_len = q0*stride + r)
    q0, r = divmod(key_len, stride)
    c = jnp.cumsum(hit.astype(jnp.int32), axis=1)
    cov_hi = (c - _shift_right(c, q0)) > 0          # offsets >= r
    cov_lo = (c - _shift_right(c, q0 + 1)) > 0       # offsets < r
    lits = jnp.sum(
        a_lo[rows] * (~cov_lo) + a_hi[rows] * (~cov_hi), axis=1
    )
    cov0 = cov_lo if r else cov_hi                   # offset-0 coverage
    run_start = cov0 & ~_shift_right(cov_hi, 1)
    tpos = jnp.arange(t, dtype=jnp.int32) * stride
    diag = rpos_t - tpos[None, :]
    # previous run start's diagonal, gather-free: pack (block, biased
    # diag) so a cummax propagates the LATEST run start's value, then
    # shift by one. cummax primitive, NOT associative_scan(maximum):
    # the generic scan's unrolled concat stages explode vmapped
    # compiles at 64x64k
    bias = jnp.int64(1) << 31
    packed_d = jnp.where(
        run_start,
        (jnp.arange(t, dtype=jnp.int64)[None, :] << 32)
        | (diag.astype(jnp.int64) + bias),
        jnp.int64(-1),
    )
    last = jax.lax.cummax(packed_d, axis=1)
    prev_packed = jnp.concatenate(
        [jnp.full((last.shape[0], 1), -1, jnp.int64), last[:, :-1]], axis=1
    )
    prev_diag = jnp.where(
        prev_packed >= 0,
        (prev_packed & jnp.int64(0xFFFFFFFF)) - bias,
        0,
    ).astype(jnp.int32)
    dd = jnp.abs(diag - prev_diag)
    run_cost = jnp.where(run_start, _digits(dd) + 4, 0)
    return lits + jnp.sum(run_cost, axis=1) + nrun_tot[rows]


@partial(jax.jit, static_argnames=("key_len", "o1_rc", "o2_rc"))
def _split_point_kernel(
    keys: jnp.ndarray,   # (2, b) u64: row 0 dir, row 1 rc
    acgt: jnp.ndarray,
    isn: jnp.ndarray,
    n: jnp.ndarray,      # () i32 true segment length
    ta1: jnp.ndarray, tb1: jnp.ndarray,   # group-1 slot tables
    ta2: jnp.ndarray, tb2: jnp.ndarray,   # group-2 slot tables
    key_len: int,
    o1_rc: bool,         # group 1 encodes the RC text
    o2_rc: bool,
):
    """Cost-optimal split position for the missing-middle search: V1(i) =
    cost of encoding the first i DIR symbols against ref1 (in group 1's
    orientation) + V2(i) = cost of the remaining suffix against ref2;
    returns argmin_i V1+V2 over i in [0, n] — the device twin of the two
    GetCodingCostVector walks + cumulative-sum argmin (reference:
    find_cand_segment_with_missing_middle_splitter,
    agc_compressor.cpp:1502-1627)."""
    b = keys.shape[1]
    r1 = 1 if o1_rc else 0
    r2 = 1 if o2_rc else 0
    c1 = _pair_marginal_cost(
        keys[r1], acgt[r1], isn[r1], ta1, tb1, key_len
    )
    c2 = _pair_marginal_cost(
        keys[r2], acgt[r2], isn[r2], ta2, tb2, key_len
    )
    z = jnp.zeros(1, jnp.int32)
    cum1 = jnp.concatenate([z, jnp.cumsum(c1)])   # (b+1,) inclusive-prefix
    cum2 = jnp.concatenate([z, jnp.cumsum(c2)])
    i = jnp.arange(b + 1, dtype=jnp.int32)
    ni = jnp.clip(n - i, 0, b)
    if o1_rc:
        # first i dir symbols = last i of the RC text
        v1 = cum1[n] - cum1[ni]
    else:
        v1 = cum1[i]
    if o2_rc:
        # dir suffix from i = first n-i of the RC text
        v2 = cum2[ni]
    else:
        v2 = cum2[n] - cum2[jnp.minimum(i, n)]
    total = jnp.where(i <= n, v1 + v2, jnp.int32(2**30))
    return jnp.argmin(total).astype(jnp.int32)


# ---------------------------------------------------------------------------
# host-side twin (the spec; used by tests and as the no-device fallback)
# ---------------------------------------------------------------------------


def _key_at(codes: np.ndarray, j: int, key_len: int) -> int | None:
    w = codes[j : j + key_len]
    if len(w) < key_len or np.any(w > 3):
        return None
    x = 0
    for s in w.tolist():
        x = (x << 2) | int(s)
    return x


def build_slot_tables_np(ref_codes: np.ndarray, key_len: int):
    """Numpy twin of :func:`_ref_index_kernel`: dual min/max slot tables
    over seed keys sampled every HASHING_STEP positions, with the SAME
    bucket geometry as the device bank (ref padded to its pow2 bucket,
    H = 2 x sampled count)."""
    b = _pow4(len(ref_codes), _MIN_REF_KEY_BUCKET * 2)
    log2_h = (b // HASHING_STEP * 2).bit_length() - 1
    h = 1 << log2_h
    ta = np.full(h, _SLOT_SENT, dtype=np.int64)
    tb = np.full(h, -1, dtype=np.int64)
    for j in range(0, len(ref_codes) - key_len + 1, HASHING_STEP):
        x = _key_at(ref_codes, j, key_len)
        if x is None:
            continue
        bkt = ((x * _HASH_MUL) % (1 << 64)) >> (64 - log2_h)
        fp = ((x * _FP_MUL) % (1 << 64)) >> (64 - _FP_BITS)
        packed = (fp << _POS_BITS) | j
        ta[bkt] = min(int(ta[bkt]), packed)
        tb[bkt] = max(int(tb[bkt]), packed)
    return ta, tb, log2_h


def marginal_cost_np(
    seg_codes: np.ndarray,
    ref_codes: np.ndarray,
    key_len: int,
    stride: int = HASHING_STEP,
) -> np.ndarray:
    """Numpy twin of :func:`_pair_marginal_cost` for one (segment,
    candidate) pair (direct orientation): per-position marginal token
    cost. Byte-identical to the kernel on the same inputs (same slot
    tables, same strided probes, same upsampled coverage). The batched
    estimate kernel's scalar result equals this vector's sum at the
    same ``stride``."""
    n = len(seg_codes)
    out = np.zeros(n, dtype=np.int64)
    nmask = seg_codes > 3
    prev_n = np.concatenate([[False], nmask[:-1]])
    out += 4 * (nmask & ~prev_n)
    if n < key_len:
        out += (seg_codes <= 3).astype(np.int64)
        return out
    ta, tb, log2_h = build_slot_tables_np(ref_codes, key_len)
    # strided probes
    t_count = (n + stride - 1) // stride
    hit = np.zeros(t_count, dtype=bool)
    rpos_t = np.zeros(t_count, dtype=np.int64)
    for t in range(t_count):
        x = _key_at(seg_codes, t * stride, key_len)
        if x is None:
            continue
        bkt = ((x * _HASH_MUL) % (1 << 64)) >> (64 - log2_h)
        fp = ((x * _FP_MUL) % (1 << 64)) >> (64 - _FP_BITS)
        ea, eb = int(ta[bkt]), int(tb[bkt])
        if ea != _SLOT_SENT and (ea >> _POS_BITS) == fp:
            hit[t] = True
            rpos_t[t] = ea & ((1 << _POS_BITS) - 1)
        elif eb >= 0 and (eb >> _POS_BITS) == fp:
            hit[t] = True
            rpos_t[t] = eb & ((1 << _POS_BITS) - 1)
    cum = np.cumsum(hit.astype(np.int64))
    cum_rep = np.repeat(cum, stride)[:n]
    cum_shift = np.concatenate([np.zeros(key_len, np.int64), cum_rep[:-key_len]])
    covered = (cum_rep - cum_shift) > 0
    prev_cov = np.concatenate([[False], covered[:-1]])
    run_start = covered & ~prev_cov
    rpos_rep = np.repeat(rpos_t, stride)[:n]
    diag = rpos_rep - (np.arange(n) // stride) * stride
    prev_diag = 0
    for i in np.flatnonzero(run_start).tolist():
        dd = abs(int(diag[i]) - prev_diag)
        out[i] += len(str(dd)) + 4
        prev_diag = int(diag[i])
    out += (seg_codes <= 3) & ~covered
    return out


def estimate_np(
    seg_codes: np.ndarray, ref_codes: np.ndarray, key_len: int
) -> int:
    """Numpy twin of one (segment, candidate) device estimate (direct
    orientation). Byte-identical to the kernel on the same inputs."""
    return int(
        marginal_cost_np(
            seg_codes, ref_codes, key_len, stride=probe_stride(key_len)
        ).sum()
    )


def split_point_np(
    seg_codes: np.ndarray,
    ref1: np.ndarray, o1_rc: bool,
    ref2: np.ndarray, o2_rc: bool,
    key_len: int,
) -> int:
    """Numpy twin of :func:`_split_point_kernel` (same V1/V2 definitions)."""
    n = len(seg_codes)
    rc = seg_codes[::-1].copy()
    m = rc <= 3
    rc[m] = 3 - rc[m]
    c1 = marginal_cost_np(rc if o1_rc else seg_codes, ref1, key_len)
    c2 = marginal_cost_np(rc if o2_rc else seg_codes, ref2, key_len)
    cum1 = np.concatenate([[0], np.cumsum(c1)])
    cum2 = np.concatenate([[0], np.cumsum(c2)])
    i = np.arange(n + 1)
    v1 = (cum1[n] - cum1[n - i]) if o1_rc else cum1[i]
    v2 = cum2[n - i] if o2_rc else (cum2[n] - cum2[i])
    return int(np.argmin(v1 + v2))


# ---------------------------------------------------------------------------
# device-resident reference bank
# ---------------------------------------------------------------------------


class RefBank:
    """Device-resident dictionary of group-reference seed indexes.

    One entry per group id: dual min/max HASH-SLOT tables ``(ta, tb, h)``
    on device — ``ta[bucket]`` holds the minimum (fingerprint, position)
    packed entry hashing to that bucket, ``tb[bucket]`` the maximum —
    built by :func:`_ref_index_kernel` from a single upload of the
    reference codes (see the module docstring: slot probes, not sorted
    lookups). LRU-evicted to ``budget_bytes`` of device memory. The
    reference's analogue is each CSegment's in-RAM LZ hash table
    (segment.h:27-70) — here the bank is the persistent, device-side
    half of that state.

    Entries sharing a key-count bucket ``m`` are additionally kept
    CONSOLIDATED in one (R, m) device matrix per bucket (appended in one
    concatenate per dispatch, rebuilt after eviction), so a batched
    estimate gathers candidate rows on device instead of the host
    stacking hundreds of arrays in eager per-array dispatches."""

    def __init__(self, key_len: int, budget_bytes: int | None = None):
        self.key_len = key_len
        self.budget = budget_bytes or int(
            os.environ.get("AGC_TPU_MATCH_BANK_BYTES", str(2 << 30))
        )
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        # bucket m -> [built_sk (R,m), built_sp (R,m), row_gids list]
        self._built: dict[int, list] = {}
        self._row_of: dict[int, tuple[int, int]] = {}  # gid -> (m, row)
        self._bytes = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, gid: int, codes_provider):
        """Return (sk, sp, m_bucket) for group ``gid``, building the
        index from ``codes_provider()`` (numeric reference codes) on
        first use. Returns None when the provider has no codes."""
        with self._lock:
            e = self._entries.get(gid)
            if e is not None:
                self._entries.move_to_end(gid)
                return e
        codes = codes_provider()
        if (
            codes is None
            or len(codes) < self.key_len + HASHING_STEP
            or len(codes) >= (1 << _POS_BITS)  # pos field width
        ):
            return None
        arr = np.frombuffer(bytes(codes), dtype=np.uint8)
        b = _pow4(len(arr), _MIN_REF_KEY_BUCKET * 2)
        padded = np.full(b, 255, dtype=np.uint8)
        padded[: len(arr)] = arr
        packed = jnp.asarray(pack4_np(padded))
        # H = 2 x sampled-key count (load 0.5)
        log2_h = (b // HASHING_STEP * 2).bit_length() - 1
        ta, tb = _ref_index_kernel(packed, self.key_len, log2_h)
        with self._lock:
            # _insert_locked keeps the first entry on insert races and
            # runs the LRU eviction loop (stale consolidated rows drop
            # their bucket for a lazy rebuild at next use)
            self._insert_locked(gid, ta, tb)
            return self._entries[gid]

    def _insert_locked(self, gid: int, ta, tb) -> None:
        """Register one built entry + run the LRU eviction loop; caller
        holds the lock."""
        if gid in self._entries:
            self._entries.move_to_end(gid)
            return
        self._entries[gid] = (ta, tb, int(ta.shape[0]))
        self._bytes += int(ta.size) * 16
        while self._bytes > self.budget and len(self._entries) > 1:
            ogid, (ota, _otb, om) = self._entries.popitem(last=False)
            self._bytes -= int(ota.size) * 16
            if self._row_of.pop(ogid, None) is not None:
                blt = self._built.pop(om, None)
                if blt is not None:
                    self._bytes -= int(blt[0].size) * 16
                    for g in blt[2]:
                        self._row_of.pop(g, None)

    _GET_MANY_ROWS = 64  # per-dispatch row cap (bounds transient memory)

    def get_many(self, gids, codes_provider) -> None:
        """Build the indexes of every missing gid in BATCHED dispatches
        (refs stacked per padded-length bucket, one vmapped index build
        per chunk) instead of one upload + kernel round-trip per group,
        so cold-start misses amortize the per-dispatch cost. Safe to call
        concurrently; losers of insert races keep the first entry."""
        with self._lock:
            missing = sorted(
                {g for g in gids if g not in self._entries}
            )
        if not missing:
            return
        by_b: dict[int, list] = {}
        for g in missing:
            codes = codes_provider(g)
            if (
                codes is None
                or len(codes) < self.key_len + HASHING_STEP
                or len(codes) >= (1 << _POS_BITS)
            ):
                continue
            arr = np.frombuffer(bytes(codes), dtype=np.uint8)
            b = _pow4(len(arr), _MIN_REF_KEY_BUCKET * 2)
            by_b.setdefault(b, []).append((g, arr))
        for b, items in sorted(by_b.items()):
            log2_h = (b // HASHING_STEP * 2).bit_length() - 1
            kern = _ref_index_kernel
            for lo in range(0, len(items), self._GET_MANY_ROWS):
                chunk = items[lo : lo + self._GET_MANY_ROWS]
                mat = np.full((len(chunk), b), 255, dtype=np.uint8)
                for j, (_g, arr) in enumerate(chunk):
                    mat[j, : len(arr)] = arr
                packed = jnp.asarray(
                    pack4_np(mat.reshape(-1)).reshape(len(chunk), b // 2)
                )
                ta, tb = jax.vmap(
                    lambda p: kern(p, self.key_len, log2_h)
                )(packed)
                with self._lock:
                    for j, (g, _arr) in enumerate(chunk):
                        self._insert_locked(g, ta[j], tb[j])

    def rows_for(self, gids_entries: list) -> tuple[list[int], object, object]:
        """Consolidated-matrix rows for each (gid, (ta, tb, h)) — all of
        one slot-width bucket — plus the bucket's consolidated (min, max)
        slot matrices, returned under the SAME lock acquisition (a
        concurrent eviction between a rows_for and a separate built()
        read could drop the bucket). Missing rows are appended in ONE
        device update; duplicate gids in the call collapse to one row."""
        with self._lock:
            seen: set[int] = set()
            missing = []
            for g, e in gids_entries:
                if g not in self._row_of and g not in seen:
                    seen.add(g)
                    missing.append((g, e))
            if missing:
                m = missing[0][1][2]
                blt = self._built.get(m)
                stack_sk = jnp.stack([e[0] for _, e in missing])
                stack_sp = jnp.stack([e[1] for _, e in missing])
                base = len(blt[2]) if blt is not None else 0
                need = base + len(missing)
                if blt is None:
                    cap = _pow4(need, 64)
                    blt = [
                        jnp.full((cap, m), _SLOT_SENT, dtype=jnp.int64),
                        jnp.full((cap, m), -1, dtype=jnp.int64),
                        [],
                    ]
                    self._built[m] = blt
                    self._bytes += cap * m * 16
                elif need > blt[0].shape[0]:
                    # capacity stays pow2 so the estimate kernel's
                    # (R, m) shape — and its compiled variant — is
                    # stable across appends
                    old_cap = blt[0].shape[0]
                    cap = _pow4(need, old_cap * 4)
                    pad = cap - old_cap
                    blt[0] = jnp.concatenate(
                        [blt[0], jnp.full((pad, m), _SLOT_SENT, jnp.int64)]
                    )
                    blt[1] = jnp.concatenate(
                        [blt[1], jnp.full((pad, m), -1, jnp.int64)]
                    )
                    self._bytes += pad * m * 16
                blt[0] = jax.lax.dynamic_update_slice(
                    blt[0], stack_sk, (base, 0)
                )
                blt[1] = jax.lax.dynamic_update_slice(
                    blt[1], stack_sp, (base, 0)
                )
                for i, (g, _e) in enumerate(missing):
                    self._row_of[g] = (m, base + i)
                blt[2].extend(g for g, _ in missing)
            rows = [self._row_of[g][1] for g, _ in gids_entries]
            m_all = self._row_of[gids_entries[0][0]][0]
            blt = self._built[m_all]
            return rows, blt[0], blt[1]

    def drop(self, gid: int) -> None:
        with self._lock:
            e = self._entries.pop(gid, None)
            if e is not None:
                self._bytes -= int(e[0].size) * 16
            r = self._row_of.pop(gid, None)
            if r is not None:
                blt = self._built.pop(r[0], None)
                if blt is not None:
                    self._bytes -= int(blt[0].size) * 16
                    for g in blt[2]:
                        self._row_of.pop(g, None)


# ---------------------------------------------------------------------------
# batched estimation driver
# ---------------------------------------------------------------------------


class MatchQuery:
    """One segment's candidate search: ``codes`` (numeric, direct
    orientation) and ``cands`` = [(gid, use_rc), ...]. ``ests`` is
    filled by :func:`estimate_batch` in candidate order (np.int32)."""

    __slots__ = ("codes", "cands", "ests", "tag")

    def __init__(self, codes: np.ndarray, cands, tag=None):
        self.codes = codes
        self.cands = list(cands)
        self.ests: np.ndarray | None = None
        self.tag = tag


def estimate_batch(queries: list[MatchQuery], bank: RefBank, ref_codes_of):
    """Estimate every (query, candidate) pair on device in bucketed
    dispatches; fills ``q.ests`` in-place. Pairs whose group reference
    is unavailable (still packed from appending) get estimate 0 — the
    same zero the host path reports for packed groups
    (reference: CSegment::estimate, segment.cpp:83-85).

    Queries are bucketed by a 4x segment-length ladder, and each bucket
    runs in FIXED-shape chunks (one row count and one pair count per
    ladder class, ~4 M query symbols and ~16 M probe-grid pairs per
    dispatch) — the estimate path's entire reachable shape set per
    workload is then a handful of executables instead of the pow2 x
    pow2 x pow2 product that cost >30 min of first-touch compiles in
    round 3 (see _pow4)."""
    live = [q for q in queries if q.cands]
    if not live:
        return
    by_len: dict[int, list[MatchQuery]] = {}
    for q in live:
        by_len.setdefault(_pow4(len(q.codes), _MIN_SEG_BUCKET), []).append(q)
    for seg_b, qs in by_len.items():
        rows_fixed = max(1, (4 << 20) // seg_b)
        for lo in range(0, len(qs), rows_fixed):
            _estimate_bucket(
                qs[lo : lo + rows_fixed], bank, ref_codes_of, seg_b,
                rows_fixed,
            )


def _estimate_bucket(
    live: list[MatchQuery], bank: RefBank, ref_codes_of, seg_b: int,
    rows_fixed: int | None = None,
):
    key_len = bank.key_len
    s_bucket = rows_fixed or _pow2(len(live), 1)
    mat = np.full((s_bucket, seg_b), 255, dtype=np.uint8)
    lens = np.zeros(s_bucket, dtype=np.int32)
    for i, q in enumerate(live):
        mat[i, : len(q.codes)] = q.codes
        lens[i] = len(q.codes)
    packed = jnp.asarray(pack4_np(mat.reshape(-1)).reshape(s_bucket, seg_b // 2))
    stride = probe_stride(key_len)
    keys_s, a_lo, a_hi, nrun_tot = _seg_rows_strided_kernel(
        packed, jnp.asarray(lens), key_len, stride
    )

    # gather pairs, grouped by the candidate index's bucket size;
    # missing group indexes build batched first (one vmapped dispatch
    # per length bucket, not one round-trip per group)
    bank.get_many(
        [gid for q in live for gid, _rc in q.cands], ref_codes_of
    )
    by_bucket: dict[int, list] = {}
    for qi, q in enumerate(live):
        q.ests = np.zeros(len(q.cands), dtype=np.int64)
        for ci, (gid, use_rc) in enumerate(q.cands):
            entry = bank.get(gid, lambda g=gid: ref_codes_of(g))
            if entry is None:
                continue
            m = entry[2]
            by_bucket.setdefault(m, []).append(
                (qi * 2 + (1 if use_rc else 0), gid, entry, q, ci)
            )
    results = []  # (device ests, items) — one blocking download at the end
    # fixed pair count per seg class: ~16M probe-grid elements/dispatch
    p_fixed = max(64, (64 << 20) // seg_b)
    for m, all_items in by_bucket.items():
        crows, bsk, bsp = bank.rows_for(
            [(gid, e) for _row, gid, e, _q, _ci in all_items]
        )
        for lo in range(0, len(all_items), p_fixed):
            items = all_items[lo : lo + p_fixed]
            rows = np.zeros(p_fixed, dtype=np.int32)
            cands = np.zeros(p_fixed, dtype=np.int32)
            for j, (row, _gid, _e, _q, _ci) in enumerate(items):
                rows[j] = row
                cands[j] = crows[lo + j]
            ests = _estimate_kernel(
                keys_s, a_lo, a_hi, nrun_tot,
                jnp.asarray(rows), jnp.asarray(cands), bsk, bsp,
                key_len, stride,
            )
            results.append((ests, items))
    for ests, items in results:
        ests = np.asarray(ests)
        for j, (_row, _gid, _e, q, ci) in enumerate(items):
            q.ests[ci] = int(ests[j])


# ---------------------------------------------------------------------------
# anchor-encode tables (device leg of the anchor-mode LZ encoder)
# ---------------------------------------------------------------------------

_ANCHOR_NDIAG = 32
_I32_MISS = -(1 << 31)


@partial(jax.jit, static_argnames=("key_len",))
def _anchor_join_kernel(tpacked, rrows, rowidx, key_len: int):
    """Sort-merge join of each text's STRIDED seed keys against its
    group reference's DENSE keys, per pair: one lexicographic sort of
    (key, tag, pos) triples + segmented min/max propagation replaces
    hash tables entirely — no scatters to build an index, no random
    gathers to probe it, no fingerprint collisions. Dense ref keys
    keep every indel shift discoverable under stride-4 text probing.

    Returns (S, K) int32 diagonals of every (text key occurrence,
    min/max ref occurrence) pair, _I32_MISS elsewhere — unordered, as
    :func:`_anchor_select_kernel`'s histogram input. C++ twin:
    lz_anchor_diags (exact min/max occurrence map)."""
    rsel = rrows[rowidx]  # contiguous row gather (S, br/2)

    def one(tp, rp):
        tcodes = _unpack4_dev(tp)
        rcodes = _unpack4_dev(rp)
        tk, _tv = _start_keys(tcodes, key_len)
        tk = tk[::HASHING_STEP]
        rk, _rv = _start_keys(rcodes, key_len)
        bt_s = tk.shape[0]
        br = rk.shape[0]
        keys = jnp.concatenate([rk, tk])  # invalid keys are SENTINEL
        tag = jnp.concatenate(
            [jnp.zeros(br, jnp.int32), jnp.ones(bt_s, jnp.int32)]
        )
        pos = jnp.concatenate(
            [
                jnp.arange(br, dtype=jnp.int32),
                jnp.arange(bt_s, dtype=jnp.int32) * HASHING_STEP,
            ]
        )
        sk, stag, spos = jax.lax.sort(
            (keys, tag, pos), num_keys=2, is_stable=True
        )
        newrun = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
        run_id = jnp.cumsum(newrun.astype(jnp.int64)) - 1
        valid = sk != SENTINEL
        is_ref = valid & (stag == 0)
        posmask = jnp.int64((1 << _POS_BITS) - 1)
        sp64 = spos.astype(jnp.int64)
        # refs sort before texts within a key run (tag is the second
        # sort key), so a forward cummax sees every ref of the run
        # before any text entry reads it
        mx = jnp.where(
            is_ref, (run_id << _POS_BITS) | sp64, jnp.int64(-1)
        )
        cmx = jax.lax.cummax(mx)
        mn = jnp.where(
            is_ref, (run_id << _POS_BITS) | (posmask - sp64), jnp.int64(-1)
        )
        cmn = jax.lax.cummax(mn)
        is_text = valid & (stag == 1)
        ok_a = is_text & (cmn >= 0) & ((cmn >> _POS_BITS) == run_id)
        ok_b = is_text & (cmx >= 0) & ((cmx >> _POS_BITS) == run_id)
        da = jnp.where(
            ok_a,
            (posmask - (cmn & posmask)).astype(jnp.int32) - spos,
            jnp.int32(_I32_MISS),
        )
        db = jnp.where(
            ok_b,
            (cmx & posmask).astype(jnp.int32) - spos,
            jnp.int32(_I32_MISS),
        )
        return jnp.concatenate([da, db])

    return jax.vmap(one)(tpacked, rsel)


class AnchorCodeBank:
    """Device-resident nibble-packed group-reference CODES for the
    anchor join kernel, consolidated per pow2-length bucket (one
    (R, b/2) uint8 matrix per bucket — ~32 KB per 60 kb group, 60x
    lighter than slot tables). The join kernel re-derives keys from
    codes each dispatch (cheap vector ladders); only uploads are
    cached."""

    def __init__(self):
        self._buckets: dict[int, list] = {}  # b -> [mat (R,b/2), gids]
        self._row_of: dict[int, tuple[int, int]] = {}  # gid -> (b, row)
        self._len: dict[int, int] = {}
        self._refused: set[int] = set()
        self._lock = threading.Lock()

    def get_many(self, gids, codes_provider, key_len: int) -> None:
        with self._lock:
            missing = sorted(
                {
                    g
                    for g in gids
                    if g not in self._row_of and g not in self._refused
                }
            )
        if not missing:
            return
        by_b: dict[int, list] = {}
        refused = []
        for g in missing:
            codes = codes_provider(g)
            if (
                codes is None
                or len(codes) < key_len + HASHING_STEP
                or len(codes) >= (1 << _POS_BITS)
            ):
                refused.append(g)
                continue
            arr = np.frombuffer(bytes(codes), dtype=np.uint8)
            by_b.setdefault(_pow4(len(arr), _MIN_SEG_BUCKET), []).append(
                (g, arr)
            )
        for b, items in sorted(by_b.items()):
            mat_np = np.full((len(items), b), 255, dtype=np.uint8)
            lens = []
            for j, (_g, arr) in enumerate(items):
                mat_np[j, : len(arr)] = arr
                lens.append(len(arr))
            packed = jnp.asarray(
                pack4_np(mat_np.reshape(-1)).reshape(len(items), b // 2)
            )
            with self._lock:
                blt = self._buckets.get(b)
                if blt is None:
                    self._buckets[b] = [packed, [g for g, _ in items]]
                else:
                    blt[0] = jnp.concatenate([blt[0], packed])
                    blt[1].extend(g for g, _ in items)
                blt = self._buckets[b]
                base = len(blt[1]) - len(items)
                for j, (g, _arr) in enumerate(items):
                    if g not in self._row_of:
                        self._row_of[g] = (b, base + j)
                        self._len[g] = lens[j]
        with self._lock:
            self._refused.update(refused)

    def lookup(self, gid: int):
        """-> (bucket, row) or None (unavailable / out of bounds)."""
        with self._lock:
            return self._row_of.get(gid)

    def bucket_mat(self, b: int):
        with self._lock:
            return self._buckets[b][0]




@jax.jit
def _anchor_select_kernel(allv):
    """Top-32 diagonal set per text row (count desc, diag asc — the
    C++ twin's stable_sort order) from a MISS-padded array of hit
    diagonals. Histogram built free of scatters: sort the diagonals,
    run-length count, composite-key sort for the top-K. Only the SET
    leaves the device (128 bytes per segment): the host emitter
    rediscovers anchors by byte equality against each diagonal, so no
    per-position table pays the download tax."""
    s, n2 = allv.shape
    miss = allv == _I32_MISS
    key = jnp.where(miss, jnp.int32((1 << 31) - 1), allv)
    sv = jnp.sort(key, axis=1)
    is_max = sv == jnp.int32((1 << 31) - 1)
    first = (
        jnp.concatenate(
            [jnp.ones((s, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
        )
        & ~is_max
    )
    idx = jnp.arange(n2, dtype=jnp.int32)[None, :]
    prev_max = jnp.concatenate(
        [jnp.zeros((s, 1), bool), is_max[:, :-1]], axis=1
    )
    boundary = first | (is_max & ~prev_max)
    bpos = jnp.where(boundary, idx, jnp.int32(n2))
    # next boundary strictly after i (exclusive reverse cummin)
    rev = bpos[:, ::-1]
    nxt = jax.lax.cummin(
        jnp.concatenate(
            [jnp.full((s, 1), n2, jnp.int32), rev[:, :-1]], axis=1
        ),
        axis=1,
    )[:, ::-1]
    counts = jnp.where(first, nxt - idx, 0)
    rk = jnp.int64(1 << 31) - sv.astype(jnp.int64)  # diag asc -> rk desc
    comp = jnp.where(
        first, (counts.astype(jnp.int64) << 32) | rk, jnp.int64(-1)
    )
    top = jnp.sort(comp, axis=1)[:, ::-1][:, :_ANCHOR_NDIAG]
    dsel = jnp.where(
        top >= 0,
        (jnp.int64(1 << 31) - (top & jnp.int64(0xFFFFFFFF))).astype(
            jnp.int32
        ),
        jnp.int32(_I32_MISS),
    )

    return dsel


def anchor_diag_sets(texts: list, gids: list, bank: AnchorCodeBank,
                     ref_codes_of, key_len: int):
    """Batched device anchor diagonal sets for (text, group) pairs:
    uploads the texts nibble-packed, sort-merge joins each against its
    group's cached reference codes (:func:`_anchor_join_kernel`), and
    selects per-text top-32 diagonal sets — the discovery half of the
    anchor-mode encoder in a few dispatches, downloading 128 BYTES per
    segment. Returns per pair an int32[32] diagonal array
    (INT32_MIN-padded) or None when the group's reference is
    unavailable / out of anchor bounds (the caller then uses the host
    twin or the classic encoder — the RULE decides, not the engine)."""
    out: list = [None] * len(texts)
    bank.get_many(gids, ref_codes_of, key_len)
    by: dict[tuple[int, int], list] = {}
    for i, (txt, gid) in enumerate(zip(texts, gids)):
        n = len(txt)
        if n >= (1 << _POS_BITS) or n == 0:
            continue
        loc = bank.lookup(gid)
        if loc is None:
            continue
        by.setdefault((_pow4(n, _MIN_SEG_BUCKET), loc[0]), []).append(
            (i, txt, loc[1])
        )
    for (seg_b, ref_b), items in sorted(by.items()):
        rrows = bank.bucket_mat(ref_b)
        s_bucket = _pow2(len(items), 1)
        mat = np.full((s_bucket, seg_b), 255, dtype=np.uint8)
        rows = np.zeros(s_bucket, dtype=np.int32)
        for j, (_i, txt, row) in enumerate(items):
            mat[j, : len(txt)] = np.frombuffer(bytes(txt), dtype=np.uint8)
            rows[j] = row
        packed = jnp.asarray(
            pack4_np(mat.reshape(-1)).reshape(s_bucket, seg_b // 2)
        )
        dd = _anchor_join_kernel(packed, rrows, jnp.asarray(rows), key_len)
        dsel = np.asarray(_anchor_select_kernel(dd))
        for j, (i, _txt, _row) in enumerate(items):
            out[i] = dsel[j]
    return out


def split_point_device(
    codes: np.ndarray,
    bank: RefBank,
    gid1: int, o1_rc: bool,
    gid2: int, o2_rc: bool,
    ref_codes_of,
) -> int | None:
    """Missing-middle split position on device (see
    :func:`_split_point_kernel`); None when either group's reference is
    unavailable (packed from appending — the host path then applies its
    own packed-group rules, agc_compressor.cpp:1605-1608)."""
    e1 = bank.get(gid1, lambda: ref_codes_of(gid1))
    e2 = bank.get(gid2, lambda: ref_codes_of(gid2))
    if e1 is None or e2 is None:
        return None
    key_len = bank.key_len
    b = _pow4(len(codes), _MIN_SEG_BUCKET)
    mat = np.full((1, b), 255, dtype=np.uint8)
    mat[0, : len(codes)] = codes
    packed = jnp.asarray(pack4_np(mat.reshape(-1)).reshape(1, b // 2))
    keys, acgt, isn = _seg_rows_kernel(
        packed, jnp.asarray([len(codes)], dtype=np.int32), key_len
    )
    pos = _split_point_kernel(
        keys, acgt, isn, jnp.int32(len(codes)),
        e1[0], e1[1], e2[0], e2[1],
        key_len, bool(o1_rc), bool(o2_rc),
    )
    return int(pos)


def shortlist(ests: np.ndarray, margin: float, extra: int) -> list[int]:
    """Candidate indices the host must exact-estimate: everything within
    ``margin`` of the device minimum, plus the next ``extra`` best — the
    device ranks, the host decides (ratio parity with the host-only
    path whenever the true argmin is inside the list)."""
    if not len(ests):
        return []
    order = np.argsort(ests, kind="stable")
    best = int(ests[order[0]])
    cut = best * (1.0 + margin) + 32
    window = [int(i) for i in order if ests[i] <= cut]
    tail = [int(i) for i in order if ests[i] > cut][: max(0, extra)]
    return window + tail
