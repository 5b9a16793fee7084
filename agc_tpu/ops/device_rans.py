"""Device (XLA) implementation of the lane-interleaved rANS coder.

Byte-exact with the host spec in ``core/entropy.py`` — same state
machine, same lane interleave, same blob assembly. The device runs the
per-symbol lockstep loop over all lanes as one ``lax.scan``:

- **encode**: scans the (steps, L) symbol grid in reverse. Each step
  emits at most 2 renorm bytes per lane, returned as scan outputs
  ``(bytes[steps, L, 2], counts[steps, L])`` — the kernel performs NO
  scatters; the ragged per-lane streams are packed (and reversed into
  decode order) by the caller with two numpy masks. Table lookups are
  ``take`` into the 256-entry frequency/cumulative tables.
- **decode**: scans forward; the symbol is recovered gather-free as
  ``sum(cum <= slot)`` (a (L,256) compare + row reduce);
  the only data-dependent access is the per-lane byte-stream cursor
  (``take_along_axis`` on the (L, max_len) byte matrix).

All state arithmetic is uint32 (x in [2^23, 2^31), products bounded by
2^31), so no 64-bit arithmetic is needed.

The frequency table is always quantized on the HOST
(entropy.quantize_freqs): it is 256 integers and its construction is
branchy; both implementations consume the identical table, which is what
makes their bitstreams byte-equal.
"""

from __future__ import annotations

import numpy as np

from ..core import entropy as E


def _jx():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _bucket(v: int) -> int:
    """Pow2 bucket for jit-cache keys: steps/max_len are data-dependent,
    so unbucketed shapes would recompile per part length (a compile
    costs far more than the kernel) — same convention as
    ops/kmers.py's pow2 padding."""
    return max(8, 1 << max(0, int(v - 1)).bit_length())


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@__import__("functools").lru_cache(maxsize=64)
def _encode_fn(steps: int, L: int):
    jax, jnp = _jx()

    def body(grid_rev, freqs, cum):
        def step(carry, sym_row):
            x = carry
            active = sym_row < 256  # padded grid slots carry 256
            s = jnp.where(active, sym_row, 0).astype(jnp.int32)
            f = jnp.where(active, jnp.take(freqs, s), jnp.uint32(1))
            c = jnp.take(cum, s)
            x_max = jnp.uint32((E.RANS_L >> E.PROB_BITS) << 8) * f
            b = jnp.zeros((L, 2), dtype=jnp.uint8)
            cnt = jnp.zeros((L,), dtype=jnp.int32)
            for i in range(2):  # encode renorm emits at most 2 bytes
                emit = active & (x >= x_max)
                b = b.at[:, i].set(
                    jnp.where(emit, (x & 0xFF).astype(jnp.uint8), 0)
                )
                cnt = cnt + emit.astype(jnp.int32)
                x = jnp.where(emit, x >> 8, x)
            nx = ((x // f) << E.PROB_BITS) + (x % f) + c
            x = jnp.where(active, nx, x)
            return x, (b, cnt)

        x0 = jnp.full((L,), E.RANS_L, dtype=jnp.uint32)
        x, (bts, cnts) = jax.lax.scan(step, x0, grid_rev)
        return x, bts, cnts

    return jax.jit(body)


def compress_device(data: bytes, level: int = 0) -> bytes:
    """Device-path twin of entropy.compress (identical blobs)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    header = bytearray([E.MAGIC, 0])
    E._put_varint(header, n)
    if n == 0:
        return bytes(header)

    counts = np.bincount(arr, minlength=256)
    freqs = E.quantize_freqs(counts)
    F, C = E._tables(freqs)

    L = E.lanes_for(n)
    steps = _bucket((n + L - 1) // L)  # padded rows are inactive slots
    grid = np.full(steps * L, 256, dtype=np.int32)  # 256 = padded slot
    grid[:n] = arr
    grid = grid.reshape(steps, L)[::-1]  # reversed for the encode scan

    fn = _encode_fn(steps, L)
    x, bts, cnts = fn(
        np.ascontiguousarray(grid),
        F.astype(np.uint32),
        C[:256].astype(np.uint32),
    )
    x = np.asarray(x)
    bts = np.asarray(bts)  # (steps, L, 2) in reversed-step order
    cnts = np.asarray(cnts)

    # ragged pack: per lane, bytes in emission order then reversed.
    # the scan ran t = steps-1 .. 0, so scan-order IS emission order.
    streams = []
    for j in range(L):
        cj = cnts[:, j]
        bj = bts[:, j, :]
        mask = np.arange(2)[None, :] < cj[:, None]
        streams.append(bj[mask][::-1].tobytes())
    return E.assemble_blob(data, freqs, streams, x)


# ---------------------------------------------------------------------------
# batched multi-part encode
# ---------------------------------------------------------------------------
#
# A dispatch per part pays its fixed cost for every 60 kb archive part.
# The batch kernel encodes B same-lane-tier parts in ONE scan (carry
# (B, L) lanes, so B*L lanes fill the device). Uploads are uint8 symbols
# (activity is derived on device from per-part lengths, not uploaded);
# downloads are the 2-byte emission slots plus 2-BIT packed emission
# counts. Ragged per-lane stream extraction happens on host as one
# reversed boolean mask per part (no per-lane python loop).


@__import__("functools").lru_cache(maxsize=64)
def _encode_batch_fn(steps: int, B: int, L: int):
    jax, jnp = _jx()

    def body(grid_rev, lens, freqs, cum):
        # grid_rev: (steps, B, L) u8 symbols, scan axis leading, step
        # t_rev corresponds to symbol row t = steps-1-t_rev
        lane = jnp.arange(L, dtype=jnp.int32)[None, :]

        def step(x, xs):
            row, t = xs
            active = (t * L + lane) < lens[:, None]
            s = row.astype(jnp.int32)
            f = jnp.where(
                active, jnp.take_along_axis(freqs, s, axis=1), jnp.uint32(1)
            )
            c = jnp.take_along_axis(cum, s, axis=1)
            x_max = jnp.uint32((E.RANS_L >> E.PROB_BITS) << 8) * f
            b = jnp.zeros((B, L, 2), dtype=jnp.uint8)
            cnt = jnp.zeros((B, L), dtype=jnp.uint8)
            for i in range(2):  # encode renorm emits at most 2 bytes
                emit = active & (x >= x_max)
                b = b.at[:, :, i].set(
                    jnp.where(emit, (x & 0xFF).astype(jnp.uint8), 0)
                )
                cnt = cnt + emit.astype(jnp.uint8)
                x = jnp.where(emit, x >> 8, x)
            nx = ((x // f) << E.PROB_BITS) + (x % f) + c
            x = jnp.where(active, nx, x)
            return x, (b, cnt)

        x0 = jnp.full((B, L), E.RANS_L, dtype=jnp.uint32)
        ts = jnp.arange(steps - 1, -1, -1, dtype=jnp.int32)
        x, (bts, cnts) = jax.lax.scan(step, x0, (grid_rev, ts))
        # pack the 0/1/2 emission counts 4-per-byte for the download
        c4 = cnts.reshape(steps // 4, 4, B, L) if steps % 4 == 0 else None
        if c4 is not None:
            packed_c = (
                c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6)
            )
        else:
            packed_c = cnts  # odd steps: ship unpacked
        return x, bts, packed_c

    return jax.jit(body)


def _pack_part_streams(bts_p: np.ndarray, cnts_p: np.ndarray):
    """(steps, L, 2) emission slots + (steps, L) counts for ONE part ->
    (concatenated per-lane streams in lane order, already decode-order
    reversed; per-lane lengths). One boolean mask for all lanes."""
    steps, L, _ = bts_p.shape
    # lane-major emission matrix: (L, steps*2), scan order = emission order
    arr = bts_p.transpose(1, 0, 2).reshape(L, steps * 2)
    msk = (
        np.arange(2, dtype=np.uint8)[None, :] < cnts_p[:, :, None]
    ).transpose(1, 0, 2).reshape(L, steps * 2)
    rev_arr = arr[:, ::-1]
    rev_msk = msk[:, ::-1]
    lane_lens = rev_msk.sum(axis=1)
    return rev_arr[rev_msk], lane_lens


_MAX_GROUP_PARTS = 512  # chunk cap: bounds one dispatch's grid + host pack


def encode_batch(payloads: list[bytes]) -> list[bytes]:
    """Encode many parts in batched device dispatches; returns blobs
    byte-identical to entropy.compress on each payload. Parts are grouped
    by (lane tier, pow2 steps bucket) so one oversized part cannot pad a
    whole batch of 60 kb parts up to its own step count."""
    out: list[bytes | None] = [None] * len(payloads)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(payloads):
        n = len(p)
        if n == 0:
            header = bytearray([E.MAGIC, 0])
            E._put_varint(header, 0)
            out[i] = bytes(header)
            continue
        L = E.lanes_for(n)
        groups.setdefault((L, _bucket((n + L - 1) // L)), []).append(i)
    for (L, _), idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), _MAX_GROUP_PARTS):
            _encode_group(payloads, idxs[lo : lo + _MAX_GROUP_PARTS], L, out)
    return out  # type: ignore[return-value]


def _encode_group(payloads, idxs, L, out):
    B = _bucket(len(idxs))
    arrs = [np.frombuffer(payloads[i], dtype=np.uint8) for i in idxs]
    steps = _bucket(max((len(a) + L - 1) // L for a in arrs))
    if steps % 4:
        steps = 4 * ((steps + 3) // 4)
    grid = np.zeros((B, steps * L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    freqs_all = np.zeros((B, 256), dtype=np.uint32)
    for j, a in enumerate(arrs):
        grid[j, : len(a)] = a
        lens[j] = len(a)
        freqs_all[j] = E.quantize_freqs(np.bincount(a, minlength=256))
    cum_all = np.cumsum(freqs_all, axis=1, dtype=np.uint32) - freqs_all
    grid_rev = np.ascontiguousarray(
        grid.reshape(B, steps, L).transpose(1, 0, 2)[::-1]
    )
    fn = _encode_batch_fn(steps, B, L)
    x, bts, packed_c = fn(grid_rev, lens, freqs_all, cum_all)
    x = np.asarray(x)
    bts = np.asarray(bts)          # (steps, B, L, 2), scan order
    packed_c = np.asarray(packed_c)
    if packed_c.shape[0] != steps:  # unpack the 2-bit count nibbles
        pc = packed_c
        cnts = np.empty((steps, pc.shape[1], pc.shape[2]), dtype=np.uint8)
        for k in range(4):
            cnts[k::4] = (pc >> (2 * k)) & 3
    else:
        cnts = packed_c
    for j, i in enumerate(idxs):
        flat, lane_lens = _pack_part_streams(bts[:, j], cnts[:, j])
        offs = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(lane_lens, out=offs[1:])
        streams = [
            flat[offs[k] : offs[k + 1]].tobytes() for k in range(L)
        ]
        out[i] = E.assemble_blob(
            payloads[i], freqs_all[j], streams, x[j]
        )


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@__import__("functools").lru_cache(maxsize=64)
def _decode_fn(steps: int, L: int, max_len: int):
    jax, jnp = _jx()

    def body(mat, states, active_grid, freqs, cum):
        # cum: (257,) u32; symbol via gather-free rank: sum(cum[1:] <= slot)
        cum_in = cum[1:257][None, :]  # (1, 256)

        def step(carry, active):
            x, cur = carry
            slot = x & jnp.uint32(E.PROB_SCALE - 1)
            s = jnp.sum(
                (cum_in <= slot[:, None]).astype(jnp.int32), axis=1
            )
            f = jnp.take(freqs, s)
            c = jnp.take(cum, s)
            nx = f * (x >> E.PROB_BITS) + slot - c
            x = jnp.where(active, nx, x)
            for _ in range(2):  # decode renorm reads at most 2 bytes
                need = active & (x < jnp.uint32(E.RANS_L))
                byte = jnp.take_along_axis(
                    mat, jnp.minimum(cur, max_len)[:, None], axis=1
                )[:, 0].astype(jnp.uint32)
                x = jnp.where(need, (x << 8) | byte, x)
                cur = cur + need.astype(jnp.int32)
            return (x, cur), s.astype(jnp.uint8)

        cur0 = jnp.zeros((L,), dtype=jnp.int32)
        (_, _), syms = jax.lax.scan(step, (states, cur0), active_grid)
        return syms  # (steps, L)

    return jax.jit(body)


def decompress_device(blob, expected_size: int | None = None) -> bytes:
    """Device-path twin of entropy.decompress."""
    n, flags, freqs, lane_lens, states, pos = E.parse_header(blob)
    if n == 0:
        return b""
    # same hostile-size policy as entropy.decompress/decompress_np: a
    # size header disagreeing with part metadata, or an absurd size, is
    # corruption - never a work-array allocation
    if (expected_size is not None and expected_size and n != expected_size) or (
        n > (64 << 30)
    ):
        raise ValueError("corrupt rANS blob")
    buf = memoryview(blob)
    if flags & E._RAW_FLAG:
        raw = bytes(buf[pos : pos + n])
        if len(raw) != n:  # truncated raw-escape payload
            raise ValueError("corrupt rANS blob")
        return raw

    L = E.lanes_for(n)
    steps = _bucket((n + L - 1) // L)  # rows past n are inactive
    offs = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(lane_lens, out=offs[1:])
    flat = np.frombuffer(
        buf, dtype=np.uint8, count=int(offs[-1]), offset=pos
    )
    max_len = _bucket(int(lane_lens.max()) if L else 0)
    mat = np.zeros((L, max_len + 1), dtype=np.uint8)
    for j in range(L):
        mat[j, : lane_lens[j]] = flat[offs[j] : offs[j + 1]]

    F, C = E._tables(freqs)
    active = np.arange(steps * L).reshape(steps, L) < n
    fn = _decode_fn(steps, L, max_len)
    syms = np.asarray(
        fn(
            mat,
            states.astype(np.uint32),
            active,
            F.astype(np.uint32),
            C.astype(np.uint32),
        )
    )
    res = syms.reshape(steps * L)[:n].tobytes()
    if expected_size is not None and expected_size and len(res) != expected_size:
        raise ValueError("rANS blob size mismatch")
    return res
