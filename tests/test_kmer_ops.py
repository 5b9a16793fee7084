"""Device kernel unit tests: k-mer semantics vs a direct CKmer emulation,
and the device greedy splitter chain vs a host reference walk."""

import numpy as np
import pytest

import jax.numpy as jnp

from agc_tpu.ops.kmers import (
    _padded_table,
    collect_kmers,
    contig_kmers,
    find_splitter_emissions,
    scan_contig_hits,
)


def ref_kmers(codes, k):
    """Direct emulation of the reference rolling CKmer (kmer.h)."""
    n = len(codes)
    canon = np.zeros(n, np.uint64)
    valid = np.zeros(n, bool)
    kd = 0
    kr = 0
    cur = 0
    mask = ((1 << 64) - 1) - ((1 << (64 - 2 * k)) - 1)
    for i, x in enumerate(codes):
        if x > 3:
            kd = kr = 0
            cur = 0
            continue
        kr = (kr >> 2) + ((3 - int(x)) << 62)
        kr &= mask
        if cur == k:
            kd = ((kd << 2) & 0xFFFFFFFFFFFFFFFF) + (int(x) << (64 - 2 * k))
        else:
            cur += 1
            kd += int(x) << (64 - 2 * cur)
        if cur == k:
            valid[i] = True
            canon[i] = min(kd, kr)
    return canon, valid


def host_greedy(codes, k, cand_sorted, seg_size):
    """Host emulation of find_splitters_in_contig
    (agc_compressor.cpp:762-825)."""
    canon, valid = ref_kmers(codes, k)
    member = valid & np.isin(canon, cand_sorted)
    out = []
    last = None
    hits = np.flatnonzero(member)
    for p in hits.tolist():
        if last is not None and (p - last) < seg_size:
            continue
        if last is not None and p < last + k:
            continue
        out.append(int(canon[p]))
        last = p
    floor = (last + k) if last is not None else 0
    tail = hits[hits >= floor]
    if len(tail):
        out.append(int(canon[tail[-1]]))
    return out


@pytest.mark.parametrize("k,seg", [(17, 500), (21, 997), (31, 1000)])
def test_device_greedy_matches_host(k, seg):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    codes[rng.integers(0, len(codes), 50)] = 4  # sprinkle Ns
    kmers = collect_kmers(codes, k)
    cand = np.sort(np.unique(kmers))  # mostly singletons: dense members
    table = jnp.asarray(_padded_table(cand))
    pos, kms, tail_pos, tail_kmer = find_splitter_emissions(codes, k, table, seg)
    got = [int(x) for x in kms]
    last = int(pos[-1]) if len(pos) else None
    if tail_pos is not None and (last is None or tail_pos >= last + k):
        got.append(int(tail_kmer))
    expect = host_greedy(codes, k, cand, seg)
    assert got == expect


def test_device_greedy_sparse_and_empty():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    kmers = collect_kmers(codes, 17)
    # sparse: every 37th kmer
    cand = np.sort(np.unique(kmers[::37]))
    table = jnp.asarray(_padded_table(cand))
    pos, kms, tail_pos, tail_kmer = find_splitter_emissions(codes, 17, table, 200)
    got = [int(x) for x in kms]
    last = int(pos[-1]) if len(pos) else None
    if tail_pos is not None and (last is None or tail_pos >= last + 17):
        got.append(int(tail_kmer))
    assert got == host_greedy(codes, 17, cand, 200)
    # empty candidate set
    empty = jnp.asarray(_padded_table(np.array([1], dtype=np.uint64)))
    pos, kms, tail_pos, _ = find_splitter_emissions(codes, 17, empty, 200)
    assert len(pos) == 0 and tail_pos is None


def test_scan_hits_vs_dense():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=30000, dtype=np.uint8)
    canon, valid = ref_kmers(codes, 19)
    table = np.sort(np.unique(canon[valid][::101]))
    pos, udir, urc = scan_contig_hits(codes, 19, table)
    member = valid & np.isin(canon, table)
    assert np.array_equal(pos, np.flatnonzero(member))
    assert np.array_equal(np.minimum(udir, urc), canon[pos])


def test_contig_kmers_matches_reference_emulation():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 6, size=4000, dtype=np.uint8)  # with invalids
    for k in (17, 32):
        c, v, d = (np.asarray(x) for x in contig_kmers(jnp.asarray(codes), k))
        rc, rv = ref_kmers(codes, k)
        assert np.array_equal(v, rv)
        assert np.array_equal(c[v], rc[rv])


def test_join_kernel_matches_compare_all():
    """Tables beyond _COMPARE_ALL_MAX use the sort-merge join kernel; it
    must find exactly the same hits as the compare-all path."""
    from agc_tpu.ops import kmers as K

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=30000, dtype=np.uint8)
    codes[rng.integers(0, len(codes), 40)] = 4
    k = 21
    all_kmers = np.unique(K.collect_kmers(codes, k))
    table_vals = np.sort(all_kmers[::17])  # sparse-ish hits
    small = K.make_scan_table(table_vals, k)
    assert small.kind in ("cmp", "join")
    # force both kinds on the same values
    import agc_tpu.ops.kmers as KM

    old = KM._COMPARE_ALL_MAX
    try:
        KM._COMPARE_ALL_MAX = 1 << 30
        t_cmp = K.make_scan_table(table_vals, k)
        assert t_cmp.kind == "cmp"
        KM._COMPARE_ALL_MAX = 0
        t_join = K.make_scan_table(table_vals, k)
        assert t_join.kind == "join"
    finally:
        KM._COMPARE_ALL_MAX = old
    h_cmp = K.scan_contig_hits(codes, k, t_cmp)
    h_join = K.scan_contig_hits(codes, k, t_join)
    for a, b in zip(h_cmp, h_join):
        assert np.array_equal(a, b)
    assert len(h_cmp[0]) > 300  # dense enough to be meaningful


def test_large_splitter_table_create(tmp_path):
    """End-to-end create with a splitter set beyond the compare-all
    budget (tiny segment_size): exercises the join kernel in the real
    pipeline."""
    import filecmp
    import random as _random

    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.core.decompressor import Decompressor

    sys_rng = _random.Random(17)
    from util import mutate, random_seq, write_fa

    base = random_seq(sys_rng, 400000)
    files = []
    p = str(tmp_path / "ref.fa")
    write_fa(p, [("c1", base)])
    files.append(("ref", p))
    q = str(tmp_path / "s0.fa")
    write_fa(q, [("c1", mutate(sys_rng, base))])
    files.append(("s0", q))
    params = CompressorParams()
    params.segment_size = 100  # ~4000 splitters; force join via cap
    import agc_tpu.ops.kmers as KM

    old = KM._COMPARE_ALL_MAX
    try:
        KM._COMPARE_ALL_MAX = 64
        archive = str(tmp_path / "big.agc")
        create_archive(archive, [f for _, f in files], params)
    finally:
        KM._COMPARE_ALL_MAX = old
    d = Decompressor(archive)
    for sample, path in files:
        out = str(tmp_path / f"j_{sample}.fa")
        d.get_sample_file(out, [sample], line_length=70)
        assert filecmp.cmp(out, path, shallow=False), sample
    d.close()


def test_host_discovery_matches_device(tmp_path):
    """The host (numpy) splitter-discovery path must produce exactly the
    same splitter set as the device path on a multi-contig reference."""
    import random as _random

    from agc_tpu.core.compressor import Compressor, CompressorParams

    sys_rng = _random.Random(23)
    from util import random_seq, write_fa

    recs = [(f"c{i}", random_seq(sys_rng, 4000)) for i in range(12)]
    ref = str(tmp_path / "multi.fa")
    write_fa(ref, recs)

    def splitters(host: bool):
        params = CompressorParams()
        params.segment_size = 500
        out = str(tmp_path / f"d_{host}.agc")
        comp = Compressor(out, params, reference_file=ref)
        old = Compressor._HOST_DISCOVERY_MAX
        try:
            Compressor._HOST_DISCOVERY_MAX = (1 << 30) if host else 0
            s = comp.splitter_set_snapshot()
        finally:
            Compressor._HOST_DISCOVERY_MAX = old
        comp.writer.close()
        return s

    assert splitters(True) == splitters(False)


def test_ref_scan_cache_matches_scanned_archive(tmp_path):
    """The discovery reference's own splitter hits are precomputed from
    emission positions (every splitter is a reference singleton); the
    archive must be byte-identical to one built with the membership scan
    forced on (cache disabled)."""
    import numpy as np

    from agc_tpu.core import compressor as comp
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from tests.util import write_fa

    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(n):
        return bytes(alpha[rng.integers(0, 4, size=n)]).decode()

    contigs = [("c1", seq(30000)), ("c2", seq(20000)), ("tiny", seq(40))]
    ref = tmp_path / "ref.fa"
    write_fa(str(ref), contigs)
    s1 = tmp_path / "s1.fa"
    mut = bytearray(contigs[0][1].encode())
    for i in range(0, len(mut), 777):
        mut[i] = b"ACGT"[(mut[i] + 1) % 4]
    write_fa(str(s1), [("c1", mut.decode()), ("c2", contigs[1][1])])

    params = CompressorParams(segment_size=5000)
    a_cached = tmp_path / "cached.agc"
    create_archive(str(a_cached), [str(ref), str(s1)], params)

    orig = comp.Compressor.determine_splitters

    def no_cache(self, reference_file):
        orig(self, reference_file)
        self._ref_scan_cache = None

    comp.Compressor.determine_splitters = no_cache
    try:
        a_scanned = tmp_path / "scanned.agc"
        create_archive(str(a_scanned), [str(ref), str(s1)], params)
    finally:
        comp.Compressor.determine_splitters = orig

    # physical part order in the file may differ (stores flush at
    # different moments relative to the skipped scans); the archives must
    # be stream-for-stream, part-for-part identical, which is what every
    # reader sees through the footer index
    from agc_tpu.core.archive import ArchiveReader

    def contents(path):
        r = ArchiveReader(str(path))
        out = {
            sn: [r.get_part(sn, i) for i in range(r.n_parts(sn))]
            for sn in r.stream_names()
        }
        r.close()
        return out

    c_cached, c_scanned = contents(a_cached), contents(a_scanned)
    assert set(c_cached) == set(c_scanned)
    for sn in c_cached:
        assert c_cached[sn] == c_scanned[sn], f"stream {sn} differs"


def test_oversized_reference_sampled_discovery(tmp_path):
    """References whose k-mer pool exceeds the device budget take the
    two-pass value-sampled discovery path; archives must still
    round-trip. (Threshold patched down to force the path.)"""
    import numpy as np

    from agc_tpu.core import compressor as comp
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.core.decompressor import Decompressor
    from tests.util import write_fa

    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = bytes(alpha[rng.integers(0, 4, size=200_000)]).decode()
    mut = bytearray(ref_seq.encode())
    for i in range(0, len(mut), 997):
        mut[i] = b"ACGT"[(mut[i] + 1) % 4]

    ref = tmp_path / "ref.fa"
    write_fa(str(ref), [("c1", ref_seq)])
    s1 = tmp_path / "s1.fa"
    write_fa(str(s1), [("c1", mut.decode())])

    old = comp.Compressor._POOL_DEVICE_MAX
    comp.Compressor._POOL_DEVICE_MAX = 1 << 15  # force sampling (~6 bits)
    try:
        arch = tmp_path / "a.agc"
        create_archive(
            str(arch), [str(ref), str(s1)],
            CompressorParams(segment_size=5000),
        )
    finally:
        comp.Compressor._POOL_DEVICE_MAX = old

    d = Decompressor(str(arch))
    got = d.get_contig_seq("s1", "c1")
    gotr = d.get_contig_seq("ref", "c1")
    d.close()
    assert got == bytes(mut)
    assert gotr == ref_seq.encode()


@pytest.mark.parametrize("mode", ["adaptive", "fallback"])
def test_oversized_reference_host_paths(tmp_path, mode):
    """Oversized references route adaptive mode to host discovery and -f
    mode to the host candidates+fallback-collection path."""
    import numpy as np

    from agc_tpu.core import compressor as comp
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.core.decompressor import Decompressor
    from tests.util import write_fa

    rng = np.random.default_rng(13)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = bytes(alpha[rng.integers(0, 4, size=60_000)]).decode()
    mut = bytearray(ref_seq.encode())
    for i in range(0, len(mut), 499):
        mut[i] = b"ACGT"[(mut[i] + 1) % 4]

    ref = tmp_path / "ref.fa"
    write_fa(str(ref), [("c1", ref_seq)])
    s1 = tmp_path / "s1.fa"
    write_fa(str(s1), [("c1", mut.decode())])

    params = CompressorParams(segment_size=3000)
    if mode == "adaptive":
        params.adaptive_compression = True
    else:
        params.fallback_frac = 0.01

    old = comp.Compressor._POOL_DEVICE_MAX
    comp.Compressor._POOL_DEVICE_MAX = 1 << 14
    try:
        arch = tmp_path / "a.agc"
        create_archive(str(arch), [str(ref), str(s1)], params)
    finally:
        comp.Compressor._POOL_DEVICE_MAX = old

    d = Decompressor(str(arch))
    assert d.get_contig_seq("s1", "c1") == bytes(mut)
    assert d.get_contig_seq("ref", "c1") == ref_seq.encode()
    d.close()


def test_batched_greedy_matches_sequential():
    """The vmapped multi-contig greedy must emit exactly what per-contig
    dispatches emit (same pool, same chain rules)."""
    import jax.numpy as jnp

    from agc_tpu.ops.kmers import (
        collect_kmers_device,
        find_splitter_emissions_batched,
        find_splitter_emissions_from_chunks,
    )
    from agc_tpu.core.compressor import Compressor  # noqa: F401 (env setup)

    rng = np.random.default_rng(31)
    k, seg = 21, 700
    contigs = [
        rng.integers(0, 4, size=n, dtype=np.uint8)
        for n in (9000, 5000, 12000, 40, 7000)
    ]
    recs = [collect_kmers_device(c, k) for c in contigs]
    chunks = [r[0] for rr in recs for r in rr]
    pool = jnp.sort(jnp.concatenate(chunks))
    got = find_splitter_emissions_batched(
        recs, [len(c) for c in contigs], k, pool, seg, singleton=True
    )
    for c, rr, (pos, kms, tail_pos, tail_kmer) in zip(contigs, recs, got):
        e_pos, e_kms, e_tail, e_tkm = find_splitter_emissions_from_chunks(
            rr, len(c), k, pool, seg
        )
        assert np.array_equal(pos, e_pos)
        assert np.array_equal(kms, e_kms)
        assert tail_pos == e_tail
        if tail_pos is not None:
            assert int(tail_kmer) == int(e_tkm)


def test_mixed_bucket_scan_coalescing_equivalence():
    """A flush holding parts of different power-of-two buckets must
    produce identical hits whether or not classes coalesce into one
    dispatch."""
    import jax.numpy as jnp  # noqa: F401

    import agc_tpu.ops.kmers as KM
    from agc_tpu.ops.kmers import ScanBatcher, collect_kmers, make_scan_table

    rng = np.random.default_rng(12)
    k = 21
    contigs = [
        rng.integers(0, 4, size=n, dtype=np.uint8)
        for n in (70000, 20000, 9000, 120000)
    ]
    vals = np.sort(np.unique(np.concatenate(
        [collect_kmers(c, k)[::301] for c in contigs]
    )))
    table = make_scan_table(vals, k)

    def run():
        b = ScanBatcher(k, table)
        toks = [b.add(c) for c in contigs]
        b.flush()
        return [b.collect(t) for t in toks]

    old = KM._COALESCE_BUCKETS
    try:
        KM._COALESCE_BUCKETS = True
        merged = run()
        KM._COALESCE_BUCKETS = False
        split = run()
    finally:
        KM._COALESCE_BUCKETS = old
    for (p1, d1, r1), (p2, d2, r2) in zip(merged, split):
        assert np.array_equal(p1, p2)
        assert np.array_equal(d1, d2)
        assert np.array_equal(r1, r2)


def test_row_packing_scan_equivalence():
    """Row-packed dispatches (parts bin-packed into CHUNK-wide rows with
    invalid-symbol seams) must produce identical hits to per-bucket
    dispatches for every part."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.ops.kmers import ScanBatcher, collect_kmers, make_scan_table

    rng = np.random.default_rng(18)
    k = 21
    contigs = [
        rng.integers(0, 4, size=n, dtype=np.uint8)
        for n in (70000, 20000, 9000, 120000, 64, 300000)
    ]
    contigs[1][100:140] = 4  # invalid symbols inside a part
    vals = np.sort(np.unique(np.concatenate(
        [collect_kmers(c, k)[::173] for c in contigs if len(c) >= k]
    )))
    table = make_scan_table(vals, k)

    def run():
        b = ScanBatcher(k, table)
        toks = [b.add(c) for c in contigs]
        b.flush()
        return [b.collect(t) for t in toks]

    old = KM._PACK_ROWS
    try:
        KM._PACK_ROWS = True
        packed = run()
        KM._PACK_ROWS = False
        split = run()
    finally:
        KM._PACK_ROWS = old
    for (p1, d1, r1), (p2, d2, r2) in zip(packed, split):
        assert np.array_equal(p1, p2)
        assert np.array_equal(d1, d2)
        assert np.array_equal(r1, r2)


@pytest.mark.parametrize("adaptive", [False, True])
def test_packed_discovery_matches_unpacked(tmp_path, adaptive):
    """Packed discovery (canon + greedy over bin-packed rows) must emit
    the same splitter set — and hence identical archive streams — as the
    per-contig path."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.core.archive import ArchiveReader
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from tests.util import write_fa

    rng = np.random.default_rng(41)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(n):
        return bytes(alpha[rng.integers(0, 4, size=n)]).decode()

    contigs = [(f"c{i}", seq(4000 + 700 * i)) for i in range(6)]
    ref = tmp_path / "ref.fa"
    write_fa(str(ref), contigs)
    s1 = tmp_path / "s1.fa"
    mut = [(n, "".join(
        (ch if rng.random() > 0.002 else "ACGT"[int(rng.integers(0, 4))])
        for ch in s)) for n, s in contigs]
    write_fa(str(s1), mut)

    params = CompressorParams(
        segment_size=1500, adaptive_compression=adaptive
    )

    def contents(path):
        r = ArchiveReader(str(path))
        out = {
            sn: [r.get_part(sn, i) for i in range(r.n_parts(sn))]
            for sn in r.stream_names()
        }
        r.close()
        return out

    old = KM._PACK_DISCOVERY
    try:
        KM._PACK_DISCOVERY = True
        a1 = tmp_path / "p.agc"
        create_archive(str(a1), [str(ref), str(s1)], params)
        KM._PACK_DISCOVERY = False
        a2 = tmp_path / "u.agc"
        create_archive(str(a2), [str(ref), str(s1)], params)
    finally:
        KM._PACK_DISCOVERY = old

    c1, c2 = contents(a1), contents(a2)
    assert set(c1) == set(c2)
    for sn in c1:
        assert c1[sn] == c2[sn], f"stream {sn} differs"


def test_fallback_collection_matches_reference_walk(tmp_path):
    """Fallback-minimizer records from _find_splitters_in_contig must
    equal a direct emulation of the reference's find_splitters_in_contig
    walk (agc_compressor.cpp:762-825): the rolling k-mer Resets at each
    emission, so the k-1 windows after a cut contribute NO fallback
    k-mers, and the per-segment list maps to (prev_splitter, emitted)."""
    from util import write_fa

    from agc_tpu.core.compressor import EMPTY, Compressor, CompressorParams

    k, seg = 17, 300
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=15000, dtype=np.uint8)
    codes[rng.integers(0, len(codes), 40)] = 4  # N resets
    kmers = collect_kmers(codes, k)
    uniq, counts = np.unique(kmers, return_counts=True)
    cand = uniq[counts == 1]

    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", "ACGT" * 200)])
    comp = Compressor(
        str(tmp_path / "x.agc"),
        CompressorParams(
            kmer_length=k, segment_size=seg, min_match_len=15,
            fallback_frac=0.05,
        ),
        reference_file=ref,
    )
    try:
        got_spl, got_fb = comp._find_splitters_in_contig(codes, cand)
    finally:
        comp.writer.close()

    # direct reference emulation (same k-mer update as ref_kmers)
    fb = comp.fallback_filter
    candset = set(int(x) for x in cand)
    mask = ((1 << 64) - 1) - ((1 << (64 - 2 * k)) - 1)
    kd = kr = 0
    cur = 0
    current_len = seg  # init to segment_size: 1st candidate emits at once
    prev = EMPTY
    exp_spl, exp_fb, cur_fb, recent = [], [], [], []
    for x in codes:
        if x > 3:
            kd = kr = 0
            cur = 0
        else:
            kr = (kr >> 2) + ((3 - int(x)) << 62)
            kr &= mask
            if cur == k:
                kd = ((kd << 2) & 0xFFFFFFFFFFFFFFFF) + (int(x) << (64 - 2 * k))
            else:
                cur += 1
                kd += int(x) << (64 - 2 * cur)
            if cur == k:
                d = min(kd, kr)
                recent.append(d)
                if kd != kr and fb(d):
                    cur_fb.append((d, kd <= kr))
                if current_len >= seg and d in candset:
                    exp_spl.append(d)
                    exp_fb.extend((prev, d, km, dirn) for km, dirn in cur_fb)
                    cur_fb = []
                    recent = []
                    prev = d
                    current_len = 0
                    kd = kr = 0
                    cur = 0
        current_len += 1
    for d in reversed(recent):
        if d in candset:
            exp_spl.append(d)
            exp_fb.extend((prev, d, km, dirn) for km, dirn in cur_fb)
            break

    assert got_spl == exp_spl
    assert [(p, c, km, bool(dirn)) for p, c, km, dirn in got_fb] == exp_fb
    assert len(exp_fb) > 20  # the 0.05 filter must actually sample


def _stream_contents(path):
    """Logical archive content: every stream's parts in order. PHYSICAL
    part order (and hence raw file bytes) is scheduler-dependent for any
    async buffered writer — the reference's included — so engine-
    equivalence tests compare streams, not bytes."""
    from agc_tpu.core.archive import ArchiveReader

    r = ArchiveReader(str(path))
    out = {
        sn: [r.get_part(sn, i) for i in range(r.n_parts(sn))]
        for sn in r.stream_names()
    }
    r.close()
    return out


def test_host_scan_matches_device_scan():
    """The native host membership scan (the plain reference engine,
    kmer_scan_members) must produce exactly the hits of the device scan
    pipeline: same positions, same dir/rc codes, including invalid-symbol
    resets and k=32 full-width codes."""
    from agc_tpu.ops.kmers import (
        ScanBatcher, collect_kmers, make_scan_table, scan_members_host,
    )

    rng = np.random.default_rng(77)
    for k in (17, 31, 32):
        contigs = [
            rng.integers(0, 4, size=n, dtype=np.uint8)
            for n in (50000, 7000, 120000)
        ]
        contigs[0][500:540] = 7  # invalid stretch
        vals = np.sort(np.unique(np.concatenate(
            [collect_kmers(c, k)[::101] for c in contigs]
        )))
        table = make_scan_table(vals, k)
        b = ScanBatcher(k, table)
        toks = [b.add(c) for c in contigs]
        b.flush()
        for c, t in zip(contigs, toks):
            dp, dd, dr = b.collect(t)
            hp, hd, hr = scan_members_host(c, k, table)
            assert np.array_equal(dp, hp)
            assert np.array_equal(dd, hd)
            assert np.array_equal(dr, hr)


def test_host_scan_mode_create_is_stream_identical(tmp_path, monkeypatch):
    """AGC_TPU_SCAN=host (the host reference engine) must produce a
    byte-identical archive to the default engine."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from tests.util import make_collection

    files = [p for _, p in make_collection(tmp_path, n_samples=3)]
    a1 = tmp_path / "dev.agc"
    a2 = tmp_path / "host.agc"
    create_archive(str(a1), files, CompressorParams())
    monkeypatch.setenv("AGC_TPU_SCAN", "host")
    create_archive(str(a2), files, CompressorParams())
    assert _stream_contents(a1) == _stream_contents(a2)
    assert KM.SCAN_STATS["host_syms"] > 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_host_discovery_is_stream_identical(tmp_path, monkeypatch, adaptive):
    """AGC_TPU_DISC=host (the host reference discovery) must produce
    byte-identical archives to the device discovery path, plain and
    adaptive (the adaptive variant also carries cand_singletons/
    duplicated for new-splitter merges)."""
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from tests.util import make_collection

    files = [p for _, p in make_collection(tmp_path, n_samples=2)]
    params = CompressorParams(adaptive_compression=adaptive)
    a1 = tmp_path / "dev.agc"
    a2 = tmp_path / "host.agc"
    monkeypatch.setenv("AGC_TPU_DISC", "device")
    create_archive(str(a1), files, params)
    monkeypatch.setenv("AGC_TPU_DISC", "host")
    create_archive(str(a2), files, params)
    assert _stream_contents(a1) == _stream_contents(a2)


def test_adaptive_flush_quantum(monkeypatch):
    """The scan flush quantum is a fixed default (8 Mbase) that
    AGC_TPU_SCAN_FLUSH_MB pins; the constructor uses it."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.ops.kmers import ScanBatcher

    monkeypatch.delenv("AGC_TPU_SCAN_FLUSH_MB", raising=False)
    assert ScanBatcher._flush_quantum() == KM._SCAN_FLUSH_SYMBOLS == 8 << 20
    assert ScanBatcher(31, None)._flush_symbols == 8 << 20
    monkeypatch.setenv("AGC_TPU_SCAN_FLUSH_MB", "16")
    assert ScanBatcher._flush_quantum() == 16 << 20  # the pin wins
    assert ScanBatcher(31, None)._flush_symbols == 16 << 20
    monkeypatch.setenv("AGC_TPU_SCAN_FLUSH_MB", "0.5")
    assert ScanBatcher._flush_quantum() == 1 << 19


def _small_scan_case(seed: int, n: int = 200_000):
    from agc_tpu.ops.kmers import collect_kmers, make_scan_table

    rng = np.random.default_rng(seed)
    k = 21
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    vals = np.sort(np.unique(collect_kmers(codes, k)[::301]))
    return k, codes, make_scan_table(vals, k)


def test_slow_device_scan_is_waited_for(monkeypatch):
    """A device scan result that arrives late is waited for: collect()
    returns the device result (equal to the host reference) and never
    runs the host scan in its place."""
    import time as _t

    import agc_tpu.ops.kmers as KM
    from agc_tpu.ops.kmers import ScanBatcher, scan_members_host

    k, codes, table = _small_scan_case(9)
    want = scan_members_host(codes, k, table)
    real = KM._dispatch_scan_batch

    def slow(*a, **kw):
        _t.sleep(1.5)  # far past any per-collect grace the old hedge had
        return real(*a, **kw)

    monkeypatch.delenv("AGC_TPU_SCAN", raising=False)
    monkeypatch.setattr(KM, "_dispatch_scan_batch", slow)
    host0 = KM.SCAN_STATS["host_syms"]
    dev0 = KM.SCAN_STATS["device_syms"]
    b = ScanBatcher(k, table)
    tok = b.add(codes)
    b.flush()
    got = b.collect(tok)
    assert KM.SCAN_STATS["host_syms"] == host0
    assert KM.SCAN_STATS["device_syms"] == dev0 + len(codes)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_device_scan_error_raises(monkeypatch):
    """A device scan error propagates out of collect() instead of being
    papered over by the host scan."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.ops.kmers import ScanBatcher

    k, codes, table = _small_scan_case(10, n=50_000)

    def broken(*a, **kw):
        raise RuntimeError("device scan failed")

    monkeypatch.delenv("AGC_TPU_SCAN", raising=False)
    monkeypatch.setattr(KM, "_dispatch_scan_batch", broken)
    host0 = KM.SCAN_STATS["host_syms"]
    b = ScanBatcher(k, table)
    tok = b.add(codes)
    b.flush()
    with pytest.raises(RuntimeError, match="device scan failed"):
        b.collect(tok)
    assert KM.SCAN_STATS["host_syms"] == host0


def test_device_discovery_error_raises(tmp_path, monkeypatch):
    """A device splitter-discovery error fails the create; discovery is
    not redone on the host."""
    import agc_tpu.ops.kmers as KM
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from tests.util import make_collection

    files = [p for _, p in make_collection(tmp_path, n_samples=2)]

    def broken(*a, **kw):
        raise RuntimeError("device discovery failed")

    monkeypatch.setattr(KM, "sort_kmers", broken)
    monkeypatch.setenv("AGC_TPU_DISC", "auto")
    out = tmp_path / "x.agc"
    with pytest.raises(RuntimeError, match="device discovery failed"):
        create_archive(str(out), files, CompressorParams())
    assert not out.exists()  # no partial archive left at the user's path


@pytest.mark.parametrize("k", [17, 23, 31, 32])
def test_kmer_core_matches_host_twin(k, monkeypatch):
    """The device k-mer ladder (_dir_halves/_kmer_core, via the chunked
    scan_contig driver) equals the host twin dir_rc_kmers_np position by
    position: invalid symbols, an N-run, and a contig spanning two chunks
    (k-1 halo at the seam)."""
    import agc_tpu.ops.kmers as KM

    monkeypatch.setattr(KM, "CHUNK", 1 << 14)
    rng = np.random.default_rng(k)
    n = 2 * KM.CHUNK - 777
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.integers(0, n, 40)] = rng.integers(4, 16, 40).astype(np.uint8)
    codes[KM.CHUNK - 10 : KM.CHUNK + 5] = 4  # N-run across the seam
    udir, urc, valid = KM.dir_rc_kmers_np(codes, k)
    canon, d_dir, d_rc, d_valid, member = KM.scan_contig(
        codes, k, np.empty(0, np.uint64)
    )
    assert np.array_equal(d_valid, valid)
    assert np.array_equal(d_dir[valid], udir[valid])
    assert np.array_equal(d_rc[valid], urc[valid])
    assert np.array_equal(canon[valid], np.minimum(udir, urc)[valid])
    assert not member.any()
    # the bare jitted core on one padded chunk agrees too
    cd, cr, cv = KM.contig_kmers_dir_rc(jnp.asarray(codes[: 1 << 12]), k)
    hd, hr, hv = KM.dir_rc_kmers_np(codes[: 1 << 12], k)
    assert np.array_equal(np.asarray(cv), hv)
    assert np.array_equal(np.asarray(cd)[hv], hd[hv])
    assert np.array_equal(np.asarray(cr)[hv], hr[hv])
