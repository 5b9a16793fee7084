"""GPU smoke test: the create/append/query path end to end on the card.

    python chip_smoke.py                 # one GPU, full size
    python chip_smoke.py --kernels-only  # the kernel phase alone
    python chip_smoke.py --four-cards    # multi-card create on 4 GPUs
    JAX_PLATFORMS=cpu python chip_smoke.py --size-mb 1   # CPU rehearsal

The collection is generated from a fixed seed with bench.py's generator:
one chromosome-scale reference contig (48 Mbase, about human chr21) with
repeat families, plus resequenced haplotypes at ~0.1% SNPs with indels
and an N-run. Phases (one process, one card):

- kernels: every device kernel of the path compiled at production width
  (4 MiB chunks, a full 32 Mbase flush), its memory analysis, one warm
  call, and an exact comparison with its plain host twin;
- pipeline: (a) ``create`` through the CLI with the default zstd profile
  and default -k 31 -s 60000 -l 20; (b) ``append`` of one more
  haplotype; (c) ``getset`` of every sample and ``getctg`` ranges,
  compared with the input; (d) the same archive read back through the
  standalone C reader; (e) the same create on the host engines
  (AGC_TPU_SCAN=host AGC_TPU_DISC=host), compared part by part with (a).
  (a) must have run every scan and the splitter discovery on the device.

``--four-cards`` runs only the multi-card create: 8 haplotypes created
on one card, by ``mesh_create_archive`` over a 4-GPU mesh, and by
``create --shards 4 --shard-workers process`` with one card per worker
(each worker reports its platform and device count, checked to be one
GPU), each archive compared with the one-card archive.

All integer kernels, so every comparison is exact. The script fails
(non-zero exit, no result line) when any phase fails or when JAX runs on
anything but a GPU; without --size-mb it refuses a non-GPU platform
before doing any work, and on a GPU it refuses --size-mb, which serves
only the CPU rehearsal, so a GPU result is always at full width. The
last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import filecmp
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

CONTIG = "chr21"
SEED = 20261016


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ---------------------------------------------------------------------------
# device and timing
# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, read from its
    monitoring events, so compile time is reported apart from run time."""

    _EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_kw):
        if name in self._EVENTS:
            self.total += secs


def card_lines() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({e.__class__.__name__})"]
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines or [f"nvidia-smi gave nothing (rc {out.returncode})"]


def peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not available" if peak is None else f"{peak} bytes"


@contextlib.contextmanager
def phase(name: str, clock: CompileClock, results: dict):
    t0 = time.perf_counter()
    c0 = clock.total
    try:
        yield
    except Exception as e:  # report the phase, then fail the run
        import traceback

        traceback.print_exc()
        results[name] = f"FAILED: {e.__class__.__name__}: {e}"
        print(f"phase {name}: {results[name]}", flush=True)
        raise PhaseFailed(name) from e
    wall = time.perf_counter() - t0
    comp = clock.total - c0
    results[name] = "ok"
    print(
        f"phase {name}: ok, wall {wall:.3f} s, of which compile "
        f"{comp:.3f} s, run {wall - comp:.3f} s; device peak {peak_bytes()}",
        flush=True,
    )


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_collection(workdir: str, size_mb: int, n_hap: int):
    """Reference + n_hap haplotypes (FASTA, one contig each); returns
    [(sample_name, path, codes)] with the reference first."""
    from bench import _make_structured_ref, _mutate, _write_fasta

    rng = np.random.default_rng(SEED)
    ref = _make_structured_ref(rng, size_mb << 20)
    out = [("ref", os.path.join(workdir, "ref.fa"), ref)]
    for i in range(n_hap):
        hap = _mutate(rng, ref)
        a = int(rng.integers(0, len(hap) - 5000))
        hap[a : a + int(rng.integers(100, 5000))] = 4  # an N-run
        out.append((f"hap{i}", os.path.join(workdir, f"hap{i}.fa"), hap))
    for _name, path, codes in out:
        _write_fasta(path, CONTIG, codes)
    return out


def ascii_of(codes: np.ndarray) -> bytes:
    return np.frombuffer(b"ACGTN", dtype=np.uint8)[codes].tobytes()


def same_parts(path_a: str, path_b: str) -> tuple[bool, str]:
    """Stream/part CONTENT identity (the physical part order depends on
    the async store's scheduling; the format indexes parts by footer)."""
    from agc_tpu.core.archive import ArchiveReader

    ra, rb = ArchiveReader(path_a), ArchiveReader(path_b)
    try:
        if set(ra.stream_names()) != set(rb.stream_names()):
            return False, "stream names differ"
        n_parts = 0
        for nm in ra.stream_names():
            if ra.n_parts(nm) != rb.n_parts(nm):
                return False, f"{nm}: part count differs"
            for i in range(ra.n_parts(nm)):
                if ra.get_part(nm, i) != rb.get_part(nm, i):
                    return False, f"{nm} part {i} differs"
                n_parts += 1
        return True, f"{len(ra.stream_names())} streams, {n_parts} parts"
    finally:
        ra.close()
        rb.close()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


class Capture:
    """Records the largest concrete call of each jitted kernel looked up
    as a module global, so each kernel can be lowered, compiled and timed
    at exactly the shapes production used."""

    def __init__(self, clock: CompileClock):
        self.clock = clock
        self.calls: dict[str, tuple] = {}  # name -> (bytes, fn, args, kw)
        self.compile_s: dict[str, float] = {}
        self._undo: list = []

    def _recorder(self, name, fn):
        import jax

        def rec(*a, **kw):
            c0 = self.clock.total
            out = fn(*a, **kw)
            leaves = jax.tree_util.tree_leaves((a, kw))
            if not any(isinstance(x, jax.core.Tracer) for x in leaves):
                size = sum(getattr(x, "nbytes", 0) for x in leaves)
                if size >= self.calls.get(name, (-1,))[0]:
                    self.calls[name] = (size, fn, a, kw)
                # JAX compiles on the first call of each shape
                self.compile_s[name] = self.compile_s.get(name, 0.0) + (
                    self.clock.total - c0
                )
            return out

        return rec

    def wrap(self, module, attr: str) -> None:
        fn = getattr(module, attr)
        self._undo.append((module, attr, fn))
        setattr(module, attr, self._recorder(attr, fn))

    def wrap_factory(self, module, attr: str, name: str) -> None:
        factory = getattr(module, attr)
        self._undo.append((module, attr, factory))
        setattr(
            module, attr,
            lambda *a: self._recorder(name, factory(*a)),
        )

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()

    def report(self, name: str, parity: str) -> None:
        """Compile the largest recorded call of ``name``, print its memory
        analysis and one warm call's wall time beside the parity verdict."""
        import jax

        check(name in self.calls, f"kernel {name} was never called")
        _size, fn, a, kw = self.calls[name]
        shapes = [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(a)
            if hasattr(x, "shape") and x.ndim
        ]
        compiled = fn.lower(*a, **kw).compile()
        warm = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a, **kw))
            warm = min(warm, time.perf_counter() - t0)
        m = compiled.memory_analysis()
        mem = (
            "not available" if m is None else
            f"args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes}"
            f" B, temp {m.temp_size_in_bytes} B, code "
            f"{m.generated_code_size_in_bytes} B"
        )
        print(
            f"kernel {name}: shapes {shapes[:4]}; compile (first calls)"
            f" {self.compile_s.get(name, 0.0):.3f} s;"
            f" warm call {warm * 1e3:.3f} ms (host clock, dispatch +"
            f" device); memory {mem}; parity {parity}",
            flush=True,
        )


def kernel_phase(coll, full: bool, clock: CompileClock) -> None:
    import jax.numpy as jnp

    from agc_tpu.core import entropy as E
    from agc_tpu.core.compressor import Compressor, greedy_splitter_walk
    from agc_tpu.core.lz import LZDiff
    from agc_tpu.native import get_lib
    from agc_tpu.ops import device_rans as D
    from agc_tpu.ops import kmers as KM
    from agc_tpu.ops import match as M
    from agc_tpu.parallel import sharding as S

    k, seg_size, key_len = 31, 60000, 20 - 3
    ref = coll[0][2]
    hap = coll[1][2]
    lib = get_lib()
    check(lib is not None, "native library did not build")
    cap = Capture(clock)
    for mod, attr in (
        (KM, "scan_batch_compact_p4"), (KM, "scan_batch_join_global_p4"),
        (KM, "sort_kmers"), (KM, "splitter_greedy_canon_kernel"),
        (KM, "splitter_greedy_kernel"),
        (M, "_ref_index_kernel"), (M, "_seg_rows_strided_kernel"),
        (M, "_estimate_kernel"), (M, "_seg_rows_kernel"),
        (M, "_split_point_kernel"), (M, "_anchor_join_kernel"),
        (M, "_anchor_select_kernel"), (S, "_scan_batch"),
    ):
        cap.wrap(mod, attr)
    cap.wrap_factory(D, "_encode_batch_fn", "rans_encode_batch")
    try:
        # -- membership scans: a full flush (8 rows x 4 MiB) against a
        #    compare-all table the size (a) produces (~1 splitter per
        #    segment) and against a join table past _COMPARE_ALL_MAX
        n_scan = min(len(hap), KM._BATCH_SYMBOL_BUDGET if full else 1 << 17)
        codes = np.ascontiguousarray(hap[:n_scan])
        canon, valid = KM.canon_kmers_np(ref, k)
        spl = np.unique(canon[valid][::seg_size])
        hcanon, hvalid = KM.canon_kmers_np(codes, k)
        rng = np.random.default_rng(1)
        join = np.unique(rng.choice(hcanon[hvalid], 2 * KM._COMPARE_ALL_MAX))
        for table_np, kernel in (
            (spl, "scan_batch_compact_p4"),
            (join, "scan_batch_join_global_p4"),
        ):
            table = KM.make_scan_table(table_np, k)
            b = KM.ScanBatcher(k, table)
            tok = b.add(codes)
            b.flush()
            got = b.collect(tok)
            want = KM.scan_members_host(codes, k, table)
            ok = all(np.array_equal(g, w) for g, w in zip(got, want))
            check(ok, f"{kernel} differs from scan_members_host")
            cap.report(
                kernel,
                f"exact vs scan_members_host ({len(table_np)} table k-mers,"
                f" {len(want[0])} hits)",
            )

        # -- sharding._scan_batch (the mesh step's body) at the same width
        rows = 8 if full else 2
        width = KM.CHUNK if full else 1 << 15
        mat = np.full((rows, width), 255, dtype=np.uint8)
        for r in range(rows):
            piece = hap[r * width : (r + 1) * width]
            mat[r, : len(piece)] = piece
        _c, _v, member = S._scan_batch(jnp.asarray(mat), jnp.asarray(spl), k)
        member = np.asarray(member)
        stable = KM.make_scan_table(spl, k)
        for r in range(rows):
            want = KM.scan_members_host(mat[r], k, stable)[0]
            check(
                np.array_equal(np.flatnonzero(member[r]), want),
                f"_scan_batch row {r} differs from scan_members_host",
            )
        cap.report("_scan_batch", "exact vs scan_members_host")

        # -- discovery: device pool sort + greedy chain over the whole
        #    reference, against the host sort and the native host walk
        recs = KM.collect_kmers_device(ref, k)
        pool = Compressor._sorted_pool([r[0] for r in recs])
        host_pool = np.sort(canon[valid])
        check(
            np.array_equal(np.asarray(pool)[: len(host_pool)], host_pool),
            "device pool sort differs from np.sort",
        )
        cap.report("sort_kmers", f"exact vs np.sort ({len(host_pool)} k-mers)")
        pos, kms, tail_pos, tail_kmer = KM.find_splitter_emissions_from_chunks(
            recs, len(ref), k, pool, seg_size
        )
        dev = list(zip(pos.tolist(), kms.tolist()))
        if tail_pos is not None and (not dev or tail_pos >= dev[-1][0] + k):
            dev.append((int(tail_pos), int(tail_kmer)))
        host = host_greedy(lib, ref, k, seg_size, host_pool)
        check(dev == host, "greedy chain differs from the host walk")
        cap.report(
            "splitter_greedy_canon_kernel",
            f"exact vs host walk ({len(host)} splitters)",
        )
        # membership-mode chain (adaptive / -f discovery) over one whole
        # 32 Mbase group, against the shared host walk
        n_grp = min(len(ref), KM.MAX_WHOLE_CONTIG)
        grp = np.ascontiguousarray(ref[:n_grp])
        first = np.ones(len(host_pool), dtype=bool)
        first[1:] = host_pool[1:] != host_pool[:-1]
        last = np.ones(len(host_pool), dtype=bool)
        last[:-1] = first[1:]
        members = host_pool[first & last][::64]  # a sparse singleton table
        pos, kms, tail_pos, tail_kmer = KM.find_splitter_emissions(
            grp, k, jnp.asarray(members), seg_size
        )
        dev = [int(x) for x in kms]
        if tail_pos is not None and (not len(pos) or tail_pos >= pos[-1] + k):
            dev.append(int(tail_kmer))
        gcanon, gvalid = KM.canon_kmers_np(grp, k)
        ix = np.minimum(np.searchsorted(members, gcanon), len(members) - 1)
        hits = np.flatnonzero(gvalid & (members[ix] == gcanon))
        want, _fb = greedy_splitter_walk(
            n_grp, k, seg_size, hits, gcanon[hits]
        )
        check(dev == want, "membership greedy chain differs from the host walk")
        cap.report(
            "splitter_greedy_kernel",
            f"exact vs greedy_splitter_walk ({len(want)} splitters,"
            f" {len(members)} table k-mers)",
        )

        # -- LZ estimates, split point, anchor tables on 60 kb segments
        n_seg = 16 if full else 4
        seg_len = 60000 if full else 6000
        refs = {
            g: np.ascontiguousarray(ref[g * seg_len : (g + 1) * seg_len])
            for g in range(n_seg)
        }
        texts = [
            np.ascontiguousarray(hap[g * seg_len : (g + 1) * seg_len])
            for g in range(n_seg)
        ]
        provider = lambda g: refs[g].tobytes()  # noqa: E731
        bank = M.RefBank(key_len)
        for g in refs:
            bank.get(g, lambda g=g: provider(g))
        queries = [
            M.MatchQuery(t, [(g, False), ((g + 1) % n_seg, False)])
            for g, t in enumerate(texts)
        ]
        M.estimate_batch(queries, bank, provider)
        for q in queries:
            for (g, _rc), est in zip(q.cands, q.ests):
                check(
                    int(est) == M.estimate_np(q.codes, refs[g], key_len),
                    f"estimate for group {g} differs from estimate_np",
                )
        cap.report("_ref_index_kernel", "exercised by the estimates below")
        cap.report("_seg_rows_strided_kernel", "exercised by the estimates")
        cap.report(
            "_estimate_kernel",
            f"exact vs estimate_np ({2 * n_seg} pairs)",
        )
        mid = seg_len // 2
        split_in = np.ascontiguousarray(
            np.concatenate([texts[0][:mid], texts[1][mid:]])
        )
        dev_split = M.split_point_device(
            split_in, bank, 0, False, 1, False, provider
        )
        host_split = M.split_point_np(
            split_in, refs[0], False, refs[1], False, key_len
        )
        check(dev_split == host_split, "split point differs from split_point_np")
        cap.report("_seg_rows_kernel", "exercised by the split point")
        cap.report("_split_point_kernel", f"exact vs split_point_np ({host_split})")
        abank = M.AnchorCodeBank()
        tabs = M.anchor_diag_sets(
            [t.tobytes() for t in texts], list(refs), abank, provider, key_len
        )
        for g, (t, tab) in enumerate(zip(texts, tabs)):
            lz = LZDiff(20)
            lz.prepare(refs[g].tobytes())
            host_tab = lz.anchor_diags_host(t.tobytes())
            check(
                (tab is None) == (host_tab is None)
                and (tab is None or np.array_equal(tab, host_tab)),
                f"anchor diagonals for group {g} differ from lz_anchor_diags",
            )
        cap.report("_anchor_join_kernel", "exact vs lz_anchor_diags")
        cap.report("_anchor_select_kernel", "exact vs lz_anchor_diags")

        # -- batched rANS encode against the host coder
        payloads = [t.tobytes() for t in texts] + [
            bytes(rng.integers(0, 40, int(n), dtype=np.uint8))
            for n in rng.integers(1000, 200_000, n_seg)
        ]
        blobs = D.encode_batch(payloads)
        for p, blob in zip(payloads, blobs):
            check(blob == E.compress(p), "encode_batch differs from the host coder")
        cap.report(
            "rans_encode_batch",
            f"byte-identical to the host rANS coder ({len(payloads)} parts)",
        )
    finally:
        cap.restore()


def host_greedy(lib, codes, k, seg_size, pool) -> list[tuple[int, int]]:
    """The native host greedy walk (the host discovery's own call)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    c = np.ascontiguousarray(codes)
    pool = np.ascontiguousarray(pool)
    cap = len(c) // seg_size + 8
    while True:
        out_pos = np.empty(cap, dtype=np.int64)
        out_kmer = np.empty(cap, dtype=np.uint64)
        cnt = lib.kmer_discover_splitters(
            c.ctypes.data_as(u8p), len(c), k, pool.ctypes.data_as(u64p),
            len(pool), seg_size, out_pos.ctypes.data_as(i64p),
            out_kmer.ctypes.data_as(u64p), cap,
        )
        if cnt <= cap:
            return list(zip(out_pos[:cnt].tolist(), out_kmer[:cnt].tolist()))
        cap = cnt


# ---------------------------------------------------------------------------
# pipeline phase
# ---------------------------------------------------------------------------


def cli(*argv: str) -> None:
    from agc_tpu.cli.main import main

    rc = main(list(argv))
    check(rc == 0, f"agc-tpu {argv[0]} exited {rc}")


def pipeline_phase(coll, workdir, clock, results) -> None:
    from agc_tpu.native import get_capi
    from agc_tpu.ops.kmers import SCAN_STATS

    inputs = [p for _n, p, _c in coll]
    created = os.path.join(workdir, "created.agc")
    appended = os.path.join(workdir, "appended.agc")
    host_twin = os.path.join(workdir, "host.agc")
    extra = coll[-1]
    first = inputs[:-1]

    with phase("create", clock, results):
        s0 = dict(SCAN_STATS)
        cli("create", "-o", created, *first)
        dev = SCAN_STATS["device_syms"] - s0["device_syms"]
        host = SCAN_STATS["host_syms"] - s0["host_syms"]
        disc = SCAN_STATS["device_discoveries"] - s0["device_discoveries"]
        print(
            f"create: device_syms {dev}, host_syms {host}, device "
            f"discoveries {disc}, archive {os.path.getsize(created)} bytes",
            flush=True,
        )
        check(dev > 0 and host == 0, "scans did not all run on the device")
        check(disc >= 1, "splitter discovery did not run its device leg")

    with phase("append", clock, results):
        cli("append", created, extra[1], "-o", appended)

    with phase("extract", clock, results):
        rng = np.random.default_rng(7)
        n_ranges = 0
        for name, path, codes in coll:
            out = os.path.join(workdir, f"out_{name}.fa")
            cli("getset", appended, name, "-o", out)
            check(filecmp.cmp(out, path, shallow=False), f"getset {name}")
            os.unlink(out)
            for _ in range(3):
                a = int(rng.integers(0, len(codes) - 1))
                b = int(rng.integers(a, min(len(codes), a + 100_000)))
                cli("getctg", appended, f"{CONTIG}@{name}:{a}-{b}", "-o", out)
                with open(out, "rb") as f:
                    body = f.read().split(b"\n", 1)[1].replace(b"\n", b"")
                check(body == ascii_of(codes[a : b + 1]), f"getctg {name}:{a}-{b}")
                n_ranges += 1
        print(f"extract: {len(coll)} samples, {n_ranges} ranges equal", flush=True)

    with phase("c_reader", clock, results):
        lib = get_capi()
        check(lib is not None, "C reader library did not build")
        h = lib.agc_open(appended.encode(), 1)
        check(bool(h), "agc_open failed")
        try:
            for name, _path, codes in coll:
                n = lib.agc_get_ctg_len(h, name.encode(), CONTIG.encode())
                check(n == len(codes), f"C reader length of {name}")
                buf = ctypes.create_string_buffer(n + 1)
                m = lib.agc_get_ctg_seq(
                    h, name.encode(), CONTIG.encode(), -1, -1, buf
                )
                check(m == n and buf.raw[:n] == ascii_of(codes), f"C reader {name}")
        finally:
            lib.agc_close(h)

    with phase("host_twins", clock, results):
        saved = {v: os.environ.get(v) for v in ("AGC_TPU_SCAN", "AGC_TPU_DISC")}
        os.environ["AGC_TPU_SCAN"] = os.environ["AGC_TPU_DISC"] = "host"
        s0 = dict(SCAN_STATS)
        try:
            cli("create", "-o", host_twin, *first)
        finally:
            for v, val in saved.items():
                if val is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = val
        check(
            SCAN_STATS["device_syms"] == s0["device_syms"]
            and SCAN_STATS["host_syms"] > s0["host_syms"],
            "host-pinned create did not scan on the host",
        )
        same, detail = same_parts(created, host_twin)
        check(same, f"device and host archives differ: {detail}")
        print(f"host_twins: device archive == host archive ({detail})", flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four_card_phase(coll, workdir, clock, results) -> None:
    import jax

    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.core.decompressor import Decompressor
    from agc_tpu.ops.kmers import CHUNK
    from agc_tpu.parallel.sharding import make_mesh, mesh_create_archive

    inputs = [p for _n, p, _c in coll]
    one = os.path.join(workdir, "one_card.agc")
    meshed = os.path.join(workdir, "mesh.agc")
    sharded = os.path.join(workdir, "shards.agc")
    check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")

    with phase("one_card_create", clock, results):
        create_archive(one, inputs, CompressorParams())
    with phase("mesh_create", clock, results):
        mesh_create_archive(
            meshed, inputs, CompressorParams(),
            mesh=make_mesh(jax.devices()[:4]), chunk_len=CHUNK,
        )
    with phase("process_shards_create", clock, results):
        err = io.StringIO()
        os.environ["AGC_TPU_SHARD_TIMINGS"] = "1"
        try:
            with contextlib.redirect_stderr(err):
                cli("create", "--shards", "4", "--shard-workers", "process",
                    "-o", sharded, *inputs)
        finally:
            del os.environ["AGC_TPU_SHARD_TIMINGS"]
            sys.stderr.write(err.getvalue())
        tag = "AGC_TPU_SHARD_TIMINGS "
        timings = [json.loads(ln[len(tag):]) for ln in
                   err.getvalue().splitlines() if ln.startswith(tag)]
        check(len(timings) == 1, "the sharded create reported no timings")
        workers = timings[0]["worker_devices"]
        print(f"process_shards: {timings[0]}", flush=True)
        # on a GPU each worker must have run on exactly one card
        platform = jax.devices()[0].platform
        check(
            len(workers) == 4 and all(
                p == platform and (platform != "gpu" or n == 1)
                for p, n in workers
            ),
            f"shard workers ran on {workers}, not one {platform} each",
        )
    with phase("compare", clock, results):
        for path in (meshed, sharded):
            same, detail = same_parts(one, path)
            print(
                f"{os.path.basename(path)} vs one-card archive: "
                f"{'identical' if same else 'DIFFERENT'} ({detail})",
                flush=True,
            )
            check(same, f"{path} differs from the one-card archive: {detail}")
            d = Decompressor(path)
            try:
                for name, _p, codes in coll:
                    got = d.get_contig_seq(name, CONTIG)
                    check(got == ascii_of(codes), f"{path}: {name} extracts wrong")
            finally:
                d.close()
        print(f"compare: {len(coll)} samples extract exactly from both", flush=True)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size-mb", type=int, default=None,
                    help="reference size in Mbase (default 48); a smaller "
                    "size rehearses the script where there is no GPU")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run only the kernel phase")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU create comparison")
    args = ap.parse_args(argv)

    import jax

    import agc_tpu.ops  # noqa: F401  (x64 and the compile cache)

    dev = jax.devices()
    device = {
        "platform": dev[0].platform,
        "kind": dev[0].device_kind,
        "count": len(dev),
    }
    print(f"jax {jax.__version__}: {device}", flush=True)
    for line in card_lines():
        print(f"card: {line}", flush=True)
    if device["platform"] != "gpu" and args.size_mb is None:
        print("FAIL: JAX found no GPU (pass --size-mb to rehearse here)")
        return 2
    if device["platform"] == "gpu" and args.size_mb is not None:
        print("FAIL: --size-mb is for rehearsal without a GPU; on a GPU "
              "the script runs at full size")
        return 2
    full = args.size_mb is None
    size_mb = 48 if full else args.size_mb

    clock = CompileClock()
    results: dict[str, str] = {}
    workdir = tempfile.mkdtemp(prefix="agc_chip_smoke_")
    try:
        t0 = time.perf_counter()
        n_hap = 8 if args.four_cards else 5  # 4 created + 1 appended
        coll = make_collection(workdir, size_mb, n_hap)
        total = sum(len(c) for _n, _p, c in coll)
        print(
            f"data: {len(coll)} samples, {total} bases, generated in "
            f"{time.perf_counter() - t0:.3f} s",
            flush=True,
        )
        if args.four_cards:
            four_card_phase(coll, workdir, clock, results)
        else:
            with phase("kernels", clock, results):
                kernel_phase(coll, full, clock)
            if not args.kernels_only:
                pipeline_phase(coll, workdir, clock, results)
    except PhaseFailed as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phases: {results}", flush=True)
    print(f"device peak memory: {peak_bytes()}", flush=True)
    if device["platform"] != "gpu":
        print(f"FAIL: phases ran on {device['platform']}, not a GPU")
        return 2
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
