"""Sharded collection compression: data-parallel over samples with a
deterministic archive merge.

The reference is strictly single-host (SURVEY.md section 2.6); this module
adds the scale-out layer for several devices or hosts:

- The splitter set is determined once from the reference genome and
  replicated to every shard (host) -- it is small (~1 per segment_size
  bases).
- Samples are partitioned round-robin across shards; each shard runs the
  normal compression pipeline (device scans + host matcher) over its
  samples only, producing shard-local segment groups.
- Merge (on the writer host): shard-local group ids are renumbered into a
  single global id space (raw groups stay shared; shard-local LZ groups
  are appended in shard order). Same-splitter-pair groups from different
  shards keep separate global ids -- members were LZ-coded against their
  shard's group reference, so no re-encoding is needed; the cost is a
  duplicated group reference per extra shard that saw the same pair
  (bounded by shards x new-pair rate).
- Collection metadata is rebuilt globally in the user-specified sample
  order, so extraction output is independent of the shard count.

Shards run as local threads (sharing this process's device), as worker
processes with one GPU each, or as jax.distributed processes
(parallel/jaxdist.py); all exercise the identical partition/merge logic
(tests/test_distributed.py).
"""

from __future__ import annotations

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..core.archive import ArchiveWriter
from ..core.codecs import ss_base, ss_delta_name, ss_ref_name
from ..core.collection import CollectionV3
from ..core.compressor import (
    EMPTY,
    NO_RAW_GROUPS,
    PK_EMPTY,
    Compressor,
    CompressorParams,
)
from ..core.genome_io import sample_name_from_path


@dataclass
class _ShardResult:
    """Everything a shard produces for the merge step.

    Shards SCAN AND CUT; the writer MATCHES AND STORES: each captured
    segment carries its boundary k-mers, and the merge replays the real
    matcher (_add_segment) against the GLOBAL group inventory in global
    sample order. Shard-local matching would make group choices (one-
    splitter pairings, missing-middle splits) depend on each shard's
    private inventory — measured +11..27% archive growth at 2..8 shards
    from divergent pair choices; replay keeps N-shard archives within
    2% of 1-shard (test_shard_count_archive_growth_bounded). The writer
    paid the LZ+entropy cost at merge anyway (members always re-encoded
    against merged references), so moving the cheap matching there too
    costs only the candidate estimates."""

    shard_id: int
    sample_names: list
    # sample -> ordered [(contig, ord, data_bytes, (kf_dir, kf_rc,
    # kf_full), (kb_dir, kb_rc, kb_full))] in contig/segment order
    segments: dict = field(default_factory=dict)
    splitter_set: set = field(default_factory=set)
    # sample -> fallback-minimizer records collected while scanning it
    # (merged at that sample's barrier, mirroring the plain schedule)
    fallback_by_sample: dict = field(default_factory=dict)
    # sample -> ordered full contig names (so the merge never re-parses
    # the input FASTA on the writer host just to recover names)
    contig_names: dict = field(default_factory=dict)
    # (platform, device count) of the process that compressed the shard
    device: tuple = ()


class _CapturingCompressor(Compressor):
    """Compressor that captures segment members instead of writing them.

    Reuses the full matcher pipeline; ``_store_segments`` records the
    (ordered) member list per local group so the merge step can replay
    them into the global archive."""

    def __init__(
        self,
        params,
        splitter_set,
        shard_id,
        fallback_records=(),
        cand_singletons=None,
        cand_duplicated=None,
        exchanger=None,
        inventory=None,
    ):
        # bypass Compressor.__init__ archive plumbing: build state manually
        self.p = params
        self.k = params.kmer_length
        from ..version import AGC_FILE_MAJOR, AGC_FILE_MINOR

        self.archive_version = AGC_FILE_MAJOR * 1000 + AGC_FILE_MINOR

        class _NullWriter:
            def register_stream(self, name):
                return 0

            def add_part_buffered(self, *a, **k):
                pass

            def add_part(self, *a, **k):
                pass

            def flush_buffers(self):
                pass

        self.writer = _NullWriter()
        self.collection = CollectionV3(
            params.pack_cardinality, params.segment_size, params.kmer_length
        )
        self.map_segments = {PK_EMPTY: 0}
        self.terminators = {}
        self.v_segments = [None] * NO_RAW_GROUPS
        self.no_segments = NO_RAW_GROUPS
        from ..core.compressor import _FallbackFilter

        self.fallback_filter = _FallbackFilter(params.fallback_frac)
        self.map_fallback = {}
        # Discovery's fallback records, with plain-create timing (the
        # reference merges them at the FIRST registration barrier,
        # agc_compressor.cpp:1126): shard 0's first sample IS the
        # reference, so it keeps them pending until its first barrier;
        # every other shard's first sample followed that barrier in the
        # single-host order, so those shards pre-merge before compressing.
        self._pending_fallback = list(fallback_records)
        if shard_id != 0:
            self._merge_fallback_mappings()
        # adaptive mode: the discovery's candidate tables (reference
        # singletons + duplicated k-mers) gate which k-mers a splitterless
        # contig may promote (find_new_splitters, agc_compressor.cpp:2054)
        self.cand_singletons = (
            np.asarray(cand_singletons, dtype=np.uint64)
            if cand_singletons is not None
            else np.empty(0, dtype=np.uint64)
        )
        self.cand_duplicated = (
            np.asarray(cand_duplicated, dtype=np.uint64)
            if cand_duplicated is not None
            else np.empty(0, dtype=np.uint64)
        )
        self._cand_singletons_dev = None
        self._pending_new_splitters = []
        self._splitter_log = []
        self._raw_contigs = []
        # cross-shard new-splitter exchanger (pod path); None = shard-local
        self._exchanger = exchanger
        self._buf_known = {}
        self._buf_new = []
        self.processed_samples = 0
        self.processed_bases = 0
        self.file_type_info = {}
        self._closed = False
        self._mode = "shard"
        self._n_threads = max(1, (os.cpu_count() or 2) // 2)
        from ..utils.profiling import StageTimers

        self.timers = StageTimers()
        self._splitter_set = set(splitter_set)
        self._refresh_splitter_table()
        self.shard_id = shard_id
        self.captured_segments: dict[str, list] = {}
        self.fallback_by_sample: dict[str, list] = {}
        self._current_sample = None
        # -c mode: capture keys + per-file contig order (the merge
        # replays the GLOBAL contig stream in file order). Keys come
        # from the contig->file map, NOT the file currently being
        # ingested: -c batches hold pack_cardinality contigs and SPAN
        # file boundaries, so by the time a batch's segments are cut
        # the ingestion cursor may already be on a later file.
        self._cur_cfile: str | None = None
        self._cfile_contigs: dict[str, list[str]] = {}
        self._ccontig_file: dict[str, str] = {}
        # boot-broadcast group-reference inventory: pk -> (stored ref
        # bytes, blake2b-16). Two-splitter segments whose pk is here get
        # their LZ delta computed SHARD-SIDE against the true global
        # group reference (groups born in the reference sample are
        # created from exactly these bytes at the writer); the writer
        # verifies the hash before reuse, so a wrong guess only costs a
        # local re-encode, never archive bytes. This moves most of the
        # merge's LZ wall onto the (parallel) shards.
        self._inventory = inventory or {}
        self._inv_lz: dict = {}
        # shard-local segment writers exist only to hold LZ contexts for
        # estimates; they never touch an archive
        for gid in range(NO_RAW_GROUPS):
            self.v_segments[gid] = self._make_writer(gid)

    def _make_writer(self, gid):
        from ..core.segment import SegmentWriter

        class _NullArchive:
            def add_part_buffered(self, *a, **k):
                pass

            def add_part(self, *a, **k):
                pass

            def register_stream(self, name):
                return 0

        return SegmentWriter(
            ss_base(self.archive_version, gid),
            _NullArchive(),
            self.p.pack_cardinality,
            self.p.min_match_len,
            self.archive_version,
        )

    def _synchronize(self) -> None:
        """Shard-local barrier: adaptive splitter merges only (matching
        and storing happen at the global merge). Fallback records are
        banked per sample so the merge can replay them at that sample's
        barrier, mirroring the plain-create schedule."""
        if self.p.adaptive_compression:
            self._adaptive_barrier()
        if self._pending_fallback:
            key = self._current_sample
            self.fallback_by_sample.setdefault(key, []).extend(
                self._pending_fallback
            )
            self._pending_fallback = []
        self.processed_samples += 1

    def _exchange_new_splitters(self, pending):
        if self._exchanger is None:
            return pending
        return self._exchanger.exchange(pending)

    def _add_segment(
        self, sample, contig, part_no, segment, kmer_front, kmer_back,
        device_hint=None,
    ) -> int:
        """Capture the cut segment + its boundary k-mers; the MERGE runs
        the real matcher against the global inventory (see _ShardResult).
        Always returns 0: splits are the merge's decision, so shard-side
        part numbers are per-segment ordinals."""
        key = sample or self._ccontig_file.get(contig) or self._cur_cfile or ""
        self._current_sample = key
        rec = (
            contig,
            part_no,
            segment.astype(np.uint8, copy=False).tobytes(),
            (kmer_front.dir, kmer_front.rc, kmer_front.full),
            (kmer_back.dir, kmer_back.rc, kmer_back.full),
        )
        if (
            kmer_front.full
            and kmer_back.full
            and self._inventory
            and self._lz_mode() == "classic"
        ):
            a, b = kmer_front.data(), kmer_back.data()
            pk = (a, b) if a < b else (b, a)
            inv = self._inventory.get(pk)
            if inv is not None:
                ref_b, ref_h = inv
                from ..core.compressor import _rc_numeric

                stored = (
                    rec[2]
                    if a < b
                    else _rc_numeric(segment)
                    .astype(np.uint8, copy=False)
                    .tobytes()
                )
                lz = self._inv_lz.get(pk)
                if lz is None:
                    from ..core.lz import LZDiff

                    lz = LZDiff(
                        self.p.min_match_len,
                        v1_grammar=self.archive_version < 2000,
                    )
                    lz.prepare(ref_b)
                    self._inv_lz[pk] = lz
                rec = rec + (lz.encode(stored), ref_h)
        self.captured_segments.setdefault(key, []).append(rec)
        return 0

    def _device_match_prepass(self, codes, cuts, cut_kmers) -> dict:
        return {}  # no shard-side matching: nothing to rank

    def _store_segments(self) -> None:
        self._buf_known = {}  # raw-group buffers (nothing is staged)

    def _synchronize_sample_name(self, name: str) -> None:
        """Record which sample the next barrier's fallback records
        belong to (merge replays them at that sample's barrier)."""
        self._current_sample = name

    # -c capture hooks (base: no-ops). Segments and contig order are
    # keyed by input FILE so the merge can replay the global contig
    # stream with the plain -c barrier schedule.
    def _concat_file_begin(self, fname: str) -> None:
        self._cur_cfile = fname
        self._cfile_contigs.setdefault(fname, [])

    def _concat_contig_registered(self, fname: str, cid: str) -> None:
        self._cfile_contigs[fname].append(cid)
        self._ccontig_file[cid] = fname

    def result(self) -> _ShardResult:
        import jax

        res = _ShardResult(self.shard_id, [s.name for s in self.collection.samples])
        local = jax.local_devices()
        res.device = (local[0].platform, len(local))
        res.segments = self.captured_segments
        res.fallback_by_sample = self.fallback_by_sample
        res.splitter_set = self._splitter_set
        if self.p.concatenated_genomes:
            # -c: contigs keyed per input file PATH, in ingestion order
            res.contig_names = {
                f: list(c) for f, c in self._cfile_contigs.items()
            }
        else:
            res.contig_names = {
                s.name: [c.name for c in s.contigs]
                for s in self.collection.samples
            }
        return res


def visible_gpus() -> list[str]:
    """Ids of the GPUs this process may hand to workers, read without
    starting a JAX runtime (which would reserve memory on every card):
    CUDA_VISIBLE_DEVICES when set, else ``nvidia-smi -L``."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [
        str(i)
        for i, line in enumerate(ln for ln in out.splitlines()
                                 if ln.startswith("GPU "))
    ]


def worker_envs(n_workers: int) -> list[dict]:
    """Environment overrides for each of ``n_workers`` JAX worker
    processes.

    Each worker gets a GPU of its own (CUDA_VISIBLE_DEVICES), because a
    JAX process reserves most of a card's memory when it starts. Workers
    allocate on demand (XLA_PYTHON_CLIENT_PREALLOCATE=false): the
    coordinating parent may already hold its own reservation on their
    cards. More GPU workers than visible cards, none visible included,
    is refused. Workers run on the CPU only when
    AGC_TPU_WORKER_PLATFORM=cpu says so."""
    plat = os.environ.get("AGC_TPU_WORKER_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return [
            {"JAX_PLATFORMS": "cpu",
             "JAX_CPU_COLLECTIVES_IMPLEMENTATION": "gloo"}
            for _ in range(n_workers)
        ]
    if plat not in ("", "gpu"):
        raise ValueError(
            f"AGC_TPU_WORKER_PLATFORM={plat!r}: expected 'gpu' or 'cpu'"
        )
    gpus = visible_gpus()
    if n_workers > len(gpus):
        raise ValueError(
            f"{n_workers} GPU workers requested but {len(gpus)} GPU(s) "
            "visible: each worker process needs a card of its own. Use "
            "at most one worker per card, thread shards, or "
            "AGC_TPU_WORKER_PLATFORM=cpu"
        )
    return [
        {"CUDA_VISIBLE_DEVICES": gpus[i], "JAX_PLATFORMS": "cuda",
         "XLA_PYTHON_CLIENT_PREALLOCATE": "false"}
        for i in range(n_workers)
    ]


def _run_shard_task(args):
    """One shard's compression (module-level: runs in worker PROCESSES).

    On a multi-device host this is what each worker executes against its
    own card; the splitter set is the replicated state, the returned
    _ShardResult is what travels to the writer (it is plain picklable
    data). ``env`` (process workers only) binds the worker to its
    platform and card; it is applied before the worker first touches a
    device.
    """
    (params, splitter_set, shard_id, shard_files, fallback_records,
     cand_singletons, cand_duplicated, inventory, env) = args
    if env:
        import jax

        os.environ.update(env)
        jax.config.update("jax_platforms", env["JAX_PLATFORMS"])
    comp = _CapturingCompressor(
        params, splitter_set, shard_id, fallback_records,
        cand_singletons=cand_singletons, cand_duplicated=cand_duplicated,
        inventory=inventory,
    )
    comp.add_sample_files(shard_files)
    return comp.result()


def create_archive_sharded(
    out_path: str,
    input_files: list[str],
    params: CompressorParams | None = None,
    n_shards: int = 2,
    worker: str = "thread",
) -> None:
    """Data-parallel create: shard samples, compress, merge into one archive.

    Extraction output is byte-identical regardless of ``n_shards``.
    ``worker="process"`` runs each shard in its own OS process (the
    multi-host execution shape: independent runtimes, results shipped to
    the writer by value), one GPU per worker (:func:`worker_envs`);
    ``"thread"`` shares this process's device.
    """
    params = params or CompressorParams()
    envs = (
        worker_envs(n_shards)
        if n_shards > 1 and worker == "process"
        else [None] * n_shards
    )
    if params.concatenated_genomes and (
        params.adaptive_compression or params.fallback_frac > 0
    ):
        # -c sharding replays the global contig stream at the writer
        # (byte-identical to 1-shard), but adaptive/-f grow state at the
        # plain schedule's CONTIG-BLOCK barriers, which shard-local
        # ingestion cannot reproduce (blocks span file boundaries);
        # these combinations stay single-host (DESIGN.md section 6)
        raise NotImplementedError(
            "sharded -c supports neither adaptive mode nor -f: their "
            "barrier state follows the plain create's contig-block "
            "schedule, which is not reproducible shard-side"
        )
    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    import time as _time

    timings = {"t_boot": _time.perf_counter()}

    # Phase 1: splitters (and -f fallback records; adaptive candidate
    # tables) from the reference genome, shared by every shard
    boot = Compressor(out_path + ".tmp0", params, reference_file=files[0])
    try:
        splitter_set = set(boot.splitter_set_snapshot())
        fallback_records = list(boot._pending_fallback)
        cand_singletons = np.asarray(boot.cand_singletons, dtype=np.uint64)
        cand_duplicated = np.asarray(boot.cand_duplicated, dtype=np.uint64)
    finally:
        boot.writer.close()
        with __import__("contextlib").suppress(OSError):
            os.unlink(out_path + ".tmp0")

    # Phase 1b: group-reference inventory. Scan+cut the REFERENCE
    # sample with the boot splitters; every two-splitter pk it yields
    # will be created at the writer from exactly these bytes (the merge
    # replays samples in global order, reference first). Broadcasting
    # {pk: (ref_bytes, hash)} lets shards compute LZ deltas against the
    # TRUE global group references, killing most of the merge's LZ wall
    # (on a pod: an all_gather of ~the reference sample). The writer
    # hash-checks every shipped delta, so this is a pure optimization.
    inventory = {}
    inv_ref_blobs = {}
    if os.environ.get("AGC_TPU_SHARD_INV", "1") != "0":
        import hashlib

        from ..core.compressor import _rc_numeric
        from ..core.segment import store_ref_blob

        inv_comp = _CapturingCompressor(
            params, splitter_set, 0, fallback_records,
            cand_singletons=cand_singletons,
            cand_duplicated=cand_duplicated,
        )
        inv_comp.add_sample_files(sample_files[:1])
        for segs in inv_comp.captured_segments.values():
            for rec in segs:
                kf, kb = rec[3], rec[4]
                if not (kf[2] and kb[2]):
                    continue
                a, b = min(kf[0], kf[1]), min(kb[0], kb[1])
                pk = (a, b) if a < b else (b, a)
                if pk in inventory:
                    continue
                stored = rec[2]
                if a >= b:
                    stored = (
                        _rc_numeric(np.frombuffer(stored, dtype=np.uint8))
                        .astype(np.uint8, copy=False)
                        .tobytes()
                    )
                h = hashlib.blake2b(stored, digest_size=16).digest()
                inventory[pk] = (stored, h)
                if params.profile == "zstd":
                    # precompress the group-reference part too: the
                    # writer stores it directly (hash-checked) instead
                    # of re-running ref_payload+zstd at merge time -
                    # ~40% of the measured merge-store wall
                    blob, meta = store_ref_blob(stored, params.profile)
                    inv_ref_blobs[pk] = (blob, meta, h)
        del inv_comp

    # Phase 2: shard the samples round-robin and compress independently.
    # Adaptive mode here is SHARD-LOCAL: each shard grows its own splitter
    # table from its splitterless contigs (deterministic for a given shard
    # count, identical between thread and process workers); the pod path
    # (parallel/jaxdist.py) instead exchanges new splitters at every sample
    # barrier with collectives, like the reference's new_splitters token.
    shards: list[list] = [[] for _ in range(n_shards)]
    for i, sf in enumerate(sample_files):
        shards[i % n_shards].append(sf)
    tasks = [
        (params, splitter_set, sid, shards[sid], fallback_records,
         cand_singletons, cand_duplicated, inventory, envs[sid])
        for sid in range(n_shards)
    ]

    timings["t_shards"] = _time.perf_counter()
    if n_shards > 1 and worker == "process":
        import multiprocessing as mp

        # spawn (not fork): each worker initializes its own JAX runtime.
        # One task per worker process, so every worker binds the card of
        # the task it runs.
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes=n_shards, maxtasksperchild=1) as pool:
            results = pool.map(_run_shard_task, tasks, chunksize=1)
    elif n_shards > 1:
        with ThreadPoolExecutor(max_workers=n_shards) as pool:
            results = list(pool.map(_run_shard_task, tasks))
    else:
        results = [_run_shard_task(tasks[0])]
    timings["t_merge"] = _time.perf_counter()

    # Phase 3: deterministic merge on the writer host. On failure remove
    # the partial output — a footerless .agc at the user's path reads as
    # a finished archive (same policy as Compressor.abort)
    try:
        merge_split = _merge_shards(
            out_path, params, sample_files, splitter_set, results,
            inv_ref_blobs=inv_ref_blobs,
        )
    except BaseException:
        with __import__("contextlib").suppress(OSError):
            os.unlink(out_path)
        raise
    timings["t_end"] = _time.perf_counter()
    if os.environ.get("AGC_TPU_SHARD_TIMINGS"):
        import json as _json
        import sys as _sys

        out = {
            "n_shards": n_shards,
            "worker": worker,
            "worker_devices": [list(r.device) for r in results],
            "boot_s": round(timings["t_shards"] - timings["t_boot"], 2),
            "shards_s": round(timings["t_merge"] - timings["t_shards"], 2),
            "merge_s": round(timings["t_end"] - timings["t_merge"], 2),
            **{k: round(v, 2) for k, v in merge_split.items()},
        }
        print("AGC_TPU_SHARD_TIMINGS " + _json.dumps(out), file=_sys.stderr)


def _hint_of(rec):
    """(pk, delta_bytes, ref_hash) from a 7-wide captured record, or
    None. pk is recomputed from the boundary k-mers with the same rule
    _add_segment uses, so the hint attaches only when the matcher's
    final pk agrees (compressor.py _add_segment)."""
    if len(rec) < 7:
        return None
    kf, kb = rec[3], rec[4]
    if not (kf[2] and kb[2]):
        return None
    a, b = min(kf[0], kf[1]), min(kb[0], kb[1])
    pk = (a, b) if a < b else (b, a)
    return (pk, rec[5], rec[6])


def _merge_shards(out_path, params, sample_files, splitter_set, results,
                  inv_ref_blobs=None):
    from ..core.compressor import Compressor as _C

    merged = _C.__new__(_C)
    merged.p = params
    merged.k = params.kmer_length
    from ..version import AGC_FILE_MAJOR, AGC_FILE_MINOR

    merged.archive_version = AGC_FILE_MAJOR * 1000 + AGC_FILE_MINOR
    merged.writer = ArchiveWriter(out_path)
    merged.collection = CollectionV3(
        params.pack_cardinality, params.segment_size, params.kmer_length
    )
    merged.collection.profile = params.profile
    from ..utils.profiling import StageTimers

    merged.timers = StageTimers()
    merged._inv_ref_blobs = inv_ref_blobs or {}
    merged.map_segments = {PK_EMPTY: 0}
    merged.terminators = {}
    merged.v_segments = []
    merged.no_segments = 0
    # adaptive shards grow their tables; the archive's splitters stream is
    # the union (stored sorted, so shard order is immaterial). Non-adaptive
    # shards all hold exactly the boot set.
    merged._splitter_set = set(splitter_set)
    for res in results:
        merged._splitter_set |= res.splitter_set
    merged.processed_samples = 0
    merged.processed_bases = 0
    merged._closed = False
    merged._mode = "create"
    merged._n_threads = max(1, (os.cpu_count() or 2) // 2)
    merged._buf_known = {}
    merged._buf_new = []
    from ..core.compressor import _FallbackFilter

    merged.fallback_filter = _FallbackFilter(0.0)
    merged.map_fallback = {}
    merged._pending_fallback = []
    merged._pending_new_splitters = []
    merged._raw_contigs = []
    merged.cand_singletons = np.empty(0, dtype=np.uint64)
    merged.cand_duplicated = np.empty(0, dtype=np.uint64)
    merged._cand_singletons_dev = None
    from ..version import COMMENT, PRODUCER, PRODUCER_BUILD, PRODUCER_VERSION

    merged.file_type_info = {
        "producer": PRODUCER,
        "producer_version_major": str(PRODUCER_VERSION[0]),
        "producer_version_minor": str(PRODUCER_VERSION[1]),
        "producer_version_build": PRODUCER_BUILD,
        "file_version_major": str(AGC_FILE_MAJOR),
        "file_version_minor": str(AGC_FILE_MINOR),
        "comment": COMMENT,
    }
    if params.profile != "zstd":
        merged.file_type_info["compression-profile"] = params.profile
    merged._refresh_splitter_table()

    # collection streams MUST be ids 0/1/2 (the reference's append
    # resolves them by id and segfaults on any other layout — same
    # invariant as the plain create path, compressor.py
    # _register_collection_streams)
    merged._register_collection_streams()

    # store-side state must exist BEFORE any _make_writer call: the
    # tpu-rans profile's _entropy_sink() lazily creates the shared
    # EntropyBatcher on first use, and assigning _entropy_batcher = None
    # after writers were made would orphan their sink (its deferred
    # parts would never flush — the raw groups' seed packs vanished)
    merged._pending_store = None
    merged._store_pool = None
    merged._match_bank = None
    merged._anchor_bank = None
    merged._entropy_batcher = None
    merged._pending_meta = []
    merged._batches_stored_end = 0

    # raw groups first (shared id space 0..15)
    for gid in range(NO_RAW_GROUPS):
        merged.writer.register_stream(ss_delta_name(merged.archive_version, gid))
        seg = merged._make_writer(gid)
        merged.v_segments.append(seg)
        seg.add_raw(b"\x7f")
    merged.no_segments = NO_RAW_GROUPS

    # Replay: the writer runs the REAL matcher over every captured
    # segment in global sample order against the growing global
    # inventory — group pairing, one-splitter estimation, missing-middle
    # splits and fallback-minimizer matching all happen HERE, exactly as
    # a plain create would do them (shard-local matching diverges per
    # shard inventory; see _ShardResult). Storing (LZ + entropy) was
    # always the writer's job.
    from ..core.compressor import Kmer

    per_sample: dict[str, list] = {}
    fb_per_sample: dict[str, list] = {}
    contig_names: dict[str, list[str]] = {}
    for res in sorted(results, key=lambda r: r.shard_id):
        for sample, segs in res.segments.items():
            per_sample[sample] = segs
        for sample, recs in res.fallback_by_sample.items():
            fb_per_sample.setdefault(sample, []).extend(recs)
        contig_names.update(res.contig_names)

    import time as _time

    split = {"merge_match_s": 0.0, "merge_store_s": 0.0, "merge_close_s": 0.0}

    if params.concatenated_genomes:
        # -c replay: the global contig stream in input-file order with
        # the plain create's schedule (one barrier per pack_cardinality
        # contigs, blocks spanning file boundaries — add_sample_files'
        # concatenated branch), so the archive is byte-identical to a
        # 1-shard -c create. Each contig registers as its own
        # collection sample (collection.register_sample_contig("", cid)).
        n_in_batch = 0
        for _sample_name, path in sample_files:
            merged.collection.reset_prev_sample_name()
            segs_by_contig: dict[str, list] = {}
            for rec in per_sample.get(path, []):
                segs_by_contig.setdefault(rec[0], []).append(rec)
            for cid in contig_names.get(path, []):
                if not merged.collection.register_sample_contig("", cid):
                    import sys as _sys

                    print(
                        f"Error: Pair sample_name:contig_name {cid}:{cid}"
                        " is already in the archive!",
                        file=_sys.stderr,
                    )
                    continue
                t0 = _time.perf_counter()
                part_no = 0
                for rec in segs_by_contig.get(cid, []):
                    contig, _ord, data, kf, kb = rec[:5]
                    extra = merged._add_segment(
                        "",
                        contig,
                        part_no,
                        np.frombuffer(data, dtype=np.uint8),
                        Kmer(*kf),
                        Kmer(*kb),
                        delta_hint=_hint_of(rec),
                    )
                    part_no += 1 + extra
                split["merge_match_s"] += _time.perf_counter() - t0
                n_in_batch += 1
                if n_in_batch >= params.pack_cardinality:
                    t1 = _time.perf_counter()
                    merged._synchronize()
                    split["merge_store_s"] += _time.perf_counter() - t1
                    n_in_batch = 0
        t1 = _time.perf_counter()
        merged._synchronize()
        split["merge_store_s"] += _time.perf_counter() - t1
        t2 = _time.perf_counter()
        merged.close()
        split["merge_close_s"] = _time.perf_counter() - t2
        return split

    for sample_name, path in sample_files:
        merged.collection.reset_prev_sample_name()
        for cid in contig_names.get(sample_name, []):
            merged.collection.register_sample_contig(sample_name, cid)
        part_no: dict[str, int] = {}
        t0 = _time.perf_counter()
        for rec in per_sample.get(sample_name, []):
            contig, _ord, data, kf, kb = rec[:5]
            pn = part_no.get(contig, 0)
            extra = merged._add_segment(
                sample_name,
                contig,
                pn,
                np.frombuffer(data, dtype=np.uint8),
                Kmer(*kf),
                Kmer(*kb),
                delta_hint=_hint_of(rec),
            )
            part_no[contig] = pn + 1 + extra
        t1 = _time.perf_counter()
        split["merge_match_s"] += t1 - t0
        merged._register_segments()
        # async: zstd/LZ release the GIL, so this sample's store overlaps
        # the NEXT sample's matching replay on the writer (the same
        # store-worker pipeline the plain create uses); close() joins
        merged._store_segments(async_ok=True)
        merged._pending_fallback.extend(fb_per_sample.get(sample_name, []))
        merged._merge_fallback_mappings()
        merged.processed_samples += 1
        if merged.processed_samples % params.pack_cardinality == 0:
            # batch metadata serializes placements: in-flight async
            # stores must land first (same join the plain barrier does)
            merged._join_pending_store()
            merged.collection.store_contig_batch(
                merged.writer,
                merged.processed_samples - params.pack_cardinality,
                merged.processed_samples,
            )
        merged.writer.flush_buffers()
        split["merge_store_s"] += _time.perf_counter() - t1

    t2 = _time.perf_counter()
    merged.close()
    split["merge_close_s"] = _time.perf_counter() - t2
    return split
