"""Multi-device compression step: data-parallel contig scanning with
collective splitter synchronization.

The reference is single-host multithreaded (SURVEY.md section 2.6); this
build replaces the worker pool + in-band token protocol
(reference: agc_compressor.cpp:1093-1272) with an SPMD schedule over a
``jax.sharding.Mesh``:

- contig chunks are sharded over the ``d`` (data) mesh axis;
- the splitter k-mer table is replicated (it is small: ~1 entry per
  segment_size bases of the reference genome);
- per-chunk scans are embarrassingly parallel (the rolling-kmer kernel in
  ops/kmers.py);
- new-splitter discovery (adaptive mode) and new-group registration are
  synchronized with ``all_gather`` at batch barriers -- the direct analogue
  of the reference's ``new_splitters``/``registration`` tokens
  (agc_compressor.cpp:1114-1237);
- statistics are combined with ``psum``.

Per-host archive assembly gathers group blocks to host 0 (DCN/ICI), which
owns the single output archive.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import agc_tpu.ops  # noqa: F401  (x64)
from ..ops.kmers import _kmer_core


def make_mesh(devices=None, axis: str = "d") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


@partial(jax.jit, static_argnums=(2,))
def _scan_batch(chunks: jnp.ndarray, table: jnp.ndarray, k: int):
    """Batched per-chunk scan: canonical k-mers + membership + cut count.

    chunks: uint8[B, N] numeric symbols (255-padded).
    table: uint64[M] sorted splitter table (replicated).
    Returns (canon u64[B,N], valid bool[B,N], member bool[B,N]).
    """

    def one(chunk):
        udir, urc, valid = _kmer_core(chunk, k)
        canon = jnp.minimum(udir, urc)
        idx = jnp.searchsorted(table, canon)
        idx_c = jnp.clip(idx, 0, max(table.shape[0] - 1, 0))
        member = valid & (table[idx_c] == canon)
        return canon, valid, member

    return jax.vmap(one)(chunks)


@partial(jax.jit, static_argnums=(2,))
def _scan_batch_full(chunks: jnp.ndarray, table: jnp.ndarray, k: int):
    """Like :func:`_scan_batch` but also returns the per-position dir/rc
    k-mer words — the matcher needs both orientations of each splitter
    hit (Kmer objects carry dir+rc; reference: CKmer, kmer.h:350-357)."""

    def one(chunk):
        udir, urc, valid = _kmer_core(chunk, k)
        canon = jnp.minimum(udir, urc)
        idx = jnp.searchsorted(table, canon)
        idx_c = jnp.clip(idx, 0, max(table.shape[0] - 1, 0))
        member = valid & (table[idx_c] == canon)
        return member, udir, urc

    return jax.vmap(one)(chunks)


def make_compression_step(mesh: Mesh, k: int, axis: str = "d"):
    """Build the jitted multi-device compression step.

    The step consumes a [B, N] batch of contig chunks sharded over ``axis``
    and a replicated splitter table; it returns the per-position scan
    results (sharded), the all-gathered new-splitter candidates of the
    round, and psum'd batch statistics.
    """

    chunk_sharding = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None), P(), P()),
        check_vma=False,
    )
    def step(chunks, table, local_new_splitters):
        canon, valid, member = _scan_batch(chunks, table, k)
        # registration barrier: gather every device's newly discovered
        # splitters (adaptive mode) -- mirrors the reference's new_splitters
        # token merge (agc_compressor.cpp:1187-1237)
        gathered = jax.lax.all_gather(
            local_new_splitters, axis, axis=0, tiled=True
        )
        n_cuts = jax.lax.psum(jnp.sum(member), axis)
        return canon, member, gathered, n_cuts

    return jax.jit(step), chunk_sharding, repl


def shard_chunks(mesh: Mesh, chunks: np.ndarray, axis: str = "d"):
    """Place a [B, N] chunk batch sharded over the mesh axis."""
    return jax.device_put(chunks, NamedSharding(mesh, P(axis, None)))


def mesh_create_archive(
    out_path: str,
    input_files: list[str],
    params=None,
    mesh: Mesh | None = None,
    chunk_len: int = 1 << 14,
) -> None:
    """Full create with every contig membership scan executed as the
    MESH-SHARDED SPMD scan program (contig chunks sharded over the data
    axis, splitter table replicated) — the complete production pipeline
    (splitter discovery, all four matcher cases incl. missing-middle
    splits, barrier stores, metadata batches, footer) drives on the
    device mesh's scan results. Archives are byte-identical to the
    single-chip ``create_archive`` on the same inputs: the mesh changes
    WHERE the scans run, never their outcome (pinned by
    ``__graft_entry__.dryrun_multichip`` and tests/test_distributed.py).

    The reference has no distributed layer (SURVEY.md §2.6); this is the
    intra-host half of the replacement for its worker pool
    (agc_compressor.cpp:1093-1272): scans fan out over chips, the
    matcher consumes positions, the writer owns the archive.
    """
    from ..core.compressor import Compressor, CompressorParams
    from ..core.genome_io import (
        preprocess_raw_contig,
        read_contigs_raw,
        sample_name_from_path,
    )

    params = params or CompressorParams()
    if params.adaptive_compression or params.concatenated_genomes or (
        params.fallback_frac
    ):
        raise NotImplementedError(
            "mesh_create_archive covers the default mode; adaptive/-c/-f "
            "use the jax.distributed path (parallel/jaxdist.py)"
        )
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    k = params.kmer_length

    seen = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    comp = Compressor(out_path, params, reference_file=files[0])
    try:
        comp._ensure_splitters()
        table_np = np.asarray(comp.splitters, dtype=np.uint64)
        repl = NamedSharding(mesh, P())
        table = jax.device_put(table_np, repl) if len(table_np) else None
        step = None
        if table is not None:
            step, _cs, _repl = make_compression_step_full(mesh, k, axis)

        def mesh_hits(codes: np.ndarray):
            """Membership scan of one contig over the mesh: chunk with a
            (k-1) halo, shard rows across devices, run the SPMD step,
            translate member positions back to contig coordinates."""
            n = len(codes)
            if table is None or n < k:
                e = np.empty(0, dtype=np.int64)
                return e, e.astype(np.uint64), e.astype(np.uint64)
            plans = []  # (lo, end)
            start = 0
            while start < n:
                lo = max(0, start - (k - 1))
                end = min(lo + chunk_len, n)
                plans.append((lo, end, start))
                start = end
            rows_n = -(-len(plans) // n_dev) * n_dev
            mat = np.full((rows_n, chunk_len), 255, dtype=np.uint8)
            for r, (lo, end, _st) in enumerate(plans):
                mat[r, : end - lo] = codes[lo:end]
            member, udir, urc = step(shard_chunks(mesh, mat, axis), table)
            member = np.asarray(member)
            udir = np.asarray(udir)
            urc = np.asarray(urc)
            pos_l, ud_l, ur_l = [], [], []
            for r, (lo, end, st) in enumerate(plans):
                hj = np.flatnonzero(member[r])
                # keep k-mer END positions inside [st, end): halo windows
                # belong to the previous chunk
                hj = hj[(hj + lo >= st) & (hj < end - lo)]
                pos_l.append(hj + lo)
                ud_l.append(udir[r][hj])
                ur_l.append(urc[r][hj])
            return (
                np.concatenate(pos_l) if pos_l else np.empty(0, np.int64),
                np.concatenate(ud_l) if ud_l else np.empty(0, np.uint64),
                np.concatenate(ur_l) if ur_l else np.empty(0, np.uint64),
            )

        for sname, path in sample_files:
            comp.collection.reset_prev_sample_name()
            for cid, raw in read_contigs_raw(path):
                if not comp.collection.register_sample_contig(sname, cid):
                    import sys

                    print(
                        f"Error: Pair sample_name:contig_name {sname}:{cid}"
                        " is already in the archive!",
                        file=sys.stderr,
                    )
                    continue
                codes = preprocess_raw_contig(raw, cid)
                comp._process_contig(sname, cid, codes, hits=mesh_hits(codes))
            comp._synchronize()
    except BaseException:
        comp.abort()
        raise
    comp.close()


def make_compression_step_full(mesh: Mesh, k: int, axis: str = "d"):
    """Mesh step returning (member, udir, urc) — the scan outputs the
    matcher consumes (see :func:`_scan_batch_full`)."""
    chunk_sharding = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        check_vma=False,
    )
    def step(chunks, table):
        return _scan_batch_full(chunks, table, k)

    return jax.jit(step), chunk_sharding, repl
