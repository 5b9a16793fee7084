"""True multi-process (multi-host) ``create`` over ``jax.distributed``.

The reference tool is strictly single-host (SURVEY.md section 2.6: threads
only, no NCCL/MPI). This module is the multi-process layer added here:
every host (or every GPU of one host) runs one process of this worker,
joined through
``jax.distributed.initialize``; the dense exchanges ride XLA collectives
over the global device mesh, and the ragged merge payload travels through
the coordination-service key-value store that the pod's processes already
share.

Collective schedule (the distributed analogue of the reference's in-band
``new_splitters``/``registration`` token protocol, agc_compressor.cpp:
1114-1237):

1. **K-mer pool merge, range-partitioned** — each host collects the
   canonical k-mers of its slice of the reference contigs, buckets them by
   owner (``(kmer >> (64-2k)) % n_procs`` — the low bits of the
   meaningful field; codes are left-aligned) and exchanges buckets with one
   ``all_to_all`` over the host mesh axis; the received range is sorted
   and reduced to singleton/duplicate boundary masks INSIDE the same
   device program (``_exchange_and_reduce_owned``), so the pool never
   round-trips through the host. This is the distributed replacement for
   the reference's single radix sort + ``remove_non_singletons``
   (agc_compressor.cpp:490, 664).
2. **Singleton table replication** — one padded ``all_gather``; every host
   ends up with the identical sorted singleton table.
3. **Greedy splitter emission, contig-sharded** — the reference's greedy
   scan is per-contig (find_splitters_in_contig, agc_compressor.cpp:762),
   so hosts split the reference contigs round-robin and union the emitted
   splitter k-mers with a second padded ``all_gather``. The union is
   order-independent, hence identical on every host.
4. **Data-parallel compression** — samples round-robin across hosts, each
   host runs the standard device-scan + host-matcher pipeline against the
   replicated splitter set (``_CapturingCompressor``). Adaptive mode
   (``-a``) keeps the growing splitter table synchronized: at every sample
   barrier each host contributes its pending new splitters to one padded
   ``all_gather`` and merges the union before rescanning its hard contigs
   (the reference's ``new_splitters`` token, agc_compressor.cpp:1187-1237,
   as a collective); hosts with shorter shards drain the remaining rounds
   with empty contributions so the collectives stay lockstep.
5. **Merge on the writer host** — shard results are posted to the
   coordination KV store; host 0 replays them with the deterministic
   merge (``_merge_shards``), producing an archive whose extraction
   output is byte-identical to a single-host create.

On GPUs phases 1-3 ride NCCL collectives; the CPU test shape (used by
tests/test_jaxdist.py) runs N local processes with gloo collectives,
which exercises the identical code path.
"""

from __future__ import annotations

import argparse
import base64
import os
import pickle
import sys

import numpy as np

_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # canonical k-mers are min(dir,rc),
# and rc(all-ones) == 0, so the all-ones word can never be a canonical code


# ---------------------------------------------------------------------------
# mesh + padded collective helpers
# ---------------------------------------------------------------------------


def _host_mesh(n_procs: int):
    """One device per process, ordered by process index."""
    import jax
    from jax.sharding import Mesh

    per_proc: dict[int, object] = {}
    for d in jax.devices():
        per_proc.setdefault(d.process_index, d)
    devs = [per_proc[i] for i in range(n_procs)]
    return Mesh(np.array(devs), ("host",))


def _global_rows(mesh, local_block: np.ndarray):
    """Assemble a global array sharded on axis 0 over "host" from each
    process's local block (same shape everywhere)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.devices.size
    global_shape = (n * local_block.shape[0],) + local_block.shape[1:]
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("host")), local_block, global_shape
    )


def _replicated_np(arr) -> np.ndarray:
    import jax

    return np.asarray(jax.device_get(arr.addressable_shards[0].data))


def _allgather_counts(mesh, pid: int, n: int, value: int) -> np.ndarray:
    """Every process learns every process's ``value`` (psum of one-hots)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    row = np.zeros((1, n), dtype=np.int64)
    row[0, pid] = value
    arr = _global_rows(mesh, row)
    f = jax.jit(
        shard_map(
            lambda x: jax.lax.psum(x, "host"),
            mesh=mesh,
            in_specs=P("host", None),
            out_specs=P("host", None),
            check_vma=False,
        )
    )
    return _replicated_np(f(arr)).reshape(n)


def _allgather_u64(mesh, pid: int, n: int, values: np.ndarray) -> np.ndarray:
    """Union-style gather of ragged u64 arrays: pad to the global max,
    all_gather, strip sentinels. Returns the concatenation (all rows)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    counts = _allgather_counts(mesh, pid, n, len(values))
    m = max(1, int(counts.max()))
    row = np.full((1, m), _SENTINEL, dtype=np.uint64)
    row[0, : len(values)] = values
    arr = _global_rows(mesh, row)
    f = jax.jit(
        shard_map(
            lambda x: jax.lax.all_gather(x, "host", axis=0, tiled=True),
            mesh=mesh,
            in_specs=P("host", None),
            out_specs=P(None, None),
            check_vma=False,
        )
    )
    rows = _replicated_np(f(arr))
    out = [rows[j, : counts[j]] for j in range(n)]
    return np.concatenate(out) if out else np.empty(0, dtype=np.uint64)


@__import__("functools").lru_cache(maxsize=32)
def _exchange_reduce_fn(mesh, n: int, m: int):
    """Compiled collective program for one exchange+reduce round, cached
    by (mesh, row width): chunked exchanges run many rounds of the same
    pow2-padded shape, and rebuilding jit(shard_map(...)) per call would
    re-trace (and on a pod re-compile) every round."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(x):
        y = jax.lax.all_to_all(
            x, "host", split_axis=0, concat_axis=0, tiled=True
        )  # (n, m): row j = my range's k-mers from process j
        s = jnp.sort(y.reshape(-1))  # sentinels sort to the tail
        diff_prev = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
        diff_next = jnp.concatenate([s[1:] != s[:-1], jnp.ones(1, bool)])
        valid = s != _SENTINEL
        single = diff_prev & diff_next & valid
        dup_first = diff_prev & ~diff_next & valid
        return (
            s.reshape(1, -1),
            single.reshape(1, -1),
            dup_first.reshape(1, -1),
        )

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=P("host", None),
            out_specs=(P("host", None), P("host", None), P("host", None)),
            check_vma=False,
        )
    )


def _exchange_and_reduce_owned(
    mesh, pid: int, n: int, buckets: list[np.ndarray], m: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Range-partitioned k-mer pool merge as ONE device program: send
    bucket j to process j (``all_to_all``), then — without returning the
    pool to the host — sort the received range and reduce it to boundary
    masks on the device. Returns (global singletons, duplicated uniques)
    of the k-mer range this process owns, sorted ascending.

    This is the distributed replacement for the reference's single-host
    radix sort + ``remove_non_singletons`` (agc_compressor.cpp:490, 664):
    the sort that dominates discovery runs on every host's accelerator,
    and only the (much smaller) reduced tables ever reach the host. Rows
    are padded to the all-process maximum bucket size (pow2, so repeat
    runs reuse the executable); the sentinel sorts above every canonical
    code (rc(all-ones) == 0, doc at _SENTINEL) so padding never mixes
    with real k-mers. Pass ``m`` (an agreed pow2 row width) to skip the
    internal count gather when the caller already knows the global max."""
    import jax

    if m is None:
        local_max = max((len(b) for b in buckets), default=0)
        counts = _allgather_counts(mesh, pid, n, local_max)
        m = max(1, 1 << int(counts.max() - 1).bit_length())
    block = np.full((n, m), _SENTINEL, dtype=np.uint64)
    for j, b in enumerate(buckets):
        block[j, : len(b)] = b
    arr = _global_rows(mesh, block)
    s_g, single_g, dup_g = _exchange_reduce_fn(mesh, n, m)(arr)

    def _mine(a) -> np.ndarray:
        # one device per process: shard 0 is this process's row
        return np.asarray(jax.device_get(a.addressable_shards[0].data))[0]

    s = _mine(s_g)
    return s[_mine(single_g)], s[_mine(dup_g)]


# ---------------------------------------------------------------------------
# distributed splitter discovery
# ---------------------------------------------------------------------------


def _distributed_splitters(
    mesh, pid: int, n: int, reference_file: str, params
) -> tuple:
    """Phases 1-3 of the module docstring. Returns the (identical on every
    host) splitter k-mer set, -f fallback records [(prev, cur, kmer,
    is_dir), ...] (empty without -f), and the adaptive-mode candidate
    tables (reference singletons / duplicated k-mers; empty without -a,
    reference: determine_splitters' adaptive branch,
    agc_compressor.cpp:515-517)."""
    from ..core.compressor import _FallbackFilter, greedy_splitter_walk
    from ..core.genome_io import preprocess_raw_contig, read_contigs_raw
    from ..ops.kmers import dir_rc_kmers_np

    k = params.kmer_length
    contigs = [
        preprocess_raw_contig(raw) for _, raw in read_contigs_raw(reference_file)
    ]
    my_contigs = list(range(pid, len(contigs), n))
    fb_filter = _FallbackFilter(params.fallback_frac)

    # 1. local k-mer occurrences -> range-partitioned exchange
    locs = []
    for ci in my_contigs:
        udir, urc, valid = dir_rc_kmers_np(contigs[ci], k)
        locs.append(np.minimum(udir, urc)[valid])
    local = (
        np.concatenate(locs) if locs else np.empty(0, dtype=np.uint64)
    )
    # canonical codes are LEFT-aligned (low 64-2k bits are zero), so a
    # plain modulo would send every k-mer to process 0 for power-of-two
    # n; partition on the meaningful field instead (its low bits are the
    # fastest-varying bases)
    owner = (
        (local >> np.uint64(64 - 2 * k)) % np.uint64(n)
    ).astype(np.int64)
    buckets = [local[owner == j] for j in range(n)]
    # exchange + owned-range reduction stay on device (sort + boundary
    # masks inside the collective program); only the reduced tables
    # (global singletons / duplicated uniques of my range) come back.
    # Pools past the exchange budget run in value-range chunks: every
    # bucket is sub-partitioned by the k-mers' top bits, one collective
    # round per chunk — chunks are value-disjoint AND value-ordered, so
    # per-chunk singleton/duplicate verdicts are globally correct and
    # their concatenation is already sorted.
    budget = int(
        os.environ.get("AGC_TPU_DIST_EXCHANGE_BUDGET", str(256 << 20))
    )
    local_max = max((len(b) for b in buckets), default=0)
    global_max = int(_allgather_counts(mesh, pid, n, local_max).max())

    def _pow2(v: int) -> int:
        return max(1, 1 << int(v - 1).bit_length())

    # budget accounting uses the PADDED row width the device block will
    # actually allocate; under value skew a chunk's true max can exceed
    # global_max/n_chunks, so the budget is a target, not a hard bound —
    # the per-chunk count gather pads each round to its real max
    n_chunks = 1
    while (
        n * _pow2((global_max + n_chunks - 1) // n_chunks) * 8 > budget
        and n_chunks < 1 << 16
    ):
        n_chunks *= 2
    if n_chunks == 1:
        singles, dup_uniques = _exchange_and_reduce_owned(
            mesh, pid, n, buckets, m=_pow2(global_max)
        )
    else:
        shift = np.uint64(64 - int(np.log2(n_chunks)))
        keys = [(b >> shift).astype(np.int64) for b in buckets]
        s_parts, d_parts = [], []
        for c in range(n_chunks):
            sub = [b[k == c] for b, k in zip(buckets, keys)]
            s, d = _exchange_and_reduce_owned(mesh, pid, n, sub)
            s_parts.append(s)
            d_parts.append(d)
        singles = np.concatenate(s_parts)
        dup_uniques = np.concatenate(d_parts)

    # 2. replicate the full singleton table (adaptive mode additionally
    # replicates the duplicated-unique table: find_new_splitters excludes
    # both from promotion, agc_compressor.cpp:2054-2082)
    table = _allgather_u64(mesh, pid, n, singles)
    table.sort()
    if params.adaptive_compression:
        cand_duplicated = _allgather_u64(mesh, pid, n, dup_uniques)
        cand_duplicated.sort()
        cand_singletons = table
    else:
        cand_duplicated = np.empty(0, dtype=np.uint64)
        cand_singletons = np.empty(0, dtype=np.uint64)

    # 3. greedy emission over my contig slice (the shared reference walk,
    #    agc_compressor.cpp:762-825), union across hosts; with -f the walk
    #    also yields this slice's fallback records
    found: list[int] = []
    records: list[tuple] = []
    for ci in my_contigs:
        codes = contigs[ci]
        if len(codes) < k:
            continue
        udir, urc, valid = dir_rc_kmers_np(codes, k)
        canon = np.minimum(udir, urc)
        ix = np.searchsorted(table, canon)
        member = valid & (
            table[np.minimum(ix, max(0, table.size - 1))] == canon
        ) if table.size else np.zeros(len(canon), dtype=bool)
        hits = np.flatnonzero(member)
        fb_ctx = (
            (valid, canon, udir, urc, fb_filter) if fb_filter else None
        )
        spl, fbs = greedy_splitter_walk(
            len(codes), k, params.segment_size, hits, canon[hits], fb_ctx
        )
        found.extend(spl)
        records.extend(fbs)

    merged = _allgather_u64(
        mesh, pid, n, np.array(sorted(set(found)), dtype=np.uint64)
    )
    splitter_set = set(int(x) for x in merged)

    if fb_filter:
        # union the fallback records (order is irrelevant: the voting
        # matcher counts pairs into sets); rows of 4 u64 ride the same
        # padded all_gather
        flat = np.array(
            sorted(
                {(p, c, km, int(d)) for p, c, km, d in records}
            ),
            dtype=np.uint64,
        ).reshape(-1)
        rows = _allgather_u64(mesh, pid, n, flat).reshape(-1, 4)
        fallback_records = sorted(
            {(int(r[0]), int(r[1]), int(r[2]), bool(r[3])) for r in rows}
        )
    else:
        fallback_records = []
    return splitter_set, fallback_records, cand_singletons, cand_duplicated


class _CollectiveSplitterExchange:
    """Per-barrier union of pending new splitters across all hosts (the
    reference's new_splitters token, agc_compressor.cpp:1187-1237, as one
    padded all_gather per sample barrier). Every host must perform the
    same TOTAL number of exchanges; hosts that finish their sample shard
    early drain the remaining rounds with empty contributions
    (run_worker)."""

    def __init__(self, mesh, pid: int, n: int):
        self.mesh, self.pid, self.n = mesh, pid, n
        self.rounds_done = 0

    def exchange(self, pending) -> list[int]:
        vals = np.array(
            sorted({int(x) for x in pending}), dtype=np.uint64
        )
        merged = _allgather_u64(self.mesh, self.pid, self.n, vals)
        self.rounds_done += 1
        return [int(x) for x in merged]


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


def run_worker(
    pid: int,
    n_procs: int,
    coordinator: str,
    out_path: str,
    input_files: list[str],
    params=None,
) -> None:
    """One host's role in a distributed create. Call once per process;
    process 0 writes the archive."""
    from ..core.compressor import CompressorParams

    params = params or CompressorParams()
    if params.concatenated_genomes:
        raise NotImplementedError(
            "distributed create does not support concatenated mode (-c): "
            "its grouping is defined by a single global contig stream"
        )

    import jax

    if jax.config.jax_platforms == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=n_procs, process_id=pid
    )
    from jax._src import distributed as _dist

    kv = _dist.global_state.client

    from ..core.genome_io import sample_name_from_path
    from .distributed import _CapturingCompressor, _merge_shards

    seen: set = set()
    files = [f for f in input_files if not (f in seen or seen.add(f))]
    sample_files = [(sample_name_from_path(f), f) for f in files]

    mesh = _host_mesh(n_procs)
    splitter_set, fallback_records, cand_singletons, cand_duplicated = (
        _distributed_splitters(mesh, pid, n_procs, files[0], params)
    )

    # phase 4: compress my sample shard. Adaptive mode synchronizes the
    # growing splitter table across hosts: one exchange per sample
    # barrier, every host performing exactly max_rounds exchanges (shard 0
    # holds the most samples under round-robin; shorter shards — or shards
    # that skipped a barrier for an unopenable/empty input — drain the
    # difference with empty contributions so the collectives stay
    # lockstep).
    my_files = [sf for i, sf in enumerate(sample_files) if i % n_procs == pid]
    exchanger = (
        _CollectiveSplitterExchange(mesh, pid, n_procs)
        if params.adaptive_compression and n_procs > 1
        else None
    )
    comp = _CapturingCompressor(
        params, splitter_set, pid, fallback_records,
        cand_singletons=cand_singletons, cand_duplicated=cand_duplicated,
        exchanger=exchanger,
    )
    comp.add_sample_files(my_files)
    if exchanger is not None:
        max_rounds = len(sample_files[0::n_procs])
        while exchanger.rounds_done < max_rounds:
            comp._pending_new_splitters = exchanger.exchange(
                comp._pending_new_splitters
            )
            comp._merge_new_splitters()
    res = comp.result()

    # phase 5: results to the writer host via the coordination KV store.
    # (Pod-scale note: the KV store is fine for toy/test payloads; at
    # production scale the same rendezvous should carry object-store URIs
    # instead of inline pickles.)
    blob = pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL)
    kv.key_value_set_bytes(f"agc_shard_{pid}", blob)

    if pid == 0:
        results = [res]
        for j in range(1, n_procs):
            raw = kv.blocking_key_value_get_bytes(
                f"agc_shard_{j}", 600_000
            )
            results.append(pickle.loads(raw))
        try:
            _merge_shards(out_path, params, sample_files, splitter_set, results)
        except BaseException:
            # same policy as create_archive_sharded: never leave a
            # footerless partial archive at the user's path
            import contextlib
            import os as _os

            with contextlib.suppress(OSError):
                _os.unlink(out_path)
            raise
        kv.key_value_set("agc_merge_done", "1")
    else:
        kv.blocking_key_value_get("agc_merge_done", 600_000)
    jax.distributed.shutdown()


def _parse_params(blob: str):
    from ..core.compressor import CompressorParams

    if not blob:
        return CompressorParams()
    return pickle.loads(base64.b64decode(blob))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="agc-tpu-distributed-worker",
        description="one host's worker process of a distributed create",
    )
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--procid", type=int, required=True)
    ap.add_argument("--out", required=True, help="output archive (written by process 0)")
    ap.add_argument("--params", default="", help="base64 pickled CompressorParams")
    ap.add_argument("inputs", nargs="+", help="FASTA inputs (first is the reference)")
    a = ap.parse_args(argv)
    run_worker(
        a.procid, a.nprocs, a.coordinator, a.out, a.inputs, _parse_params(a.params)
    )
    return 0


def create_archive_jaxdist(
    out_path: str,
    input_files: list[str],
    params=None,
    n_procs: int = 2,
    coordinator: str | None = None,
) -> None:
    """Local launcher: spawn ``n_procs`` worker processes on this machine
    (the single-machine shape of a multi-host run; each worker is exactly
    what one host would execute). Each worker gets a GPU of its own, or
    runs on the CPU when AGC_TPU_WORKER_PLATFORM=cpu (see
    distributed.worker_envs)."""
    import pickle as _p
    import socket
    import subprocess

    from .distributed import worker_envs

    envs = worker_envs(n_procs)
    if coordinator is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"

    blob = base64.b64encode(
        _p.dumps(params, protocol=_p.HIGHEST_PROTOCOL)
    ).decode() if params is not None else ""

    procs = []
    for pid in range(n_procs):
        cmd = [
            sys.executable, "-m", "agc_tpu.parallel.jaxdist",
            "--coordinator", coordinator,
            "--nprocs", str(n_procs),
            "--procid", str(pid),
            "--out", out_path,
        ]
        if blob:
            cmd += ["--params", blob]
        cmd += list(input_files)
        procs.append(subprocess.Popen(cmd, env={**os.environ, **envs[pid]}))
    rc = [p.wait() for p in procs]
    if any(rc):
        raise RuntimeError(f"distributed workers failed: exit codes {rc}")


if __name__ == "__main__":
    sys.exit(main())
