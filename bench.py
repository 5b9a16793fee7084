"""End-to-end compression benchmark (driver contract: prints ONE JSON line).

Measures create-archive throughput (bases/s) on a deterministic synthetic
collection shaped like the reference tool's headline workload (HPP
haplotype collections, reference README.md:10-13): one reference genome
built from REPEAT FAMILIES plus unique backbone (real assemblies'
duplication structure is what loads the matcher and gives AGC its 200:1
headline ratio — a uniform-random reference exercises neither), and
resequenced samples mutated from it (SNPs + indels).

Baseline: the reference's published aggregate compression throughput of
~400 Mbases/s on a 32-thread Threadripper 3990X (reference README.md:12-13).

Capture protocol: warm until two consecutive runs agree within 15% (cap
6; the first run compiles every kernel shape), then 5 measured runs;
min is reported (the workload is deterministic). The result names the
device it ran on; a run whose JAX platform is not a GPU fails instead
of reporting a CPU number.

Round-trip correctness is asserted on a sampled contig before reporting.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_BASES_PER_S = 400e6

REF_MB = int(os.environ.get("AGC_TPU_BENCH_REF_MB", "16"))
N_SAMPLES = int(os.environ.get("AGC_TPU_BENCH_SAMPLES", "7"))
# Archive profile: "tpu-rans" is this framework's native profile (the
# headline number; same container layout, parts coded by the
# lane-interleaved rANS stage — on this box ALSO the fastest host path:
# the native coder measures ~3x zstd-13/17 on real part mixes, see
# DESIGN.md §7). "zstd" is the reference-compatible parity profile;
# its numbers live in tools/ratio_compare.py runs, where archives are
# compared against the reference binary's.
PROFILE = os.environ.get("AGC_TPU_BENCH_PROFILE", "tpu-rans")
# plain: round-1..3's uniform-random reference (kept for comparison runs)
STRUCTURE = os.environ.get("AGC_TPU_BENCH_STRUCTURE", "repeats")


def _make_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def _make_structured_ref(rng: np.random.Generator, n: int) -> np.ndarray:
    """Reference with repeat families: ~40% of the sequence is copies of
    a library of repeat units (0.5-8 kb) at ~1% divergence, interleaved
    with unique backbone. This is the duplication structure of real
    assemblies (segmental duplications, mobile elements) that loads the
    matcher's candidate searches — a uniform-random reference has no
    duplicated k-mers, so splitter discovery sees only singletons."""
    lib = [
        _make_seq(rng, int(rng.integers(500, 8000)))
        for _ in range(48)
    ]
    pieces = []
    total = 0
    while total < n:
        if rng.random() < 0.45:
            unit = lib[int(rng.integers(len(lib)))]
            copy = unit.copy()
            n_sub = max(1, len(copy) // 100)  # ~1% divergence per copy
            pos = rng.integers(0, len(copy), size=n_sub)
            copy[pos] = (copy[pos] + rng.integers(1, 4, size=n_sub)) % 4
            pieces.append(copy)
            total += len(copy)
        else:
            m = int(rng.integers(2000, 20000))
            pieces.append(_make_seq(rng, m))
            total += m
    return np.concatenate(pieces)[:n]


def _mutate(rng: np.random.Generator, seq: np.ndarray) -> np.ndarray:
    """SNPs (~0.1%) + a handful of structural indels, vectorized."""
    out = seq.copy()
    n_sub = max(1, len(seq) // 1000)
    pos = rng.integers(0, len(seq), size=n_sub)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    # indels: splice out / duplicate small windows
    pieces = []
    cur = 0
    for _ in range(8):
        cut = int(rng.integers(cur + 1, cur + len(seq) // 8))
        if cut >= len(out) - 1:
            break
        pieces.append(out[cur:cut])
        if rng.random() < 0.5:
            cut += int(rng.integers(1, 50))  # deletion
        else:
            pieces.append(out[cut : cut + int(rng.integers(1, 50))])  # dup
        cur = min(cut, len(out))
    pieces.append(out[cur:])
    return np.concatenate(pieces)


_ALPHA = np.frombuffer(b"ACGTN", dtype=np.uint8)  # symbol 4: N


def _write_fasta(path: str, name: str, seq: np.ndarray) -> None:
    ascii_seq = _ALPHA[seq]
    line = 80
    n_lines = (len(ascii_seq) + line - 1) // line
    padded = np.full(n_lines * line, ord(" "), dtype=np.uint8)
    padded[: len(ascii_seq)] = ascii_seq
    mat = padded.reshape(n_lines, line)
    with_nl = np.concatenate(
        [mat, np.full((n_lines, 1), ord("\n"), dtype=np.uint8)], axis=1
    )
    body = with_nl.reshape(-1).tobytes().replace(b" ", b"")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(body)


def device_info() -> dict:
    """The device JAX runs on, and the card as nvidia-smi names it
    (name, power limit), for printing beside every result."""
    import subprocess

    import jax

    devs = jax.devices()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        card = []
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card,
    }


def main() -> int:
    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.core.decompressor import Decompressor

    device = device_info()
    print(f"# device: {device}", file=sys.stderr)
    if device["platform"] != "gpu":
        print(
            f"bench: JAX runs on {device['platform']}, not a GPU; no result",
            file=sys.stderr,
        )
        return 2

    rng = np.random.default_rng(20260816)
    tmp = tempfile.mkdtemp(prefix="agc_tpu_bench_")

    if STRUCTURE == "plain":
        ref = _make_seq(rng, REF_MB << 20)
    else:
        ref = _make_structured_ref(rng, REF_MB << 20)
    files = [os.path.join(tmp, "ref.fa")]
    _write_fasta(files[0], "chr1", ref)
    total_bases = len(ref)
    for i in range(N_SAMPLES):
        mut = _mutate(rng, ref)
        p = os.path.join(tmp, f"s{i}.fa")
        _write_fasta(p, "chr1", mut)
        files.append(p)
        total_bases += len(mut)

    def one_run(path: str) -> float:
        t0 = time.time()
        create_archive(path, files, CompressorParams(profile=PROFILE))
        return time.time() - t0

    # -- warmup until converged: identical workload, so every kernel
    #    shape compiles (and lands in the persistent cache) on the first
    #    pass. Stop when two consecutive runs agree within 15% (cap 6).
    warm = []
    for i in range(6):
        warm.append(one_run(os.path.join(tmp, "warm.agc")))
        print(
            f"# warmup {i}: {warm[-1]:.2f}s"
            + (" (incl. compiles)" if i == 0 else ""),
            file=sys.stderr,
        )
        if (
            len(warm) >= 2
            and max(warm[-2:]) <= min(warm[-2:]) * 1.15
        ):
            break

    # -- measured runs: MINIMUM of 5 (timeit's rationale: the workload is
    #    deterministic, so all variance is interference). All runs printed
    #    for transparency.
    archive = os.path.join(tmp, "bench.agc")
    from agc_tpu.ops.kmers import SCAN_STATS

    dev0 = SCAN_STATS["device_syms"]
    host0 = SCAN_STATS["host_syms"]
    times = [one_run(archive) for _ in range(5)]
    dt = min(times)
    print(f"# runs: {['%.2f' % t for t in times]}", file=sys.stderr)
    print(
        f"# spread max/min: {max(times) / min(times):.2f}", file=sys.stderr
    )
    print(
        f"# scan symbols in the measured runs: device"
        f" {SCAN_STATS['device_syms'] - dev0}, host"
        f" {SCAN_STATS['host_syms'] - host0}",
        file=sys.stderr,
    )

    # correctness spot check: extract one sample, compare
    d = Decompressor(archive)
    got = d.get_contig_seq(f"s{N_SAMPLES - 1}", "chr1")
    d.close()
    raw = open(files[-1], "rb").read().split(b"\n", 1)[1].replace(b"\n", b"")
    assert got == raw, "round-trip mismatch in benchmark"

    value = total_bases / dt
    archive_size = os.path.getsize(archive)
    result = {
        "metric": "create_bases_per_s",
        "value": round(value, 1),
        "unit": "bases/s",
        "vs_baseline": round(value / BASELINE_BASES_PER_S, 4),
        "device": device,
    }
    print(json.dumps(result))
    print(
        f"# {total_bases} bases in {dt:.2f}s; archive {archive_size} bytes "
        f"(ratio {total_bases / archive_size:.1f}:1)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
