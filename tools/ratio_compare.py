"""Archive-size parity harness: agc-tpu vs the reference binary.

Runs a matrix of deterministic synthetic workloads through BOTH tools
with matching params and reports total archive size plus a per-stream-
class breakdown (segment refs / segment deltas / collection metadata /
other), so ratio losses can be attributed to a stage.

The reference binary is expected at $AGC_REF_BIN (default
/tmp/refbuild/bin/agc, built from /root/reference in an earlier round).
Workloads mirror the shapes in BASELINE.md's driver configs
(resequenced collection, E. coli-like, SARS-like adaptive drift,
many-contig assemblies); generators are deterministic so runs compare
across code changes.

Usage: python tools/ratio_compare.py [workload ...]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF_BIN = os.environ.get("AGC_REF_BIN", "/tmp/refbuild/bin/agc")

_ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fasta(path: str, contigs: list[tuple[str, np.ndarray]]) -> int:
    total = 0
    with open(path, "wb") as f:
        for name, seq in contigs:
            total += len(seq)
            ascii_seq = _ALPHA[seq].tobytes()
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(ascii_seq), 80):
                f.write(ascii_seq[i : i + 80] + b"\n")
    return total


def _mutate(rng, seq, sub_rate=1e-3, n_indels=8, indel_max=50):
    out = seq.copy()
    n_sub = max(1, int(len(seq) * sub_rate))
    pos = rng.integers(0, len(seq), size=n_sub)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_sub)) % 4
    pieces, cur = [], 0
    for _ in range(n_indels):
        cut = int(rng.integers(cur + 1, cur + max(2, len(seq) // n_indels)))
        if cut >= len(out) - 1:
            break
        pieces.append(out[cur:cut])
        if rng.random() < 0.5:
            cut += int(rng.integers(1, indel_max))
        else:
            pieces.append(out[cut : cut + int(rng.integers(1, indel_max))])
        cur = min(cut, len(out))
    pieces.append(out[cur:])
    return np.concatenate(pieces)


# ---------------------------------------------------------------- workloads
# each returns (files, extra_cli_args) with files[0] the reference sample


def wl_resequenced(tmp: str) -> tuple[list[str], list[str]]:
    """BASELINE bench shape: one ref + mutated resequencings, defaults."""
    rng = np.random.default_rng(20260816)
    ref = rng.integers(0, 4, size=8 << 20, dtype=np.uint8)
    files = [os.path.join(tmp, "ref.fa")]
    _write_fasta(files[0], [("chr1", ref)])
    for i in range(7):
        p = os.path.join(tmp, f"s{i}.fa")
        _write_fasta(p, [("chr1", _mutate(rng, ref))])
        files.append(p)
    return files, []


def wl_ecoli(tmp: str) -> tuple[list[str], list[str]]:
    """E. coli-like: 20 x 1 Mb genomes drifting from a common ancestor."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=1 << 20, dtype=np.uint8)
    files = []
    cur = base
    for i in range(20):
        cur = _mutate(rng, cur, sub_rate=2e-3, n_indels=12)
        p = os.path.join(tmp, f"ec{i}.fa")
        _write_fasta(p, [("genome", cur)])
        files.append(p)
    return files, []


def wl_sars_adaptive(tmp: str) -> tuple[list[str], list[str]]:
    """SARS-like: 200 x 30 kb drifting lineages, adaptive small-segment."""
    rng = np.random.default_rng(99)
    base = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    files = []
    lineages = [base]
    for i in range(200):
        parent = lineages[rng.integers(0, len(lineages))]
        cur = _mutate(rng, parent, sub_rate=3e-4, n_indels=2, indel_max=12)
        if len(lineages) < 8 and rng.random() < 0.2:
            lineages.append(cur)
        p = os.path.join(tmp, f"cov{i:03d}.fa")
        _write_fasta(p, [("genome", cur)])
        files.append(p)
    return files, ["-a", "-k", "25", "-s", "10000"]


def wl_many_contig(tmp: str) -> tuple[list[str], list[str]]:
    """Assembly-like: 4 samples x 60 contigs x ~100 kb, shared ancestry."""
    rng = np.random.default_rng(42)
    contigs = [rng.integers(0, 4, size=int(rng.integers(60_000, 140_000)), dtype=np.uint8) for _ in range(60)]
    files = []
    for s in range(4):
        cs = [(f"ctg{j:02d}", _mutate(rng, c, sub_rate=1.5e-3, n_indels=4)) for j, c in enumerate(contigs)]
        p = os.path.join(tmp, f"asm{s}.fa")
        _write_fasta(p, cs)
        files.append(p)
    return files, []


def wl_fallback(tmp: str) -> tuple[list[str], list[str]]:
    """Bacterial-like with rearrangements + -f 0.01 (fallback minimizers)."""
    rng = np.random.default_rng(1234)
    base = rng.integers(0, 4, size=1 << 20, dtype=np.uint8)
    files = []
    for i in range(12):
        g = _mutate(rng, base, sub_rate=4e-3, n_indels=16)
        # structural rearrangement: swap two large blocks
        n = len(g)
        a, b = sorted(rng.integers(0, n, size=2))
        if b - a > n // 8:
            g = np.concatenate([g[:a], g[b:], g[a:b]])
        p = os.path.join(tmp, f"bac{i}.fa")
        _write_fasta(p, [("genome", g)])
        files.append(p)
    return files, ["-f", "0.01"]


WORKLOADS = {
    "resequenced": wl_resequenced,
    "ecoli": wl_ecoli,
    "sars_adaptive": wl_sars_adaptive,
    "many_contig": wl_many_contig,
    "fallback": wl_fallback,
}


# ---------------------------------------------------------------- breakdown


def stream_breakdown(path: str) -> dict[str, int]:
    from agc_tpu.core.archive import ArchiveReader

    out = {"seg_ref": 0, "seg_delta": 0, "collection": 0, "other": 0}
    with ArchiveReader(path) as r:
        for name in r.stream_names():
            sz = r.stream_packed_size(name)
            if name.startswith("x") and name.endswith("r"):
                out["seg_ref"] += sz
            elif name.startswith("x") and name.endswith("d"):
                out["seg_delta"] += sz
            elif name.startswith("collection"):
                out["collection"] += sz
            else:
                out["other"] += sz
    return out


def run_one(name: str, gen) -> None:
    tmp = tempfile.mkdtemp(prefix=f"ratio_{name}_")
    files, extra = gen(tmp)
    total_bases = sum(
        len(line)
        for f in files
        for line in open(f, "rb").read().split(b"\n")
        if not line.startswith(b">")
    )

    ref_out = os.path.join(tmp, "ref_tool.agc")
    # the available reference build is ASan-instrumented: disable leak
    # reports (it "leaks" its queues by design) — sizes are unaffected,
    # wall times are NOT comparable from this binary
    ref_env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0")
    subprocess.run(
        [REF_BIN, "create", "-o", ref_out, "-t", "4", *extra, *files],
        check=True,
        capture_output=True,
        env=ref_env,
    )

    ours_out = os.path.join(tmp, "ours.agc")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([REPO, *pp])
    subprocess.run(
        [sys.executable, "-m", "agc_tpu.cli.main", "create", "-o", ours_out, *extra, *files],
        check=True,
        capture_output=True,
        env=env,
    )

    sz_ref = os.path.getsize(ref_out)
    sz_ours = os.path.getsize(ours_out)
    bd_ref = stream_breakdown(ref_out)
    bd_ours = stream_breakdown(ours_out)
    print(f"\n== {name}: {total_bases/1e6:.1f} Mbases, {len(files)} files {extra}")
    print(
        f"   reference {sz_ref:>10,} B ({total_bases/sz_ref:7.1f}:1)   "
        f"ours {sz_ours:>10,} B ({total_bases/sz_ours:7.1f}:1)   "
        f"ours/ref = {sz_ours/sz_ref:.4f}"
    )
    for k in ("seg_ref", "seg_delta", "collection", "other"):
        r, o = bd_ref[k], bd_ours[k]
        flag = "" if r == 0 else f"  ours/ref = {o/r:.4f}"
        print(f"     {k:<11} ref {r:>10,}   ours {o:>10,}{flag}")


def main() -> None:
    names = sys.argv[1:] or list(WORKLOADS)
    for n in names:
        run_one(n, WORKLOADS[n])


if __name__ == "__main__":
    main()
