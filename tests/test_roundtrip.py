"""End-to-end create/append/extract round-trips (the reference's CI model:
compress, extract, compare byte-identically; .github/workflows/main.yml)."""

import filecmp
import os
import random

import pytest

from agc_tpu.core.compressor import (
    CompressorParams,
    append_archive,
    create_archive,
)
from agc_tpu.core.decompressor import Decompressor

from util import make_collection, mutate, random_seq, write_fa

SMALL = CompressorParams(
    kmer_length=17, segment_size=1000, pack_cardinality=10, min_match_len=15
)


def _extract_and_compare(archive, files, tmp_path, line=70):
    d = Decompressor(archive)
    assert sorted(d.list_samples()) == sorted(s for s, _ in files)
    for sample, path in files:
        out = str(tmp_path / f"out_{sample}.fa")
        d.get_sample_file(out, [sample], line_length=line)
        assert filecmp.cmp(out, path, shallow=False), sample
    d.close()


def test_toy_create_roundtrip(toy_collection, tmp_path):
    archive = str(tmp_path / "toy.agc")
    create_archive(archive, [p for _, p in toy_collection], CompressorParams())
    _extract_and_compare(archive, toy_collection, tmp_path, line=80)


def test_synthetic_lz_roundtrip(tmp_path):
    files = make_collection(tmp_path)
    archive = str(tmp_path / "g.agc")
    create_archive(archive, [p for _, p in files], SMALL)
    _extract_and_compare(archive, files, tmp_path)
    # compression must actually work: mutated samples are cheap vs raw
    total_in = sum(os.path.getsize(p) for _, p in files)
    assert os.path.getsize(archive) < total_in / 3


def test_append_equals_extension(tmp_path):
    files = make_collection(tmp_path, n_samples=3)
    base = str(tmp_path / "base.agc")
    create_archive(base, [p for _, p in files[:2]], SMALL)
    ext1 = str(tmp_path / "ext1.agc")
    append_archive(base, ext1, [files[2][1]], SMALL)
    ext2 = str(tmp_path / "ext2.agc")
    append_archive(ext1, ext2, [files[3][1]], SMALL)
    _extract_and_compare(ext2, files, tmp_path)


def test_append_crosses_batch_boundary(tmp_path):
    # pack_cardinality=2 -> appending rewrites a partial metadata batch
    params = CompressorParams(
        kmer_length=17, segment_size=1000, pack_cardinality=2, min_match_len=15
    )
    files = make_collection(tmp_path, n_samples=4, contig_lens=(20000,))
    base = str(tmp_path / "base.agc")
    create_archive(base, [p for _, p in files[:3]], params)  # 3 = 1.5 batches
    ext = str(tmp_path / "ext.agc")
    append_archive(base, ext, [p for _, p in files[3:]], params)
    _extract_and_compare(ext, files, tmp_path)


def test_adaptive_mode_new_sequence(tmp_path):
    rng = random.Random(7)
    files = make_collection(tmp_path, rng=rng, n_samples=1, contig_lens=(30000,))
    # a sample unrelated to the reference: adaptive mode must add splitters
    alien = str(tmp_path / "alien.fa")
    alien_seq = random_seq(rng, 25000)
    write_fa(alien, [("z1", alien_seq)])
    files.append(("alien", alien))
    params = CompressorParams(
        kmer_length=17,
        segment_size=1000,
        pack_cardinality=10,
        min_match_len=15,
        adaptive_compression=True,
    )
    archive = str(tmp_path / "ad.agc")
    create_archive(archive, [p for _, p in files], params)
    _extract_and_compare(archive, files, tmp_path)


def test_concatenated_mode(tmp_path):
    rng = random.Random(3)
    seqs = [(f"ctg{i}", random_seq(rng, 5000)) for i in range(5)]
    path = str(tmp_path / "multi.fa")
    write_fa(path, seqs)
    params = CompressorParams(
        kmer_length=17,
        segment_size=1000,
        pack_cardinality=2,
        min_match_len=15,
        concatenated_genomes=True,
    )
    archive = str(tmp_path / "cat.agc")
    create_archive(archive, [path], params)
    d = Decompressor(archive)
    # every contig became its own sample
    assert sorted(d.list_samples()) == sorted(n for n, _ in seqs)
    for name, seq in seqs:
        got = d.get_contig_seq(name, name)
        assert got.decode() == seq
    d.close()


def test_concatenated_mode_reuses_groups(tmp_path):
    """-c with the documented invocation (reference given as a SEPARATE
    file; reference README.md:37-38,175): near-identical genomes in one
    concatenated file must share segment groups, not spawn one group per
    genome.  Regression for the degenerate-looking group explosion that
    only the UNdocumented single-file form produces (there the discovery
    pool holds every genome, so shared k-mers are non-singletons and the
    splitters land on per-genome mutation sites — same in the reference
    tool)."""
    rng = random.Random(5)
    base = random_seq(rng, 6000)
    ref_path = str(tmp_path / "ref.fa")
    write_fa(ref_path, [("base", base)])
    genomes = [(f"g{i:03d}", mutate(rng, base, subs=6, indels=1))
               for i in range(30)]
    cat_path = str(tmp_path / "all.fa")
    write_fa(cat_path, genomes)
    params = CompressorParams(
        kmer_length=17,
        segment_size=2000,
        min_match_len=15,
        concatenated_genomes=True,
        adaptive_compression=True,
    )
    archive = str(tmp_path / "cat.agc")
    create_archive(archive, [ref_path, cat_path], params)
    d = Decompressor(archive)
    assert sorted(d.list_samples()) == sorted(["base"] + [n for n, _ in genomes])
    for name, seq in genomes[::7]:
        assert d.get_contig_seq(name, name).decode() == seq
    n_groups = sum(
        1 for s in d.reader.stream_names()
        if s.startswith("x") and s.endswith("r")
    )
    d.close()
    # ~3 segments/genome, all shared against the base: a handful of
    # groups, far fewer than one per genome
    assert n_groups <= 12, n_groups


def test_getctg_ranges_on_own_archive(tmp_path):
    files = make_collection(tmp_path, n_samples=1)
    archive = str(tmp_path / "g.agc")
    create_archive(archive, [p for _, p in files], SMALL)
    d = Decompressor(archive)
    full = d.get_contig_seq("s0", "c1").decode()
    sub = d.get_contig_seq("s0", "c1", 1000, 2000).decode()
    assert sub == full[1000:2001]
    assert d.get_contig_length("s0", "c1") == len(full)
    d.close()


def test_gzip_output(tmp_path):
    import gzip

    files = make_collection(tmp_path, n_samples=1, contig_lens=(20000,))
    archive = str(tmp_path / "g.agc")
    create_archive(archive, [p for _, p in files], SMALL)
    d = Decompressor(archive)
    out = str(tmp_path / "s0.fa.gz")
    d.get_sample_file(out, ["s0"], line_length=70, gzip_level=6)
    with gzip.open(out, "rb") as f:
        data = f.read()
    with open(files[1][1], "rb") as f:
        assert data == f.read()
    d.close()


def test_iupac_and_n_runs(tmp_path):
    rng = random.Random(11)
    seq = (
        random_seq(rng, 3000)
        + "N" * 500
        + random_seq(rng, 2000)
        + "RYSWKMBDHV" * 5
        + random_seq(rng, 1000)
    )
    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", seq)])
    s0 = str(tmp_path / "m.fa")
    write_fa(s0, [("c1", mutate(rng, seq, 50, 5))])
    archive = str(tmp_path / "iupac.agc")
    create_archive(archive, [ref, s0], SMALL)
    _extract_and_compare(archive, [("r", ref), ("m", s0)], tmp_path)


def test_lowercase_soft_mask_uppercased(tmp_path):
    """Lowercase (soft-masked) bases map to the same numeric codes as
    uppercase and extract as UPPERCASE — the reference tool's behavior
    (cnv_num has no lowercase rows beyond acgtn/u; agc_basic.h:40-50),
    verified byte-identical against the reference binary on a mixed
    lowercase/IUPAC/N-run collection."""
    rng = random.Random(13)
    upper = random_seq(rng, 4000)
    mixed = "".join(
        ch.lower() if rng.random() < 0.3 else ch for ch in upper
    ) + "acgtn" + "ryswkmbdhvu"
    ref = str(tmp_path / "r.fa")
    write_fa(ref, [("c1", mixed)])
    archive = str(tmp_path / "lc.agc")
    create_archive(archive, [ref], SMALL)
    from agc_tpu.core.decompressor import Decompressor

    d = Decompressor(archive)
    got = d.get_contig_seq("r", "c1").decode()
    d.close()
    assert got == mixed.upper()


def test_cli_smoke(toy_collection, tmp_path, capsys):
    from agc_tpu.cli.main import main

    archive = str(tmp_path / "toy.agc")
    files = [p for _, p in toy_collection]
    ref_fa = dict(toy_collection)["ref"]
    assert main(["create", "-o", archive] + files) == 0
    assert main(["listset", archive, "-o", str(tmp_path / "samples.txt")]) == 0
    with open(tmp_path / "samples.txt") as f:
        assert f.read().splitlines() == ["a", "b", "c", "ref"]
    assert main(["listref", archive, "-o", str(tmp_path / "ref.txt")]) == 0
    with open(tmp_path / "ref.txt") as f:
        assert f.read() == "ref"
    assert (
        main(["getset", archive, "ref", "-o", str(tmp_path / "ref_out.fa")]) == 0
    )
    assert filecmp.cmp(
        str(tmp_path / "ref_out.fa"), ref_fa, shallow=False
    )
    assert (
        main(
            [
                "getctg",
                archive,
                "chr1@ref:4-10",
                "-o",
                str(tmp_path / "ctg.fa"),
            ]
        )
        == 0
    )
    with open(tmp_path / "ctg.fa") as f:
        lines = f.read().splitlines()
    assert lines[0] == ">chr1:4-10"
    assert len(lines[1]) == 7


def test_empty_contig_record_does_not_lose_following_contigs(tmp_path):
    """A zero-length FASTA record (">name" with no sequence) must not
    swallow the records after it. The empty record itself is dropped
    (it has no bases to store), but c2 survives — the reference binary
    silently LOSES every contig after the empty record here (its raw
    contig reader treats the next header as part of the empty record;
    genome_io.cpp:208-252), so this pins the stronger behavior."""
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(">c1\nACGTACGTAAACCCGGGTTTACGTACGTACGT\n>empty\n>c2\nTTTTGGGGCCCCAAAA\n")
    archive = str(tmp_path / "e.agc")
    create_archive(archive, [ref], SMALL)
    from agc_tpu.core.decompressor import Decompressor

    d = Decompressor(archive)
    assert d.list_contigs("ref") == ["c1", "c2"]
    assert d.get_contig_seq("ref", "c2") == b"TTTTGGGGCCCCAAAA"
    d.close()


def test_empty_fasta_file_skipped_with_remaining_samples_kept(tmp_path):
    """An empty input file is excluded (reference: warning + skip,
    agc_compressor.cpp:2165-2168) whether it is the reference slot or a
    later sample; the rest of the collection is stored normally."""
    empty = str(tmp_path / "empty.fa")
    open(empty, "w").close()
    s1 = str(tmp_path / "s1.fa")
    write_fa(s1, [("c1", "ACGTACGTAAACCCGGGTTTACGTACGTACGT")])
    from agc_tpu.core.decompressor import Decompressor

    a1 = str(tmp_path / "a1.agc")
    create_archive(a1, [empty, s1], SMALL)
    d = Decompressor(a1)
    assert d.list_samples() == ["s1"]
    d.close()

    a2 = str(tmp_path / "a2.agc")
    create_archive(a2, [s1, empty], SMALL)
    d = Decompressor(a2)
    assert d.list_samples() == ["s1"]
    d.close()
