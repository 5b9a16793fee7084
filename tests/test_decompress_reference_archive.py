"""Contract tests: byte-identical extraction from the reference-produced
archive fixture (reference CI: .github/workflows/main.yml)."""

import filecmp
import os

import pytest

from agc_tpu.api import AGCFile
from agc_tpu.core.decompressor import Decompressor, analyze_contig_query


@pytest.fixture(scope="module")
def toy_archive(toy_dir):
    path = os.path.join(toy_dir, "toy_ex.agc")
    if not os.path.exists(path):
        pytest.skip("reference fixture unavailable")
    d = Decompressor(path)
    yield d
    d.close()


def test_params(toy_archive):
    p = toy_archive.get_params()
    assert p == {
        "kmer_length": 31,
        "min_match_len": 20,
        "pack_cardinality": 50,
        "segment_size": 60000,
    }


def test_listings(toy_archive):
    assert toy_archive.list_samples() == ["a", "b", "c", "ref"]
    assert toy_archive.get_reference_sample() == "ref"
    assert toy_archive.list_contigs("ref") == ["chr1", "chr2", "chr3", "seq"]
    assert toy_archive.list_contigs("b") == ["chr1", "g h i 21", "c", "t"]


@pytest.mark.parametrize("sample", ["ref", "a", "b", "c"])
def test_byte_identical_getset(toy_archive, toy_dir, tmp_path, sample):
    out = str(tmp_path / f"{sample}.fa")
    toy_archive.get_sample_file(out, [sample], line_length=80)
    assert filecmp.cmp(out, os.path.join(toy_dir, f"{sample}.fa"), shallow=False)


def test_getcol(toy_archive, toy_dir, tmp_path):
    toy_archive.get_collection_files(str(tmp_path), line_length=80)
    for sample in ["ref", "a", "b", "c"]:
        assert filecmp.cmp(
            str(tmp_path / f"{sample}.fa"),
            os.path.join(toy_dir, f"{sample}.fa"),
            shallow=False,
        )


def test_contig_query_grammar():
    q = analyze_contig_query("chr1@ref:100-200")
    assert (q.name, q.sample, q.from_, q.to) == ("chr1", "ref", 100, 200)
    q = analyze_contig_query("chr1@ref")
    assert (q.name, q.sample, q.from_, q.to) == ("chr1", "ref", -1, -1)
    q = analyze_contig_query("chr1:5-10")
    assert (q.name, q.sample, q.from_, q.to) == ("chr1", "", 5, 10)
    q = analyze_contig_query("chr1")
    assert (q.name, q.sample, q.from_, q.to) == ("chr1", "", -1, -1)


def test_getctg_range(toy_archive):
    full = toy_archive.get_contig_seq("ref", "chr1")
    sub = toy_archive.get_contig_seq("ref", "chr1", 10, 50)
    assert sub == full[10:51]  # range is inclusive (reference: lib.cpp:273-277)
    assert toy_archive.get_contig_length("ref", "chr1") == len(full)


def test_contig_without_sample(toy_archive):
    # 'seq' exists only in ref -> resolvable without sample name
    seq = toy_archive.get_contig_seq("", "seq")
    assert seq is not None and len(seq) > 0
    # 'chr1' is ambiguous (ref and b)
    assert toy_archive.get_contig_seq("", "chr1") is None


def test_api_facade(toy_archive_path):
    with AGCFile(toy_archive_path) as f:
        assert f.IsOpened()
        assert f.NSample() == 4
        assert f.NCtg("ref") == 4
        assert f.GetReferenceSample() == "ref"
        assert f.GetCtgLen("ref", "chr1") == len(f.GetCtgSeq("ref", "chr1"))
        s = f.GetCtgSeq("ref", "chr1", 0, 9)
        assert len(s) == 10


def test_py_agc_api_reference_binding_patterns(toy_dir):
    """Call shapes from the reference's own py_agc_test.py: Open returns
    False on failure (never raises), GetCtgSeq supports BOTH overloads
    ((sample, name, start, end) and ("ctg@sample", start, end)), and the
    '@' split is greedy (last '@' separates contig from sample, matching
    the reference's '(.+)@(.+)' regex)."""
    from agc_tpu import py_agc_api

    agc = py_agc_api.CAGCFile()
    assert agc.Open("/nonexistent/path.agc") is False
    path = os.path.join(toy_dir, "toy_ex.agc")
    if not os.path.exists(path):
        pytest.skip("reference fixture unavailable")
    assert agc.Open(path, True)

    samples = py_agc_api.StringVector()
    agc.ListSample(samples)
    assert len(samples) == agc.NSample() > 0
    s = sorted(samples)[0]
    ctgs = py_agc_api.StringVector()
    agc.ListCtg(s, ctgs)
    c = ctgs[0]

    four = agc.GetCtgSeq(s, c, 0, 5)          # reference 4-arg overload
    combo = agc.GetCtgSeq(f"{c}@{s}", 0, 5)   # "ctg@sample" form
    assert four == combo and len(four) == 6
    assert agc.GetCtgLen(s, c) == agc.GetCtgLen(f"{c}@{s}")
    agc.Close()
