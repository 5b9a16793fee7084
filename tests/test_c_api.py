"""Native C ABI tests: the standalone C++ decompression library
(agc_tpu/native/agc_capi.cpp) must read archives produced by the Python
engine and agree with the Python Decompressor byte-for-byte.

ABI parity target: reference src/lib-cxx/agc-api.h:119-203.
"""

import ctypes
import os
import random

import pytest

from agc_tpu.core.compressor import CompressorParams, create_archive
from agc_tpu.core.decompressor import Decompressor
from agc_tpu.native import get_capi

from util import write_fa, random_seq, mutate


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("capi")
    rng = random.Random(77)
    ref = random_seq(rng, 40000)
    files = []
    p = tmp / "ref.fa"
    write_fa(p, [("chr1 extra description", ref), ("chr2", random_seq(rng, 9000))])
    files.append(str(p))
    for i in range(3):
        q = tmp / f"s{i}.fa"
        write_fa(q, [("chr1", mutate(rng, ref)), ("chr2", random_seq(rng, 7000))])
        files.append(str(q))
    out = str(tmp / "test.agc")
    params = CompressorParams()
    params.segment_size = 2000
    create_archive(out, files, params)
    return out


def test_c_api_matches_python(archive):
    lib = get_capi()
    assert lib is not None, "C API library failed to build"
    h = lib.agc_open(archive.encode(), 1)
    assert h
    try:
        d = Decompressor(archive)
        assert lib.agc_n_sample(h) == d.get_no_samples() == 4
        # reference sample
        ptr = lib.agc_reference_sample(h)
        ref_name = ctypes.string_at(ptr).decode()
        lib.agc_string_destroy(ptr)
        assert ref_name == d.get_reference_sample() == "ref"
        # sample list
        n = ctypes.c_int(0)
        arr = lib.agc_list_sample(h, ctypes.byref(n))
        got = sorted(arr[i].decode() for i in range(n.value))
        lib.agc_list_destroy(arr)
        assert got == d.list_samples()
        # contig lists + lengths + sequences per sample
        for s in d.list_samples(sorted_=False):
            assert lib.agc_n_ctg(h, s.encode()) == d.get_no_contigs(s)
            nc = ctypes.c_int(0)
            arr = lib.agc_list_ctg(h, s.encode(), ctypes.byref(nc))
            names = [arr[i].decode() for i in range(nc.value)]
            lib.agc_list_destroy(arr)
            assert names == d.list_contigs(s)
            for ctg in names:
                want = d.get_contig_seq(s, ctg)
                ln = lib.agc_get_ctg_len(h, s.encode(), ctg.encode())
                assert ln == len(want)
                buf = ctypes.create_string_buffer(ln + 1)
                m = lib.agc_get_ctg_seq(h, s.encode(), ctg.encode(), -1, -1, buf)
                assert m == ln
                assert buf.value == want
        d.close()
    finally:
        lib.agc_close(h)


def test_c_api_ranges_and_resolution(archive):
    lib = get_capi()
    assert lib is not None
    h = lib.agc_open(archive.encode(), 0)  # no prefetch path
    try:
        d = Decompressor(archive)
        want = d.get_contig_seq("s1", "chr1", 100, 199)
        buf = ctypes.create_string_buffer(256)
        m = lib.agc_get_ctg_seq(h, b"s1", b"chr1", 100, 199, buf)
        assert m == 100 and buf.value == want
        # ambiguous contig without sample -> error
        assert lib.agc_get_ctg_len(h, None, b"chr1") == -1
        # unknown names -> errors
        assert lib.agc_get_ctg_len(h, b"nope", b"chr1") == -1
        assert lib.agc_n_ctg(h, b"nope") == -1
        # full name with description resolves by short name
        ln = lib.agc_get_ctg_len(h, b"ref", b"chr1")
        assert ln == d.get_contig_length("ref", "chr1")
        d.close()
    finally:
        lib.agc_close(h)


def test_c_api_reads_reference_archive(toy_dir):
    """Cross-validation: the native library opens an archive produced by
    the reference AGC binary (toy_ex/toy_ex.agc fixture) and extracts
    byte-identical sequences."""
    toy = os.path.join(toy_dir, "toy_ex.agc")
    lib = get_capi()
    assert lib is not None
    h = lib.agc_open(toy.encode(), 1)
    assert h
    try:
        d = Decompressor(toy)
        assert lib.agc_n_sample(h) == d.get_no_samples()
        for s in d.list_samples(sorted_=False):
            for ctg in d.list_contigs(s):
                want = d.get_contig_seq(s, ctg)
                ln = lib.agc_get_ctg_len(h, s.encode(), ctg.encode())
                assert ln == len(want)
                buf = ctypes.create_string_buffer(ln + 1)
                m = lib.agc_get_ctg_seq(h, s.encode(), ctg.encode(), -1, -1, buf)
                assert m == ln and buf.value == want
        d.close()
    finally:
        lib.agc_close(h)


def test_c_header_compiles(tmp_path):
    """The public header must be valid C (a real C client compiles)."""
    import subprocess

    from agc_tpu.native import get_capi_path

    path = get_capi_path()
    assert path is not None
    src = tmp_path / "client.c"
    src.write_text(
        '#include "agc.h"\n'
        "#include <stdlib.h>\n"
        "int main(int argc, char** argv) {\n"
        "  agc_t* h = agc_open(argv[1], 1);\n"
        "  if (!h) return 1;\n"
        "  int n = agc_n_sample(h);\n"
        "  agc_close(h);\n"
        "  return n >= 0 ? 0 : 1;\n"
        "}\n"
    )
    hdr_dir = os.path.dirname(path)
    exe = tmp_path / "client"
    res = subprocess.run(
        ["gcc", str(src), "-I", hdr_dir, "-L", hdr_dir, "-lagcnative",
         f"-Wl,-rpath,{hdr_dir}", "-o", str(exe)],
        capture_output=True,
    )
    assert res.returncode == 0, res.stderr.decode()


def test_cpp_example_compiles_and_runs(tmp_path, toy_archive_path):
    """The committed C++ example client (examples/example_agc_lib_cpp.cpp)
    builds against the native library and runs on an archive this tool
    created."""
    import subprocess

    from agc_tpu.native import get_capi_path

    path = get_capi_path()
    assert path is not None
    hdr_dir = os.path.dirname(path)
    repo = os.path.dirname(hdr_dir.rstrip(os.sep))
    example = os.path.join(os.path.dirname(repo), "examples",
                           "example_agc_lib_cpp.cpp")
    assert os.path.exists(example), example
    exe = tmp_path / "example_cpp"
    res = subprocess.run(
        ["g++", "-std=c++17", example, "-I", hdr_dir, "-L", hdr_dir,
         "-lagcnative", f"-Wl,-rpath,{hdr_dir}", "-o", str(exe)],
        capture_output=True,
    )
    assert res.returncode == 0, res.stderr.decode()
    out = subprocess.run(
        [str(exe), toy_archive_path],
        capture_output=True,
    )
    assert out.returncode == 0, out.stderr.decode()
    assert b"reference sample: ref" in out.stdout


@pytest.mark.parametrize("version", [1, 2])
def test_c_api_reads_legacy_archives(tmp_path, version):
    """The standalone C library must open 1.x/2.x archives like the
    reference's libagc (legacy collection loaders + seg-N stream names)."""
    from agc_tpu.native import get_capi

    lib = get_capi()
    if lib is None:
        pytest.skip("C API unavailable")

    from test_legacy_archives import (
        _legacy_base,
        _legacy_v1_collection,
        _legacy_v2_collection,
        _params,
    )
    from agc_tpu.core.archive import ArchiveWriter

    path = str(tmp_path / f"legacy_v{version}.agc")
    w = ArchiveWriter(path)
    _legacy_base(w, version)
    if version == 1:
        _legacy_v1_collection(w)
        _params(w, 17, 17, 50)
    else:
        _legacy_v2_collection(w)
        _params(w, 17, 17, 50, seg_size=1000)
    w.close()

    h = lib.agc_open(path.encode(), 1)
    assert h
    try:
        assert lib.agc_n_sample(h) == 1
        assert lib.agc_n_ctg(h, b"s1") == 2
        n = lib.agc_get_ctg_len(h, b"s1", b"c1")
        assert n == 40
        buf = ctypes.create_string_buffer(n + 1)
        assert lib.agc_get_ctg_seq(h, b"s1", b"c1", -1, -1, buf) == n
        assert buf.value == b"TGCA" * 10
        # c2 = ref + one V1-grammar delta member, k-overlap stitched
        n2 = lib.agc_get_ctg_len(h, b"s1", b"c2")
        buf2 = ctypes.create_string_buffer(n2 + 1)
        assert lib.agc_get_ctg_seq(h, b"s1", b"c2", -1, -1, buf2) == n2
        assert buf2.value.startswith(b"ACGT")
        assert n2 == 120 + 120 - 17
    finally:
        lib.agc_close(h)
