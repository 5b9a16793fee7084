"""Reading legacy (format 1.x / 2.x) archives.

No reference binary is available to produce genuine legacy fixtures, so
these tests hand-craft minimal v1/v2 archives following the reference
serializers (collection_v1.cpp:14-66, collection_v2.cpp:14-93,
lz_diff.cpp:443-474) and verify our readers decode them.
"""

import numpy as np
import pytest

from agc_tpu.core.archive import ArchiveWriter
from agc_tpu.core.codecs import (
    enc_prefix_varint,
    zigzag_encode,
    zigzag_encode_pred,
)
from agc_tpu.core.decompressor import Decompressor
from agc_tpu.native import zstd


def _append_str(buf: bytearray, s: str) -> None:
    buf.extend(s.encode() + b"\x00")


def _file_type_info(w: ArchiveWriter, major: int, minor: int) -> None:
    info = {
        "producer": "agc",
        "producer_version_major": str(major),
        "producer_version_minor": str(minor),
        "file_version_major": str(major),
        "file_version_minor": str(minor),
    }
    v = bytearray()
    for k in sorted(info):
        _append_str(v, k)
        _append_str(v, info[k])
    w.add_part("file_type_info", bytes(v), len(info))


def _params(w: ArchiveWriter, k, mml, pack, seg_size=None) -> None:
    import struct

    v = struct.pack("<III", k, mml, pack)
    if seg_size is not None:
        v += struct.pack("<I", seg_size)
    w.add_part("params", v, 0)


def _zstd(data: bytes, level=19) -> bytes:
    return zstd.compress(data, level)


# numeric sequences (A=0 C=1 G=2 T=3)
REF_SEQ = bytes([0, 1, 2, 3] * 30)  # 120 bases
# V1 delta grammar: literals 'A'+c, match "dif,len-mml.", N-run 0x1E..0x04
# member: first 2 bases substituted, then match covering the rest
DELTA_V1 = b"BB" + b"0," + str(118 - 17).encode() + b"."
MEMBER_SEQ = bytes([1, 1]) + REF_SEQ[2:]
RAW_SEQ = bytes([3, 2, 1, 0] * 10)


def _seg_streams(w: ArchiveWriter, version_prefix_legacy=True):
    """Group 16 = LZ group (ref + 1 delta member), raw group 2 = one raw."""
    # ref part: zstd + marker 0 (plain), metadata = raw size
    w.add_part("seg-16-ref", _zstd(REF_SEQ) + b"\x00", len(REF_SEQ))
    pack = DELTA_V1 + b"\xff"
    w.add_part("seg-16-delta", _zstd(pack, 17) + b"\x00", len(pack))
    rawpack = RAW_SEQ + b"\xff"
    w.add_part("seg-2-delta", _zstd(rawpack, 17) + b"\x00", len(rawpack))


def _v1_collection_blob() -> bytes:
    data = bytearray()
    enc_prefix_varint(data, 1)  # samples
    _append_str(data, "s1")
    enc_prefix_varint(data, 2)  # contigs
    # contig c1: 1 segment in raw group 2 (id 0)
    _append_str(data, "c1")
    enc_prefix_varint(data, 1)
    for val, prev in ((2, 0), (0, 0), (len(RAW_SEQ), 0)):
        enc_prefix_varint(data, zigzag_encode(val - prev))
    enc_prefix_varint(data, 0)  # orientation
    # contig c2: 2 segments in group 16 (ids 0 and 1)
    _append_str(data, "c2")
    enc_prefix_varint(data, 2)
    pg = pig = prl = 0
    for g, ig, rl, rc in ((16, 0, len(REF_SEQ), 0), (16, 1, len(MEMBER_SEQ), 0)):
        enc_prefix_varint(data, zigzag_encode(g - pg))
        enc_prefix_varint(data, zigzag_encode(ig - pig))
        enc_prefix_varint(data, zigzag_encode(rl - prl))
        enc_prefix_varint(data, rc)
        pg, pig, prl = g, ig, rl
    enc_prefix_varint(data, 1)  # cmd lines
    _append_str(data, "agc create ...")
    _append_str(data, "some day")
    return bytes(data)


def test_read_v1_archive(tmp_path):
    path = str(tmp_path / "v1.agc")
    w = ArchiveWriter(path)
    _file_type_info(w, 1, 0)
    _seg_streams(w)
    w.add_part("collection-desc", _zstd(_v1_collection_blob()), len(_v1_collection_blob()))
    _params(w, 17, 17, 50)  # v1: no segment_size
    w.close()

    d = Decompressor(path)
    assert d.archive_version == 1000
    assert d.list_samples() == ["s1"]
    assert d.list_contigs("s1") == ["c1", "c2"]
    assert d.get_contig_seq("s1", "c1") == b"TGCA" * 10
    # c2 = segment(ref) + segment(member) stitched with k=17 overlap
    full = np.frombuffer(REF_SEQ, np.uint8)
    mem = np.frombuffer(MEMBER_SEQ, np.uint8)
    expect = np.concatenate([full, mem[17:]])
    got = d.get_contig_seq("s1", "c2")
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    assert got == alpha[expect].tobytes()
    d.close()


def _v2_collection(w: ArchiveWriter):
    main = bytearray()
    enc_prefix_varint(main, 10)  # details_batch_size
    enc_prefix_varint(main, 1)  # samples
    _append_str(main, "s1")
    enc_prefix_varint(main, 2)
    _append_str(main, "c1")
    enc_prefix_varint(main, 1)
    _append_str(main, "c2")
    enc_prefix_varint(main, 2)
    enc_prefix_varint(main, 0)  # cmd lines
    w.add_part("collection-main", _zstd(bytes(main)), len(main))

    det = bytearray()
    # substream 0: group ids (zigzag-vs-pred per contig)
    for contig in ([2], [16, 16]):
        prev = 0
        for g in contig:
            enc_prefix_varint(det, zigzag_encode_pred(g, prev))
            prev = g
    # substream 1: in-group ids
    for contig in ([0], [0, 1]):
        prev = 0
        for ig in contig:
            enc_prefix_varint(det, zigzag_encode_pred(ig, prev))
            prev = ig
    # substream 2: raw lengths
    for contig in ([len(RAW_SEQ)], [len(REF_SEQ), len(MEMBER_SEQ)]):
        prev = 0
        for rl in contig:
            enc_prefix_varint(det, zigzag_encode_pred(rl, prev))
            prev = rl
    # substream 3: orientations
    for contig in ([0], [0, 0]):
        for o in contig:
            enc_prefix_varint(det, o)
    w.add_part("collection-details", _zstd(bytes(det)), len(det))


def test_read_v2_archive(tmp_path):
    path = str(tmp_path / "v2.agc")
    w = ArchiveWriter(path)
    _file_type_info(w, 2, 0)
    _seg_streams(w)
    _v2_collection(w)
    _params(w, 17, 17, 50, seg_size=1000)
    w.close()

    d = Decompressor(path)
    assert d.archive_version == 2000
    assert d.list_samples() == ["s1"]
    assert d.get_contig_seq("s1", "c1") == b"TGCA" * 10
    full = np.frombuffer(REF_SEQ, np.uint8)
    mem = np.frombuffer(MEMBER_SEQ, np.uint8)
    expect = np.concatenate([full, mem[17:]])
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    assert d.get_contig_seq("s1", "c2") == alpha[expect].tobytes()
    d.close()


# ---------------------------------------------------------------------------
# appending to legacy archives (reference: Append works on 1.x/2.x inputs
# and re-serializes the collection in the original format at close;
# store_metadata_impl_v1/v2, agc_compressor.cpp:81-168)
# ---------------------------------------------------------------------------


def _legacy_base(w: ArchiveWriter, version: int) -> None:
    """Contiguous-stream legacy archive like real old creates: raw groups
    0..15 (dummy first member, reference: agc_compressor.cpp:2313-2321),
    LZ group 16, sample s1 with contigs c1 (raw, id 1 in group 2) and c2
    (ref + one V1 delta member in group 16)."""
    _file_type_info(w, version, 0)
    for g in range(16):
        if g == 2:
            pack = b"\x7f\xff" + RAW_SEQ + b"\xff"
        else:
            pack = b"\x7f\xff"
        w.add_part(f"seg-{g}-delta", _zstd(pack, 17) + b"\x00", len(pack))
    w.add_part("seg-16-ref", _zstd(REF_SEQ) + b"\x00", len(REF_SEQ))
    pack = DELTA_V1 + b"\xff"
    w.add_part("seg-16-delta", _zstd(pack, 17) + b"\x00", len(pack))
    # splitter metadata (arbitrary pair values; required by append init)
    import struct

    w.add_part("splitters", struct.pack("<QQ", 5, 9), 2)
    emp = (1 << 64) - 1
    seg_spl = struct.pack("<QQI", emp, emp, 0) + struct.pack("<QQI", 5, 9, 16)
    w.add_part("segment-splitters", seg_spl, 2)


def _legacy_v1_collection(w: ArchiveWriter) -> None:
    data = bytearray()
    enc_prefix_varint(data, 1)
    _append_str(data, "s1")
    enc_prefix_varint(data, 2)
    _append_str(data, "c1")
    enc_prefix_varint(data, 1)
    for v in (zigzag_encode(2), zigzag_encode(1), zigzag_encode(len(RAW_SEQ)), 0):
        enc_prefix_varint(data, v)
    _append_str(data, "c2")
    enc_prefix_varint(data, 2)
    pg = pig = prl = 0
    for g, ig, rl in ((16, 0, len(REF_SEQ)), (16, 1, len(MEMBER_SEQ))):
        enc_prefix_varint(data, zigzag_encode(g - pg))
        enc_prefix_varint(data, zigzag_encode(ig - pig))
        enc_prefix_varint(data, zigzag_encode(rl - prl))
        enc_prefix_varint(data, 0)
        pg, pig, prl = g, ig, rl
    enc_prefix_varint(data, 1)
    _append_str(data, "agc create old")
    _append_str(data, "")
    w.add_part("collection-desc", _zstd(bytes(data)), len(data))


def _legacy_v2_collection(w: ArchiveWriter) -> None:
    main = bytearray()
    enc_prefix_varint(main, 10)
    enc_prefix_varint(main, 1)
    _append_str(main, "s1")
    enc_prefix_varint(main, 2)
    _append_str(main, "c1")
    enc_prefix_varint(main, 1)
    _append_str(main, "c2")
    enc_prefix_varint(main, 2)
    enc_prefix_varint(main, 0)
    w.add_part("collection-main", _zstd(bytes(main)), len(main))
    det = bytearray()
    for contig in ([2], [16, 16]):
        prev = 0
        for g in contig:
            enc_prefix_varint(det, zigzag_encode_pred(g, prev))
            prev = g
    for contig in ([1], [0, 1]):
        prev = 0
        for ig in contig:
            enc_prefix_varint(det, zigzag_encode_pred(ig, prev))
            prev = ig
    for contig in ([len(RAW_SEQ)], [len(REF_SEQ), len(MEMBER_SEQ)]):
        prev = 0
        for rl in contig:
            enc_prefix_varint(det, zigzag_encode_pred(rl, prev))
            prev = rl
    for contig in ([0], [0, 0]):
        for o in contig:
            enc_prefix_varint(det, o)
    w.add_part("collection-details", _zstd(bytes(det)), len(det))


@pytest.mark.parametrize("version", [1, 2])
def test_append_to_legacy_archive(tmp_path, version):
    import random

    from agc_tpu.core.compressor import CompressorParams, append_archive
    from util import write_fa

    path = str(tmp_path / f"old_v{version}.agc")
    w = ArchiveWriter(path)
    _legacy_base(w, version)
    if version == 1:
        _legacy_v1_collection(w)
        _params(w, 17, 17, 50)
    else:
        _legacy_v2_collection(w)
        _params(w, 17, 17, 50, seg_size=1000)
    w.close()

    rng = random.Random(3)
    new_seq = "".join(rng.choice("ACGT") for _ in range(300))
    new_fa = str(tmp_path / "s2.fa")
    write_fa(new_fa, [("n1", new_seq)])

    out = str(tmp_path / f"new_v{version}.agc")
    append_archive(path, out, [new_fa], CompressorParams())

    d = Decompressor(out)
    assert d.archive_version == version * 1000
    assert d.list_samples() == ["s1", "s2"]
    # old contigs still extract
    assert d.get_contig_seq("s1", "c1") == b"TGCA" * 10
    full = np.frombuffer(REF_SEQ, np.uint8)
    mem = np.frombuffer(MEMBER_SEQ, np.uint8)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    assert d.get_contig_seq("s1", "c2") == alpha[
        np.concatenate([full, mem[17:]])
    ].tobytes()
    # new sample round-trips
    assert d.get_contig_seq("s2", "n1") == new_seq.encode()
    d.close()

    # cross-tool: the reference binary (3.2.2 reads every format version)
    # must extract our legacy-format append output, old and new samples
    import os
    import subprocess

    ref_bin = os.environ.get("AGC_REF_BIN", "/tmp/refbuild/bin/agc")
    if os.path.exists(ref_bin):
        env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0")
        r = subprocess.run(
            [ref_bin, "getctg", out, "n1@s2"],
            check=True, capture_output=True, env=env,
        )
        got = b"".join(r.stdout.split(b"\n")[1:]).decode()
        assert got == new_seq
        r = subprocess.run(
            [ref_bin, "getctg", out, "c1@s1"],
            check=True, capture_output=True, env=env,
        )
        got = b"".join(r.stdout.split(b"\n")[1:])
        assert got == b"TGCA" * 10


def test_v1_grammar_encoder_roundtrip():
    """V1 token grammar: plain literals only (no '!') and matches always
    carry ',len'; decode_v1 must replay it exactly."""
    import random

    import numpy as np

    from agc_tpu.core.lz import LZDiff, decode_v1

    rng = np.random.default_rng(21)
    ref = rng.integers(0, 4, size=4000, dtype=np.uint8)
    text = ref.copy()
    text[100] = (text[100] + 1) % 4
    text[2000:2030] = 4  # N-run
    lz = LZDiff(17, v1_grammar=True)
    lz.prepare(ref.tobytes())
    enc = lz.encode(text.tobytes())
    assert b"!" not in enc
    assert decode_v1(ref.tobytes(), enc, 17) == text.tobytes()
    # identical member -> empty encoding (IMPROVED_LZ_ENCODING, both V1/V2)
    assert lz.encode(ref.tobytes()) == b""


def test_legacy_append_preserves_and_adds_cmd_lines(tmp_path):
    """Appending to a v1 archive keeps the original command-line history
    and records the new run (reference: AddCmdLine + CCollection_V1
    serialization; v3 archives drop cmd lines like the reference)."""
    import random

    from agc_tpu.core.compressor import CompressorParams, append_archive
    from util import write_fa

    path = str(tmp_path / "old.agc")
    w = ArchiveWriter(path)
    _legacy_base(w, 1)
    _legacy_v1_collection(w)
    _params(w, 17, 17, 50)
    w.close()

    rng = random.Random(4)
    new_fa = str(tmp_path / "s2.fa")
    write_fa(new_fa, [("n1", "".join(rng.choice("ACGT") for _ in range(200)))])
    out = str(tmp_path / "new.agc")
    append_archive(path, out, [new_fa], CompressorParams(),
                   cmd_line="agc-tpu append old.agc s2.fa")

    d = Decompressor(out)
    cmds = [c for c, _ in d.collection.cmd_lines]
    assert cmds == ["agc create old", "agc-tpu append old.agc s2.fa"]
    d.close()
