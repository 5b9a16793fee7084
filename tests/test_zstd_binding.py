"""The zstd binding (libzstd's C API through ctypes) against frames
written by the ``zstandard`` package, the archive writer's earlier zstd
binding.

``data/zstd_golden.npz`` holds two payloads (2-bit DNA codes with a
repeat, and collection-style metadata) and their frames from
``zstandard.ZstdCompressor(level=L).compress`` (zstandard 0.25.0,
bundled zstd 1.5.7) at the levels the format uses. Archives written by
that binding must read back exactly, and the binding must write frames
of the same kind: content size recorded, no checksum, no dictionary id.
The compressed bytes themselves follow the installed libzstd's version,
as they followed the bundled zstd's before.
"""

import os

import numpy as np
import pytest

from agc_tpu.core.segment import part_compress, zstd_decompress_tolerant
from agc_tpu.native import zstd

GOLDEN = np.load(
    os.path.join(os.path.dirname(__file__), "data", "zstd_golden.npz"),
    allow_pickle=False,
)
CASES = [(name, level) for name in ("dna", "meta") for level in (13, 15, 17, 19)]


def _frame_kind(frame: bytes) -> tuple:
    """(magic, frame-header descriptor, recorded content size)."""
    lib = zstd._load()
    return frame[:4], frame[4], lib.ZSTD_getFrameContentSize(frame, len(frame))


@pytest.mark.parametrize("name,level", CASES)
def test_golden_frame_reads_back(name, level):
    payload = GOLDEN[f"payload_{name}"].tobytes()
    frame = GOLDEN[f"frame_{name}_{level}"].tobytes()
    assert zstd.decompress(frame) == payload
    # stored parts carry a marker byte after the frame
    assert zstd_decompress_tolerant(frame + b"\x00") == payload


@pytest.mark.parametrize("name,level", CASES)
def test_binding_writes_the_same_kind_of_frame(name, level):
    payload = GOLDEN[f"payload_{name}"].tobytes()
    golden = GOLDEN[f"frame_{name}_{level}"].tobytes()
    ours = part_compress(payload, level)
    assert _frame_kind(ours) == _frame_kind(golden)
    assert _frame_kind(ours)[2] == len(payload)
    assert zstd.decompress(ours) == payload


def test_corrupt_and_truncated_frames_raise():
    frame = GOLDEN["frame_dna_19"].tobytes()
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[: len(frame) // 2])
    bad = bytearray(frame)
    bad[:4] = b"\x00\x00\x00\x00"
    with pytest.raises(ValueError):
        zstd.decompress(bytes(bad))
