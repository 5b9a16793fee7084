"""Corruption soak matrix: {python, capi} x {zstd, tpu-rans} readers.

Creates one archive per profile, then throws N randomized corruptions
(truncate / bitflip / zero-window, mixed) at each through BOTH readers.
Pass criterion: every trial either reads cleanly or fails with a clean
error (Python exception / NULL C handle) — a native crash kills this
process, which is the failing signal.

Usage: python tools/corruption_soak.py [trials_per_leg] [seed]
"""

from __future__ import annotations

import ctypes
import os
import random
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ["JAX_PLATFORMS"] = os.environ.get("AGC_TPU_SOAK_PLATFORM", "cpu")


def _corrupt(rng: random.Random, data: bytes) -> bytes:
    b = bytearray(data)
    mode = rng.randrange(3)
    if mode == 0:
        return bytes(b[: rng.randrange(1, len(b))])
    if mode == 1:
        for _ in range(rng.randrange(1, 4)):
            p = rng.randrange(len(b))
            b[p] ^= 1 << rng.randrange(8)
        return bytes(b)
    p = rng.randrange(len(b))
    ln = rng.randrange(1, 128)
    b[p : p + ln] = bytes(min(ln, len(b) - p))
    return bytes(b)


def _read_python(path: str) -> None:
    from agc_tpu.core.decompressor import Decompressor

    try:
        d = Decompressor(path)
        for s in d.list_samples():
            for c in d.list_contigs(s) or []:
                d.get_contig_seq(s, c)
        d.close()
    except Exception:
        pass  # clean failure


def _read_capi(lib, path: str) -> None:
    h = lib.agc_open(path.encode(), 1)
    if not h:
        return  # clean failure
    try:
        n = ctypes.c_int()
        lst = lib.agc_list_sample(h, ctypes.byref(n))
        if not lst:
            return
        buf = ctypes.create_string_buffer(1 << 22)
        for i in range(n.value):
            sample = ctypes.cast(lst[i], ctypes.c_char_p).value
            m = ctypes.c_int()
            ctgs = lib.agc_list_ctg(h, sample, ctypes.byref(m))
            if not ctgs:
                continue
            for j in range(m.value):
                name = ctypes.cast(ctgs[j], ctypes.c_char_p).value
                ln = lib.agc_get_ctg_len(h, sample, name)
                if 0 <= ln < (1 << 22) - 1:
                    lib.agc_get_ctg_seq(h, sample, name, -1, -1, buf)
            lib.agc_list_destroy(ctgs)
        lib.agc_list_destroy(lst)
    finally:
        lib.agc_close(h)


def main() -> int:
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260818

    import numpy as np

    from agc_tpu.core.compressor import CompressorParams, create_archive
    from agc_tpu.native import get_capi

    from util import make_collection

    lib = get_capi()
    assert lib is not None, "C API library unavailable"

    tmp = tempfile.mkdtemp(prefix="corrsoak_")
    archives = {}
    files = make_collection(
        __import__("pathlib").Path(tmp), n_samples=3, contig_lens=(9000, 4000)
    )
    for profile in ("zstd", "tpu-rans"):
        p = os.path.join(tmp, f"{profile}.agc")
        create_archive(
            p,
            [f for _, f in files],
            CompressorParams(
                segment_size=1000, kmer_length=17, profile=profile
            ),
        )
        archives[profile] = open(p, "rb").read()

    rng = random.Random(seed)
    bad = os.path.join(tmp, "bad.agc")
    done = 0
    for profile, data in archives.items():
        for reader in ("python", "capi"):
            for t in range(trials):
                with open(bad, "wb") as f:
                    f.write(_corrupt(rng, data))
                if reader == "python":
                    _read_python(bad)
                else:
                    _read_capi(lib, bad)
                done += 1
            print(f"[corrsoak] {reader} x {profile}: {trials} trials clean",
                  flush=True)
    print(f"[corrsoak] all {done} trials crash-free")
    return 0


if __name__ == "__main__":
    sys.exit(main())
