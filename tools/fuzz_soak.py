"""Long-running fuzz soak: randomized round-trip + cross-tool trials.

Re-uses the test-suite fuzz bodies (tests/test_fuzz_roundtrip.py,
tests/test_cross_tool.py) with FRESH seeds, for idle-CPU soak runs far
past the suite's fixed seed list. Any failing seed is printed — add it
to the suite's parametrize list to pin the regression.

Usage: python tools/fuzz_soak.py [n_trials] [start_seed]
"""

from __future__ import annotations

import os
import pathlib
import random
import sys
import tempfile
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
# soak runs are idle-CPU work: the CPU backend unless
# AGC_TPU_SOAK_PLATFORM names another
os.environ["JAX_PLATFORMS"] = os.environ.get("AGC_TPU_SOAK_PLATFORM", "cpu")


def main() -> int:
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    start = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000

    import test_fuzz_roundtrip as tfr

    try:
        import test_cross_tool as tct

        have_ref = os.path.exists(tct.REF_BIN)
    except Exception:
        have_ref = False

    failures = []
    for t in range(n_trials):
        seed = start + t
        with tempfile.TemporaryDirectory(prefix="soak_") as tmp:
            tmp_path = pathlib.Path(tmp)
            try:
                tfr.test_fuzz_roundtrip(tmp_path, seed)
            except Exception:
                failures.append(("roundtrip", seed))
                traceback.print_exc()
            if have_ref and t % 5 == 0:
                # cross-tool randomized trial with this seed's params
                try:
                    sub = tmp_path / "xt"
                    sub.mkdir()
                    _cross_trial(sub, seed)
                except Exception as e:
                    # the ASAN-instrumented reference binary has its own
                    # crashes on valid input (heap overflow in
                    # refresh::matching_length via GetCodingCostVector,
                    # seen at small -s with the missing-middle search;
                    # seed 200145 reproduces) — count those separately,
                    # they are upstream bugs, not ours
                    import subprocess as _sp

                    if isinstance(e, _sp.CalledProcessError) and (
                        b"AddressSanitizer" in (e.stderr or b"")
                    ):
                        print(f"[soak] reference-binary ASAN crash at seed "
                              f"{seed} (upstream bug, skipped)", flush=True)
                    else:
                        failures.append(("cross_tool", seed))
                        traceback.print_exc()
        if (t + 1) % 10 == 0:
            print(f"[soak] {t + 1}/{n_trials} trials, {len(failures)} failures",
                  flush=True)
    if failures:
        print(f"[soak] FAILURES: {failures}")
        return 1
    print(f"[soak] all {n_trials} trials clean")
    return 0


def _cross_trial(tmp_path, seed: int) -> None:
    import test_cross_tool as tct
    from agc_tpu.core.compressor import CompressorParams, create_archive

    from util import mutate, random_seq, write_fa

    rng = random.Random(seed)
    k = rng.choice([17, 21, 25, 31])
    s = rng.choice([500, 1500, 4000])
    l = rng.choice([15, 18, 20])
    b = rng.choice([1, 3, 10])
    adaptive = rng.random() < 0.4
    # AGC_TPU_SOAK_SCALE grows contigs (e.g. 30 -> 90-360 kb) to stress
    # the multi-chunk scan paths in cross-tool trials
    scale = int(os.environ.get("AGC_TPU_SOAK_SCALE", "1"))
    base = [random_seq(rng, scale * rng.randrange(3000, 12000))
            for _ in range(rng.randrange(1, 3))]
    files = []
    for name in ["ref", "s0", "s1"]:
        if name == "ref":
            contigs = [(f"c{i + 1}", x) for i, x in enumerate(base)]
        else:
            contigs = [(f"c{i + 1}", mutate(rng, x, 40, 6))
                       for i, x in enumerate(base)]
        p = str(tmp_path / f"{name}.fa")
        write_fa(p, contigs, line=80)
        files.append((name, p))

    ours = str(tmp_path / "ours.agc")
    create_archive(
        ours, [p for _, p in files],
        CompressorParams(kmer_length=k, segment_size=s, min_match_len=l,
                         pack_cardinality=b, adaptive_compression=adaptive),
    )
    tct._ref_extract_compare(ours, files, tmp_path, f"soak{seed}")

    theirs = str(tmp_path / "theirs.agc")
    flags = ["-k", str(k), "-s", str(s), "-l", str(l), "-b", str(b)]
    if adaptive:
        flags.append("-a")
    tct._ref("create", *flags, "-o", theirs, *[p for _, p in files])
    tct._our_extract_compare(theirs, files, tmp_path, f"soak{seed}")


if __name__ == "__main__":
    sys.exit(main())
