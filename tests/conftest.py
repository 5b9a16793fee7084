"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Device-kernel tests run on the CPU backend; multi-device sharding is
validated on virtual CPU devices. The GPU path runs as
``python chip_smoke.py`` (``--four-cards`` for the multi-card create).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# process shards and jaxdist workers run on the CPU only when asked
os.environ["AGC_TPU_WORKER_PLATFORM"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import random  # noqa: E402

import pytest  # noqa: E402

from util import mutate, random_seq, write_fa  # noqa: E402


@pytest.fixture(scope="session")
def toy_dir():
    """The reference tool's own toy_ex directory (its committed
    toy_ex.agc and FASTA files), named by AGC_REFERENCE_TOY_DIR. Tests
    that need that very archive skip without it."""
    path = os.environ.get("AGC_REFERENCE_TOY_DIR", "")
    if not os.path.exists(os.path.join(path, "toy_ex.agc")):
        pytest.skip("reference toy_ex.agc unavailable (AGC_REFERENCE_TOY_DIR)")
    return path


@pytest.fixture(scope="session")
def toy_collection(tmp_path_factory):
    """A seeded toy collection shaped like the reference's toy_ex: samples
    ref, a, b, c; the reference has contigs chr1, chr2, chr3 and seq; the
    samples carry SNPs, indels and an N-run. FASTA lines are 80 wide,
    like the tool's extraction default. Returns [(sample, path)]."""
    tmp = tmp_path_factory.mktemp("toy")
    rng = random.Random(2024)
    ref = [("chr1", random_seq(rng, 30000)), ("chr2", random_seq(rng, 12000)),
           ("chr3", random_seq(rng, 5000)), ("seq", random_seq(rng, 900))]
    files = [("ref", str(tmp / "ref.fa"))]
    write_fa(files[0][1], ref, line=80)
    for name in ("a", "b", "c"):
        contigs = [(c, mutate(rng, s, 60, 6)) for c, s in ref[:3]]
        seq = contigs[0][1]
        contigs[0] = ("chr1", seq[:7000] + "N" * 250 + seq[7250:])
        path = str(tmp / f"{name}.fa")
        write_fa(path, contigs, line=80)
        files.append((name, path))
    return files


@pytest.fixture(scope="session")
def toy_archive_path(toy_collection, tmp_path_factory):
    """The toy collection compressed by this tool with default params."""
    from agc_tpu.core.compressor import CompressorParams, create_archive

    out = str(tmp_path_factory.mktemp("toy_agc") / "toy.agc")
    create_archive(out, [p for _, p in toy_collection], CompressorParams())
    return out
