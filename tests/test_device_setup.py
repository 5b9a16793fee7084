"""Device setup that runs without a card: the compile-cache placement,
the binding of worker processes to GPUs, and the refusal of chip_smoke.py
and bench.py to report a CPU run as a device result."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    (the package sets no directory); without it, the cache is the fixed
    <checkout>/.jax_cache."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} if env_set else {}
    code = (
        "import jax, agc_tpu.ops\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(**extra), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path / "cc") if env_set else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want


@pytest.fixture
def gpu_host(monkeypatch):
    """A parent whose JAX would run on a GPU host with four cards."""
    from agc_tpu.parallel import distributed as D

    monkeypatch.delenv("AGC_TPU_WORKER_PLATFORM", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(D, "visible_gpus", lambda: ["0", "1", "2", "3"])
    return D


def test_workers_get_one_card_each(gpu_host):
    envs = gpu_host.worker_envs(4)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    for e in envs:
        assert e["JAX_PLATFORMS"] == "cuda"
        assert e["XLA_PYTHON_CLIENT_PREALLOCATE"] == "false"
    assert len(gpu_host.worker_envs(2)) == 2


def test_more_gpu_workers_than_cards_refused(gpu_host, tmp_path):
    with pytest.raises(ValueError, match="5 GPU workers requested but 4"):
        gpu_host.worker_envs(5)
    # the sharded create refuses before doing any work
    with pytest.raises(ValueError, match="each worker process needs a card"):
        gpu_host.create_archive_sharded(
            str(tmp_path / "x.agc"), [str(tmp_path / "missing.fa")],
            n_shards=5, worker="process",
        )


def test_cpu_workers_only_when_asked(gpu_host, monkeypatch):
    monkeypatch.setenv("AGC_TPU_WORKER_PLATFORM", "cpu")
    envs = gpu_host.worker_envs(6)  # no card limit on the CPU
    assert all(e["JAX_PLATFORMS"] == "cpu" for e in envs)
    assert all("CUDA_VISIBLE_DEVICES" not in e for e in envs)
    monkeypatch.delenv("AGC_TPU_WORKER_PLATFORM")
    # a CPU-pinned parent does not make CPU workers
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert gpu_host.worker_envs(2)[0]["JAX_PLATFORMS"] == "cuda"


@pytest.mark.parametrize("setting", ["", "gpu", "cuda"])
def test_no_visible_gpu_is_refused_without_cpu_pin(gpu_host, monkeypatch,
                                                   setting):
    """No GPU visible and no explicit AGC_TPU_WORKER_PLATFORM=cpu: refused,
    never a silent fall back to CPU workers; an unknown platform is
    refused too."""
    monkeypatch.setattr(gpu_host, "visible_gpus", lambda: [])
    monkeypatch.setenv("AGC_TPU_WORKER_PLATFORM", setting)
    if setting == "cuda":
        with pytest.raises(ValueError, match="expected 'gpu' or 'cpu'"):
            gpu_host.worker_envs(1)
    else:
        with pytest.raises(ValueError, match="but 0 GPU.s. visible"):
            gpu_host.worker_envs(1)


def test_shard_results_name_their_device(tmp_path, monkeypatch, capsys):
    """Every shard reports the platform and device count of the process
    that compressed it; the sharded create prints them with its timings."""
    from util import make_collection

    from agc_tpu.parallel.distributed import create_archive_sharded

    files = [p for _s, p in make_collection(tmp_path, n_samples=2,
                                            contig_lens=(20000,))]
    monkeypatch.setenv("AGC_TPU_SHARD_TIMINGS", "1")
    create_archive_sharded(str(tmp_path / "x.agc"), files, n_shards=2)
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("AGC_TPU_SHARD_TIMINGS ")]
    got = json.loads(line[0].split(" ", 1)[1])["worker_devices"]
    assert [d[0] for d in got] == ["cpu", "cpu"]
    assert all(d[1] >= 1 for d in got)


def test_visible_gpus_follow_cuda_visible_devices(monkeypatch):
    from agc_tpu.parallel.distributed import visible_gpus

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert visible_gpus() == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert visible_gpus() == []


def _run(args, cwd, timeout):
    return subprocess.run(
        [sys.executable, *args], env=_env(), cwd=cwd, capture_output=True,
        text=True, timeout=timeout,
    )


def _has_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_is_refused_before_work(script):
    out = _run([os.path.join(REPO, script)], REPO, 300)
    assert out.returncode != 0
    assert not _has_result_line(out.stdout)
    assert "not a GPU" in out.stdout + out.stderr or "no GPU" in out.stdout


def test_chip_smoke_phases_at_tiny_size_on_cpu(tmp_path):
    """The rehearsal: every phase passes at a tiny size on the CPU, then
    the run still fails at the device check and prints no result."""
    out = _run([os.path.join(REPO, "chip_smoke.py"), "--size-mb", "1"],
               str(tmp_path), 900)
    assert out.returncode == 2, out.stdout[-3000:] + out.stderr[-3000:]
    assert not _has_result_line(out.stdout)
    for name in ("kernels", "create", "append", "extract", "c_reader",
                 "host_twins"):
        assert f"phase {name}: ok" in out.stdout, name
    assert "FAIL: phases ran on cpu, not a GPU" in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails, printing no
    result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run(
        [sys.executable, str(lone), "--size-mb", "1"], cwd=str(tmp_path),
        env=dict(_env(), PYTHONPATH=""), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert not _has_result_line(out.stdout)
