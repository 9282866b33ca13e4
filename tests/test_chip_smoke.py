"""chip_smoke.py: refuses to run off the GPU, and its phases at tiny sizes on
the CPU test mesh (the device backend passed in explicitly)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from vbz_compression_tpu.models.codec import device_backend  # noqa: E402
from vbz_compression_tpu.utils import workloads  # noqa: E402


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    p = _run(REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "not a GPU" in p.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.fixture(scope="module")
def reads():
    # Every bucket from 4096 to 32768 values.
    return workloads.pseudo_reads(150_000, seed=3, min_len=300,
                                  max_len=20_000)


def test_select_per_bucket(reads):
    picked = chip_smoke.select_per_bucket(reads, per_bucket=2)
    buckets = [chip_smoke.codec.bucket_size(reads[i].size) for i in picked]
    assert sorted(set(buckets)) == [4096, 8192, 16384, 32768]
    assert all(buckets.count(b) <= 2 for b in buckets)


def test_phase_backend_refuses_cpu():
    # Off the GPU the default backend is a host codec, which phase 2 rejects.
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_backend()


def test_phases_main_path_and_corpus(reads, capsys):
    streams = chip_smoke.phase_main_path(reads, device_backend, "test card",
                                         min_checked=8)
    assert len(streams) == len(reads)
    chip_smoke.phase_corpus(reads, streams, device_backend)
    out = capsys.readouterr().out
    assert "byte-identical to the oracle" in out
    assert "in order" in out


def test_phase_main_path_detects_a_wrong_stream(reads, monkeypatch):
    real = device_backend.svb_compress_batch

    def corrupt(arrays, *a):
        out = real(arrays, *a)
        return [out[0][:-1] + bytes([out[0][-1] ^ 1])] + out[1:]

    monkeypatch.setattr(device_backend, "svb_compress_batch", corrupt)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_main_path(reads, device_backend, "test card",
                                   min_checked=8)


def test_phase_lattice(capsys):
    chip_smoke.phase_lattice(device_backend, 50_000, seed=1)
    out = capsys.readouterr().out
    assert out.count("byte-identical to the oracle") == len(chip_smoke.FLAVORS)


def test_phase_memory(capsys):
    chip_smoke.phase_memory(4096)
    assert "peak_bytes_in_use" in capsys.readouterr().out


def test_phase_wide_batch(reads, capsys):
    big = [r for r in reads if r.size > 16384]
    chip_smoke.phase_wide_batch(big, min_stream_bytes=200_000)
    out = capsys.readouterr().out
    assert "every row equals its one-row encode" in out
    assert f"[{-(-200_000 // 73728)}, 32768]" in out


def test_four_cards_on_virtual_devices(reads, capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.four_cards(reads[:6])
    out = capsys.readouterr().out
    assert "frames identical on 4 cards and 1" in out


def test_lattice_input_width():
    n = 1000
    x = np.concatenate([workloads.content(t, n, k, np.int8)
                        for k, t in enumerate(chip_smoke.TIERS)])
    assert x.dtype == np.int8 and x.size == 5 * n
