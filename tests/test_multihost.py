"""Multi-host corpus driver tests (single process, 8-device CPU mesh)."""

import os

import numpy as np
import pytest

from vbz_compression_tpu import CompressionOptions, api
from vbz_compression_tpu.parallel import multihost

TEST_DATA = "/root/reference/test_data"


def test_compress_signals_matches_api():
    """The mesh plane must produce byte-identical sized streams vs the
    single-chunk api path, across several length buckets."""
    rng = np.random.default_rng(0)
    signals = [rng.integers(-3000, 3000, n, dtype=np.int16)
               for n in (5000, 12_000, 130_000, 7)]
    opts = CompressionOptions(True, 2, 1, 0)
    streams = multihost.compress_signals(signals, opts)
    assert len(streams) == len(signals)
    for sig, stream in zip(signals, streams):
        ref = api.vbz_compress_sized(sig, opts)
        assert stream == ref
        out = api.vbz_decompress_sized(stream, opts)
        np.testing.assert_array_equal(np.frombuffer(out, np.int16), sig)


@pytest.mark.parametrize("isz,zigzag,level,version", [
    (1, True, 1, 0), (1, False, 0, 0), (4, True, 1, 0), (4, False, 0, 0),
    (2, False, 1, 0), (1, True, 0, 1), (1, False, 1, 1)])
def test_compress_signals_flavors(isz, zigzag, level, version):
    """Every flavor of the lattice through the corpus driver, byte-identical
    to the single-chunk api path, in input order."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[isz]
    rng = np.random.default_rng(isz + 2 * version)
    info = np.iinfo(dtype)
    signals = [rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
               for n in (3, 4096, 9000, 5000)]
    opts = CompressionOptions(zigzag, isz, level, version)
    streams = multihost.compress_signals(signals, opts)
    assert streams == [api.vbz_compress_sized(s, opts) for s in signals]


@pytest.mark.parametrize("ndev", [1, 2])
def test_compress_signals_splits_calls(monkeypatch, ndev):
    """A bucket whose streams pass the per-call budget runs as several
    device calls of whole device-count multiples, with the same frames in
    input order."""
    import jax

    from vbz_compression_tpu.ops import jax_svb
    from vbz_compression_tpu.parallel import sharded

    rng = np.random.default_rng(ndev)
    signals = [rng.integers(-3000, 3000, n, dtype=np.int16)
               for n in (5000, 6000, 9, 7000, 8000, 4096, 40_000)]
    opts = CompressionOptions(True, 2, 1, 0)
    rows = []
    encode = sharded.batch_encode_sharded

    def spy(x, lengths, **kw):
        rows.append(x.shape[0])
        return encode(x, lengths, **kw)

    # Room for three rows of the 8192 bucket per call.
    monkeypatch.setattr(multihost, "_CALL_STREAM_BYTES",
                        3 * jax_svb.stream_capacity(8192, 2, True, 0))
    monkeypatch.setattr(sharded, "batch_encode_sharded", spy)
    streams = multihost.compress_signals(
        signals, opts, mesh=sharded.make_mesh(jax.devices()[:ndev]))
    assert streams == [api.vbz_compress_sized(s, opts) for s in signals]
    # Buckets in order of first use: 8192 (4 reads, 3 rows per call on one
    # device, 2 on two), 4096 (2 reads, one call), 65536 (over budget: one
    # row per device).
    assert rows == {1: [3, 1, 2, 1], 2: [2, 2, 2, 2]}[ndev]


def test_compress_signals_four_devices():
    """A 4-device mesh gives the same frames, in order, as one device."""
    import jax

    from vbz_compression_tpu.parallel import sharded

    rng = np.random.default_rng(1)
    signals = [np.clip(500 + np.cumsum(rng.normal(0, 12, n)), -2000,
                       2000).astype(np.int16)
               for n in (30_000, 70_000, 16_384, 5, 40_000)]
    opts = CompressionOptions(True, 2, 1, 0)
    four = multihost.compress_signals(
        signals, opts, mesh=sharded.make_mesh(jax.devices()[:4]))
    one = multihost.compress_signals(
        signals, opts, mesh=sharded.make_mesh(jax.devices()[:1]))
    assert four == one
    for sig, stream in zip(signals, four):
        assert stream == api.vbz_compress_sized(sig, opts)


@pytest.mark.skipif(not os.path.isdir(TEST_DATA),
                    reason="reference test_data not mounted")
@pytest.mark.slow
def test_compress_corpus(tmp_path):
    stats = multihost.compress_corpus(
        [os.path.join(TEST_DATA, "multi_fast5_zip.fast5")],
        out_dir=str(tmp_path))
    assert stats.files == 1
    assert stats.reads == 10
    assert stats.raw_bytes == 3_097_862
    # Must beat the reference's stored size (1,308,058 incl. headers).
    assert stats.compressed_bytes <= 1_308_058
    assert (tmp_path / "multi_fast5_zip.fast5.vbz").exists()


@pytest.mark.skipif(not os.path.isdir(TEST_DATA),
                    reason="reference test_data not mounted")
@pytest.mark.slow
def test_two_process_corpus(tmp_path):
    """REAL 2-process jax.distributed run: two spawned processes, each with
    its own 4-device CPU mesh, split the corpus round-robin and allgather
    global stats over the distributed backend. Every process must report
    identical global totals."""
    import json
    import shutil
    import socket
    import subprocess
    import sys

    src = os.path.join(TEST_DATA, "multi_fast5_zip.fast5")
    second = str(tmp_path / "copy.fast5")
    shutil.copyfile(src, second)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tools", "multihost_smoke.py"),
         f"localhost:{port}", "2", str(pid), str(tmp_path), src, second],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, err[-2000:]
        # Gloo logs to stdout around our line; pick the JSON one.
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))

    for o in outs:
        assert o["process_count"] == 2
        assert o["files"] == 2
        assert o["reads"] == 20
        assert o["raw_bytes"] == 2 * 3_097_862
        assert o["compressed_bytes"] <= 2 * 1_308_058
    assert outs[0]["compressed_bytes"] == outs[1]["compressed_bytes"]
    # Each process wrote its own share's output file.
    assert (tmp_path / "multi_fast5_zip.fast5.vbz").exists()
    assert (tmp_path / "copy.fast5.vbz").exists()
