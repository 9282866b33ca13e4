"""Bulk batch API: vbz_compress_sized_batch / vbz_decompress_sized_batch
must agree byte-for-byte with the per-chunk pipeline for every backend and
option combination (BASELINE config: bulk multi-read batch)."""

import os
import subprocess

import numpy as np
import pytest

from vbz_compression_tpu import api
from vbz_compression_tpu.options import CompressionOptions


def _chunks(dtype, k=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n = int(rng.integers(1, 30_000))
        if np.dtype(dtype).kind == "i":
            info = np.iinfo(dtype)
            sig = np.clip(np.cumsum(rng.normal(0, max(info.max // 300, 2), n)),
                          info.min, info.max).astype(dtype)
        else:
            sig = rng.integers(0, np.iinfo(dtype).max, n).astype(dtype)
        out.append(sig)
    out.append(np.zeros(0, dtype))  # empty chunk edge case
    return out


NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def backends():
    subprocess.run(["make", "-C", NATIVE, "-s", "libvbz_native.so"],
                   check=True)
    return {name: api._backend_by_name(name)
            for name in ("scalar", "device", "native")}


@pytest.mark.parametrize("backend_name", ["scalar", "device", "native"])
@pytest.mark.parametrize("dtype,int_size,zigzag", [
    (np.int16, 2, True), (np.uint32, 4, False), (np.int8, 1, True),
])
@pytest.mark.parametrize("level,version", [(0, 0), (1, 0), (1, 1)])
def test_batch_matches_per_chunk(backends, backend_name, dtype, int_size,
                                 zigzag, level, version):
    backend = backends[backend_name]
    opts = CompressionOptions(zigzag, int_size, level, version)
    chunks = _chunks(dtype, k=3)
    batch = api.vbz_compress_sized_batch(chunks, opts, backend=backend)
    single = [api.vbz_compress_sized(c, opts, backend=backend)
              for c in chunks]
    assert batch == single
    back = api.vbz_decompress_sized_batch(batch, opts, backend=backend)
    for c, b in zip(chunks, back):
        assert np.array_equal(np.frombuffer(b, dtype), c)


def test_batch_no_svb_stage():
    # integer_size=0: raw copy (+ optional zstd) with sized header.
    opts = CompressionOptions(False, 0, 1, 0)
    chunks = [np.arange(100, dtype=np.int16), np.zeros(0, np.int16)]
    batch = api.vbz_compress_sized_batch(chunks, opts)
    single = [api.vbz_compress_sized(c, opts) for c in chunks]
    assert batch == single
    back = api.vbz_decompress_sized_batch(batch, opts)
    for c, b in zip(chunks, back):
        assert np.array_equal(np.frombuffer(b, np.int16), c)
