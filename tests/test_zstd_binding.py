"""The zstd stage's ctypes binding (vbz_compression_tpu/zstd.py) against
the ``zstandard`` package, where that package is installed."""

import numpy as np
import pytest

from vbz_compression_tpu import VbzError, api, zstd
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu.utils import workloads

zstandard = pytest.importorskip("zstandard")

# Frames depend on the libzstd release that writes them, at any input size:
# the system library and the one bundled in ``zstandard`` need not match.
# Where they differ, frames are held to what they decode to and to their
# size, which may move by a small fraction either way.
_SIZE_SLACK = 1.001


def _zstandard_frame(data: bytes, level: int) -> bytes:
    level = max(min(level, zstandard.MAX_COMPRESSION_LEVEL), -131072)
    if level == 1:
        params = zstandard.ZstdCompressionParameters(
            window_log=19, chain_log=14, hash_log=16, search_log=1,
            min_match=5, target_length=0, strategy=zstandard.STRATEGY_DFAST,
            write_checksum=0, write_content_size=1)
        cctx = zstandard.ZstdCompressor(compression_params=params)
    else:
        cctx = zstandard.ZstdCompressor(level=level, write_checksum=False,
                                        write_content_size=True)
    return cctx.compress(data)


def _same_library() -> bool:
    v = zstd.lib().ZSTD_versionNumber()
    return (v // 10000, v // 100 % 100, v % 100) == tuple(
        zstandard.ZSTD_VERSION)


@pytest.mark.parametrize("level", [1, 3, -5])
@pytest.mark.parametrize("tier", ["realistic", "mixed", "pure",
                                  "incompressible", "constant"])
@pytest.mark.parametrize("n", [0, 1, 5000, 50_000, 1_000_000])
def test_frames_match_zstandard(tier, n, level):
    payload = scalar.svb_compress(workloads.content(tier, n, seed=n), 2,
                                  True, 0)
    ours, theirs = zstd.compress(payload, level), _zstandard_frame(payload,
                                                                   level)
    if _same_library():
        assert ours == theirs
    assert len(ours) <= len(theirs) * _SIZE_SLACK
    assert zstandard.ZstdDecompressor().decompress(ours) == payload
    assert zstd.decompress(theirs, zstd.frame_content_size(theirs)) == \
        payload
    assert zstd.frame_content_size(ours) == len(payload)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pseudo_read_frames_match_zstandard(seed):
    """The bulk-repack reads at level 1, the main path's setting: the
    binding's frames are as small as ``zstandard``'s and decode with it."""
    reads = workloads.pseudo_reads(4 << 20, seed)
    payloads = [scalar.svb_compress(r, 2, True, 0) for r in reads]
    ours = [zstd.compress(p, 1) for p in payloads]
    theirs = [_zstandard_frame(p, 1) for p in payloads]
    if _same_library():
        assert ours == theirs
    assert sum(map(len, ours)) <= sum(map(len, theirs)) * _SIZE_SLACK
    dctx = zstandard.ZstdDecompressor()
    assert all(dctx.decompress(f) == p for f, p in zip(ours, payloads))


def test_frame_errors():
    with pytest.raises(VbzError):
        zstd.frame_content_size(b"not a zstd frame")
    frame = zstd.compress(b"x" * 1000, 1)
    with pytest.raises(VbzError):
        zstd.decompress(frame[:-3], 1000)
    with pytest.raises(VbzError):
        zstd.decompress(frame, 10)  # destination too small
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(
        b"abc" * 100)
    with pytest.raises(VbzError):
        api.zstd_frame_content_size(unsized)


def test_level_clamped():
    data = np.arange(10_000, dtype=np.int16).tobytes()
    assert zstd.compress(data, 1000) == zstd.compress(
        data, zstd.lib().ZSTD_maxCLevel())
    assert zstd.decompress(zstd.compress(data, -10**6), len(data)) == data
