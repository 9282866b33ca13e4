"""The device backend (XLA plane) against the NumPy oracle across the whole
32020 lattice: every flavor x content tier x chunk size, stream bytes equal
and round trips exact; malformed streams get the oracle's outcome."""

import numpy as np
import pytest

from vbz_compression_tpu import VbzError
from vbz_compression_tpu.models.codec import bucket_size, device_backend
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu.utils import workloads

# (name, integer_size, zigzag, version)
FLAVORS = [("zz16", 2, True, 0), ("none16", 2, False, 0),
           ("zz8", 1, True, 0), ("none8", 1, False, 0),
           ("zz32", 4, True, 0), ("none32", 4, False, 0),
           ("v1_zz8", 1, True, 1), ("v1_none8", 1, False, 1)]
TIERS = ["realistic", "mixed", "pure", "incompressible", "constant"]
# 4096 and 8192 are bucket edges; 200k is the longest read of the harness.
SIZES = [1, 3, 4095, 4096, 4097, 8192, 200_000]
_DTYPE = {1: np.int8, 2: np.int16, 4: np.int32}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("flavor,isz,zigzag,version", FLAVORS,
                         ids=[f[0] for f in FLAVORS])
def test_lattice_matches_oracle(flavor, isz, zigzag, version, tier, n):
    x = workloads.content(tier, n, seed=n + isz, dtype=_DTYPE[isz])
    stream = device_backend.svb_compress(x, isz, zigzag, version)
    assert stream == scalar.svb_compress(x, isz, zigzag, version)
    out = device_backend.svb_decompress(stream, n, isz, zigzag, version)
    assert out.dtype == _DTYPE[isz]
    np.testing.assert_array_equal(out, x)


def _outcome(backend, stream, count, isz, zigzag, version):
    try:
        return np.asarray(backend.svb_decompress(stream, count, isz, zigzag,
                                                 version)).tobytes()
    except VbzError:
        return VbzError


def _malformed(kind, isz, zigzag, version):
    rng = np.random.default_rng(7)
    count = 4097  # a ragged tail: the last key byte has unused code bits
    x = rng.integers(-100, 100, count).astype(_DTYPE[isz])
    good = np.frombuffer(scalar.svb_compress(x, isz, zigzag, version),
                         np.uint8)
    key_len = (count + 3) // 4
    if kind == "truncated":
        return good[:-1].copy(), count
    if kind == "length_mismatch":
        return np.concatenate([good, np.zeros(1, np.uint8)]), count
    if kind == "trailing_key_bits":
        bad = good.copy()
        bad[key_len - 1] |= 0xC0  # codes for values past count
        return bad, count
    # widest_codes: every value carries code 3 — four bytes (v0) or four
    # nibbles (v1), more than a narrow flavor's encoder ever writes.
    keys = np.full(key_len, 0xFF, np.uint8)
    keys[-1] = 0xFF >> (2 * (4 * key_len - count))
    data = rng.integers(0, 256, count * (2 if version == 1 else 4),
                        dtype=np.uint8)
    return np.concatenate([keys, data]), count


@pytest.mark.parametrize("kind", ["truncated", "length_mismatch",
                                  "trailing_key_bits", "widest_codes"])
@pytest.mark.parametrize("flavor,isz,zigzag,version", FLAVORS,
                         ids=[f[0] for f in FLAVORS])
def test_malformed_matches_oracle(flavor, isz, zigzag, version, kind):
    stream, count = _malformed(kind, isz, zigzag, version)
    want = _outcome(scalar, stream, count, isz, zigzag, version)
    got = _outcome(device_backend, stream, count, isz, zigzag, version)
    assert got == want
    if kind in ("truncated", "length_mismatch"):
        assert want is VbzError


def test_stream_longer_than_any_encoding_rejected():
    with pytest.raises(VbzError):
        device_backend.svb_decompress(b"\x00" * (5 * 4096 + 8), 4, 2, True, 0)


def test_empty_and_mismatched_empty():
    assert device_backend.svb_compress(b"", 2, True, 0) == b""
    assert device_backend.svb_decompress(b"", 0, 2, True, 0).size == 0
    with pytest.raises(VbzError):
        device_backend.svb_decompress(b"\x00", 0, 2, True, 0)


def test_batch_mixes_buckets_and_empty_chunks():
    rng = np.random.default_rng(5)
    chunks = [rng.integers(-500, 500, n).astype(np.int16)
              for n in (10, 0, 5000, 70_000, 4096)]
    streams = device_backend.svb_compress_batch(chunks, 2, True, 0)
    assert streams == [scalar.svb_compress(c, 2, True, 0) for c in chunks]
    outs = device_backend.svb_decompress_batch(
        streams, [c.size for c in chunks], 2, True, 0)
    for c, o in zip(chunks, outs):
        np.testing.assert_array_equal(o, c)


@pytest.mark.parametrize("count,bucket", [(1, 4096), (4096, 4096),
                                          (4097, 8192), (200_000, 262144)])
def test_bucket_size(count, bucket):
    assert bucket_size(count) == bucket
