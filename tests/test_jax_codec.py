"""Cross-check the XLA device plane against the NumPy oracle — bit-exact
stream equality, not just round-trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vbz_compression_tpu import CompressionOptions, VbzError, api
from vbz_compression_tpu.models.codec import device_backend
from vbz_compression_tpu.ops import jax_svb, scalar

DTYPES = [np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32]


def _random(dtype, size, seed=0):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, size=size, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zigzag", [False, True])
def test_encode_bit_exact_vs_oracle(dtype, zigzag):
    data = _random(dtype, 10_000)
    size = data.dtype.itemsize
    ours = device_backend.svb_compress(data, size, zigzag, 0)
    ref = scalar.svb_compress(data, size, zigzag, 0)
    assert ours == ref


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zigzag", [False, True])
def test_decode_bit_exact_vs_oracle(dtype, zigzag):
    data = _random(dtype, 10_000, seed=5)
    size = data.dtype.itemsize
    stream = scalar.svb_compress(data, size, zigzag, 0)
    ours = device_backend.svb_decompress(stream, data.size, size, zigzag, 0)
    np.testing.assert_array_equal(ours.view(dtype), data)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 4095, 4096, 4097])
def test_ragged_sizes_int16(n):
    data = _random(np.int16, n, seed=n)
    ours = device_backend.svb_compress(data, 2, True, 0)
    ref = scalar.svb_compress(data, 2, True, 0)
    assert ours == ref
    rt = device_backend.svb_decompress(ours, n, 2, True, 0)
    np.testing.assert_array_equal(rt, data)


def test_wraparound_boundary_int16():
    data = np.array([-32768, 32767, -32768, 32767, 0, 32767, -32768],
                    dtype=np.int16)
    assert (device_backend.svb_compress(data, 2, True, 0)
            == scalar.svb_compress(data, 2, True, 0))


def test_malformed_stream_raises():
    with pytest.raises(VbzError):
        device_backend.svb_decompress(b"\x00\x01\x02\x03\x04\x05", 4, 2, True, 0)


@pytest.mark.slow
def test_api_pipeline_with_jax_backend():
    sig = _random(np.int16, 123_456, seed=9)
    opts = CompressionOptions(True, 2, 1, 0)
    ours = api.vbz_compress_sized(sig, opts, backend=device_backend)
    ref = api.vbz_compress_sized(sig, opts, backend=scalar)
    assert ours == ref
    rt = api.vbz_decompress_sized(ours, opts, backend=device_backend)
    np.testing.assert_array_equal(np.frombuffer(rt, np.int16), sig)


@pytest.mark.slow
def test_fast5_corpus_jax_backend():
    import os
    from vbz_compression_tpu.utils import hdf5_chunks
    td = "/root/reference/test_data"
    if not os.path.isdir(td):
        pytest.skip("reference test_data not mounted")
    gz = hdf5_chunks.read_gzip_signals(os.path.join(td, "multi_fast5_zip.fast5"))
    n = 0
    for name, opts, chunk, _ in hdf5_chunks.iter_vbz_signal_chunks(
            os.path.join(td, "multi_fast5_vbz.fast5")):
        out = api.vbz_decompress_sized(chunk, opts, backend=device_backend)
        np.testing.assert_array_equal(np.frombuffer(out, np.int16), gz[name])
        ours = api.vbz_compress_sized(gz[name], opts, backend=device_backend)
        ref = api.vbz_compress_sized(gz[name], opts, backend=scalar)
        assert ours == ref
        n += 1
    assert n == 10


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("zigzag", [False, True])
def test_v1_halfbyte_bit_exact_vs_oracle(dtype, zigzag):
    data = _random(dtype, 10_000, seed=21)
    ours = device_backend.svb_compress(data, 1, zigzag, 1)
    ref = scalar.svb_compress(data, 1, zigzag, 1)
    assert ours == ref
    rt = device_backend.svb_decompress(ours, data.size, 1, zigzag, 1)
    np.testing.assert_array_equal(rt.view(dtype), data)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4095, 4096, 4097])
def test_v1_ragged_sizes(n):
    data = _random(np.int8, n, seed=n + 100)
    ours = device_backend.svb_compress(data, 1, True, 1)
    ref = scalar.svb_compress(data, 1, True, 1)
    assert ours == ref
    rt = device_backend.svb_decompress(ours, n, 1, True, 1)
    np.testing.assert_array_equal(rt, data)


def test_v1_sparse_zeros():
    # code-0 (zero byte) handling: mostly-zero int8 stream.
    rng = np.random.default_rng(3)
    data = (rng.random(5000) < 0.05).astype(np.int8) * rng.integers(
        -100, 100, 5000).astype(np.int8)
    ours = device_backend.svb_compress(data, 1, True, 1)
    ref = scalar.svb_compress(data, 1, True, 1)
    assert ours == ref


@pytest.mark.parametrize("B", [1, 2, 5])
def test_scatter_rows_matches_numpy(B):
    """Row b of the positions writes row b of the buffer; dropped entries
    touch nothing."""
    rng = np.random.default_rng(B)
    width, per_row = 64, 40
    pos = np.stack([rng.permutation(width)[:per_row] for _ in range(B)])
    vals = rng.integers(1, 256, (B, per_row)).astype(np.uint8)
    keep = rng.random((B, per_row)) < 0.7
    want = np.zeros((B, width), np.uint8)
    for b in range(B):
        want[b, pos[b][keep[b]]] = vals[b][keep[b]]
    got = jax_svb._scatter_rows(width, jnp.asarray(pos, jnp.int32),
                                jnp.asarray(vals), jnp.asarray(keep))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("isz,zigzag,version", [
    (2, True, 0), (2, False, 0), (1, True, 0), (4, True, 0), (4, False, 0),
    (1, True, 1), (1, False, 1)])
def test_rows_batch_matches_oracle(isz, zigzag, version):
    """Ragged rows in one [B, N] call: each row's stream and total equal the
    oracle's, and each decodes back to its row."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[isz]
    info = np.iinfo(dtype)
    rng = np.random.default_rng(isz + version)
    lens = np.array([8192, 1, 0, 5000, 8191, 4097], np.int32)
    x = rng.integers(info.min, info.max, (lens.size, 8192), dtype=dtype,
                     endpoint=True)
    streams, totals = jax_svb.encode_rows(jnp.asarray(x), jnp.asarray(lens),
                                          isz, zigzag, version)
    streams, totals = np.asarray(streams), np.asarray(totals)
    for b, n in enumerate(lens):
        ref = scalar.svb_compress(x[b, :n], isz, zigzag, version)
        assert streams[b, : totals[b]].tobytes() == ref
        assert not streams[b, totals[b]:].any()
    out, ok = jax_svb.decode_rows(jnp.asarray(streams), jnp.asarray(lens),
                                  jnp.asarray(totals), isz, zigzag, 8192,
                                  version)
    assert np.asarray(ok).all()
    out = np.asarray(out)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], x[b, :n])


def _scatter_operands(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name.startswith("scatter"):
            yield eqn.invars[0].aval.shape
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _scatter_operands(sub)


@pytest.mark.parametrize("isz,zigzag,version", [(2, True, 0), (4, True, 0),
                                                (1, True, 1)])
def test_encode_rows_indexes_each_row(isz, zigzag, version):
    """A batch whose streams together pass 2**31 bytes traces, and every
    scatter keeps the row axis: no index spans rows, so none wraps in int32
    however many rows a call holds (traced only; nothing is allocated)."""
    B, N = 4096, 262144
    x = jax.ShapeDtypeStruct((B, N), {1: jnp.int8, 2: jnp.int16,
                                      4: jnp.int32}[isz])
    n = jax.ShapeDtypeStruct((B,), jnp.int32)
    M = jax_svb.stream_capacity(N, isz, zigzag, version)
    assert B * M >= 2**31
    jaxpr = jax.make_jaxpr(functools.partial(
        jax_svb.encode_rows, integer_size=isz, use_zigzag=zigzag,
        version=version))(x, n).jaxpr
    shapes = list(_scatter_operands(jaxpr))
    assert shapes and all(len(s) == 2 and s[0] == B for s in shapes)


def test_row_index_bound_raises():
    """One row too long for int32 indices is refused, not wrapped."""
    N = 1 << 29
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(functools.partial(
            jax_svb.encode_rows, integer_size=4, use_zigzag=True),
            jax.ShapeDtypeStruct((1, N), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.int32))
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(functools.partial(
            jax_svb.decode_rows, integer_size=2, use_zigzag=True, out_n=N),
            jax.ShapeDtypeStruct((1, N // 4 + 2 * N), jnp.uint8),
            jax.ShapeDtypeStruct((1,), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.int32))
