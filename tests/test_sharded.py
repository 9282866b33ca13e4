"""Multi-device data-parallel codec tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu.parallel import sharded


def test_batch_encode_decode_sharded_roundtrip():
    assert len(jax.devices()) == 8
    mesh = sharded.make_mesh()
    B, N = 16, 512
    rng = np.random.default_rng(0)
    chunks = [rng.integers(-3000, 3000, rng.integers(100, N + 1),
                           dtype=np.int16) for _ in range(B)]
    batch, lens = sharded.pad_chunks(chunks, pad_to=N)

    xb = sharded.shard_batch(mesh, batch)
    lb = sharded.shard_batch(mesh, lens)
    streams, stream_lens, total = sharded.batch_encode_sharded(
        xb, lb, mesh=mesh, integer_size=2, use_zigzag=True)

    # Bit-exact per-row streams vs the oracle.
    streams_np = np.asarray(streams)
    stream_lens_np = np.asarray(stream_lens)
    for i, c in enumerate(chunks):
        ref = scalar.svb_compress(c, 2, True, 0)
        assert streams_np[i, : stream_lens_np[i]].tobytes() == ref
    assert int(total) == stream_lens_np.sum()

    out, ok = sharded.batch_decode_sharded(
        streams, lb, sharded.shard_batch(mesh, stream_lens_np), mesh=mesh,
        integer_size=2, use_zigzag=True, out_n=N)
    assert np.asarray(ok).all()
    out_np = np.asarray(out)
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(out_np[i, : c.size], c)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as graft

    fn, args = graft.entry()
    stream, total = jax.jit(fn)(*args)
    assert int(total) > 0


@pytest.mark.parametrize("isz,zigzag,version", [
    (2, True, 0), (2, False, 0), (1, True, 0), (1, False, 0), (4, True, 0),
    (4, False, 0), (1, True, 1), (1, False, 1)])
def test_four_device_mesh_matches_one_device(isz, zigzag, version):
    """The XLA mesh plane on 4 devices: shards land on 4 distinct devices,
    frames equal the 1-device mesh's in order, the psum total is the sum of
    the frame lengths, and every row decodes."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[isz]
    devices = jax.devices()[:4]
    mesh4, mesh1 = sharded.make_mesh(devices), sharded.make_mesh(devices[:1])
    rng = np.random.default_rng(isz * 10 + version)
    info = np.iinfo(dtype)
    chunks = [rng.integers(info.min, info.max, int(rng.integers(1, 1025)),
                           dtype=dtype, endpoint=True) for _ in range(8)]
    batch, lens = sharded.pad_chunks(chunks, pad_to=1024)
    out = {}
    for name, mesh in (("four", mesh4), ("one", mesh1)):
        xb = sharded.shard_batch(mesh, batch)
        streams, stream_lens, total = sharded.batch_encode_sharded(
            xb, sharded.shard_batch(mesh, lens), mesh=mesh, integer_size=isz,
            use_zigzag=zigzag, version=version)
        out[name] = (streams, np.asarray(stream_lens), int(total))
    streams4, lens4, total4 = out["four"]
    assert {s.device for s in streams4.addressable_shards} == set(devices)
    assert np.array_equal(np.asarray(streams4), np.asarray(out["one"][0]))
    assert np.array_equal(lens4, out["one"][1])
    assert total4 == lens4.sum()
    s4 = np.asarray(streams4)
    for i, c in enumerate(chunks):
        assert s4[i, : lens4[i]].tobytes() == scalar.svb_compress(
            c, isz, zigzag, version)
    dec, ok = sharded.batch_decode_sharded(
        streams4, sharded.shard_batch(mesh4, lens),
        sharded.shard_batch(mesh4, lens4), mesh=mesh4, integer_size=isz,
        use_zigzag=zigzag, out_n=1024, version=version)
    assert np.asarray(ok).all()
    dec = np.asarray(dec)
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(dec[i, : c.size], c)
