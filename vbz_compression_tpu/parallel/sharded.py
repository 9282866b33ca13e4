"""Data-parallel codec over a device mesh.

The reference is single-threaded CPU (its only parallelism is ``xargs -P``
over files, reference README.md:36-40). Here *independent chunks* — the
natural axis of this workload — are sharded across a flat 1-D ``data`` mesh
with ``jax.sharding``/``shard_map``:

- batches of equal-padded chunks are split over the mesh's data axis,
- each device runs the row-batched StreamVByte plane
  (:func:`..ops.jax_svb.encode_rows` / :func:`..ops.jax_svb.decode_rows`),
- compressed frame lengths are all-gathered in chunk order so every host
  can assemble the ordered output corpus,
- a ``psum`` of payload bytes gives the global compressed size without host
  round-trips.

The cards of one host are joined all to all, so the mesh follows the data
alone. Multi-host: the same code runs under ``jax.distributed`` — the mesh
spans all processes' devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import jax_svb


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


@functools.partial(
    jax.jit, static_argnames=("mesh", "integer_size", "use_zigzag", "version"))
def batch_encode_sharded(x: jax.Array, lengths: jax.Array, *, mesh: Mesh,
                         integer_size: int = 2, use_zigzag: bool = True,
                         version: int = 0):
    """Encode a [B, N] batch data-parallel over the mesh.

    Returns ``(streams [B, M] u8, stream_lens [B], total_bytes scalar)`` —
    streams stay sharded over the data axis; ``stream_lens`` is all-gathered
    (replicated) so any host can lay out the ordered corpus; ``total_bytes``
    is the psum'd global compressed size, an int32: keep one call's
    ``B * M`` under 2**31, as :func:`.multihost.compress_signals` does.
    """
    axis = mesh.axis_names[0]

    def local(xs, ns):
        streams, lens = jax_svb.encode_rows(xs, ns, integer_size, use_zigzag,
                                            version)
        gathered = jax.lax.all_gather(lens, axis, tiled=True)
        total = jax.lax.psum(jnp.sum(lens), axis)
        return streams, gathered, total

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(), P()),
        check_vma=False,
    )(x, lengths)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "integer_size", "use_zigzag", "out_n", "version"))
def batch_decode_sharded(streams: jax.Array, lengths: jax.Array,
                         stream_lens: jax.Array, *, mesh: Mesh,
                         integer_size: int = 2, use_zigzag: bool = True,
                         out_n: int = 4096, version: int = 0):
    """Decode a [B, M] batch of streams data-parallel over the mesh.

    Returns ``(x [B, out_n], ok [B])`` with ``ok`` all-gathered (replicated)
    so validation failures are visible globally.
    """
    axis = mesh.axis_names[0]

    def local(ss, ns, ls):
        out, ok = jax_svb.decode_rows(ss, ns, ls, integer_size, use_zigzag,
                                      out_n, version)
        return out, jax.lax.all_gather(ok, axis, tiled=True)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )(streams, lengths, stream_lens)


# ---------------------------------------------------------------------------
# Host-facing bulk driver
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, arr: np.ndarray) -> jax.Array:
    """Place a host batch onto the mesh, split along the leading axis."""
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(arr, sharding)


def pad_chunks(chunks: list[np.ndarray], pad_to: int | None = None):
    """Pad a ragged list of 1-D arrays into a zero-filled [B, N] batch +
    lengths."""
    n = max((c.size for c in chunks), default=0)
    N = pad_to or max(4, -(-n // 4) * 4)
    B = len(chunks)
    out = np.zeros((B, N), dtype=chunks[0].dtype if chunks else np.int16)
    lens = np.zeros(B, dtype=np.int32)
    for i, c in enumerate(chunks):
        out[i, : c.size] = c
        lens[i] = c.size
    return out, lens
