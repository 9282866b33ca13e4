"""Multi-host corpus driver.

Scales the codec from one host to several: each process compresses its
round-robin share of fast5 files on its local devices (data-parallel mesh,
:mod:`.sharded`), and global corpus statistics are combined with a
``process_allgather``. The reference has no distributed runtime at all (its
parallelism is ``xargs -P`` over files, reference README.md:36-40).

Usage on each host:

    from vbz_compression_tpu.parallel import multihost
    multihost.initialize()            # jax.distributed under the hood
    stats = multihost.compress_corpus(list_of_fast5_paths, out_dir)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

import jax

from .. import api
from ..models import codec
from ..ops import jax_svb
from ..options import CompressionOptions
from ..utils import hdf5_chunks
from . import sharded


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime (no-op for single process)."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


@dataclasses.dataclass
class CorpusStats:
    files: int
    reads: int
    raw_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / max(self.raw_bytes, 1)


def _local_share(paths: list[str]) -> list[str]:
    """Round-robin file assignment by process index."""
    pid = jax.process_index()
    nproc = jax.process_count()
    return [p for i, p in enumerate(sorted(paths)) if i % nproc == pid]


_DTYPE_FOR_SIZE = {1: np.int8, 2: np.int16, 4: np.int32}

# Most stream bytes one device call of the corpus driver lays out. It bounds
# the call's device memory and host transfer, and keeps the call's int32
# total of stream lengths exact.
_CALL_STREAM_BYTES = 1 << 30


def compress_signals(signals: list[np.ndarray],
                     options: CompressionOptions | None = None,
                     mesh=None) -> list[bytes]:
    """Compress a list of signals on the local device mesh and return sized
    vbz streams in input order, byte-identical to
    :func:`..api.vbz_compress_sized`.

    Signals are bucketed by padded length (:func:`..models.codec.bucket_size`)
    and each bucket runs as batched calls of the mesh plane
    (:func:`.sharded.batch_encode_sharded`), each laying out at most
    ``_CALL_STREAM_BYTES`` of streams. The zstd stage runs host-side,
    threaded across a call's payloads.
    """
    import struct

    options = options or CompressionOptions(True, 2, 1, 0)
    options.validate().validate_version()
    dtype = _DTYPE_FOR_SIZE[options.integer_size]
    width = np.dtype(dtype).itemsize
    mesh = mesh or sharded.make_mesh(jax.local_devices())
    ndev = mesh.devices.size

    out: list[bytes | None] = [None] * len(signals)
    by_bucket: dict[int, list[int]] = {}
    for i, s in enumerate(signals):
        by_bucket.setdefault(codec.bucket_size(s.size), []).append(i)

    calls = []
    for b, idxs in by_bucket.items():
        capacity = jax_svb.stream_capacity(
            b, options.integer_size, options.perform_delta_zig_zag,
            options.vbz_version)
        rows = max(1, _CALL_STREAM_BYTES // capacity // ndev) * ndev
        calls += [(b, idxs[k: k + rows]) for k in range(0, len(idxs), rows)]

    for b, idxs in calls:
        # Pad the batch to a multiple of the device count.
        batch_idx = list(idxs)
        while len(batch_idx) % ndev:
            batch_idx.append(idxs[-1])
        chunks = [np.asarray(signals[i]).astype(dtype, copy=False)
                  for i in batch_idx]
        batch, lens = sharded.pad_chunks(chunks, pad_to=b)
        streams, stream_lens, _total = sharded.batch_encode_sharded(
            sharded.shard_batch(mesh, batch),
            sharded.shard_batch(mesh, lens),
            mesh=mesh, integer_size=options.integer_size,
            use_zigzag=options.perform_delta_zig_zag,
            version=options.vbz_version)
        streams_np, lens_np = jax.device_get((streams, stream_lens))
        svbs = [streams_np[row, : lens_np[row]].tobytes()
                for row in range(len(idxs))]

        if options.zstd_compression_level:
            payloads = api._map_zstd(
                lambda s: api.zstd_compress(
                    s, options.zstd_compression_level), svbs)
        else:
            payloads = svbs
        for i, payload in zip(idxs, payloads):
            out[i] = struct.pack("<I", width * signals[i].size) \
                + bytes(payload)
    return out


def compress_corpus(paths: list[str], out_dir: str | None = None,
                    options: CompressionOptions | None = None) -> CorpusStats:
    """Compress every signal in this process's share of ``paths``.

    Returns *global* corpus stats (allgathered across processes).
    """
    options = options or CompressionOptions(True, 2, 1, 0)
    local = _local_share(paths)
    files = reads = raw = comp = 0
    for path in local:
        signals = list(hdf5_chunks.read_gzip_signals(path).values())
        if not signals:
            continue
        streams = compress_signals(signals, options)
        files += 1
        reads += len(signals)
        raw += sum(s.nbytes for s in signals)
        comp += sum(len(c) for c in streams)
        if out_dir:
            base = os.path.basename(path) + ".vbz"
            with open(os.path.join(out_dir, base), "wb") as f:
                for c in streams:
                    f.write(np.uint32(len(c)).tobytes())
                    f.write(c)

    local_stats = np.array([files, reads, raw, comp], dtype=np.int64)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        gathered = multihost_utils.process_allgather(local_stats)
        total = np.asarray(gathered).reshape(-1, 4).sum(axis=0)
    else:
        total = local_stats
    return CorpusStats(int(total[0]), int(total[1]), int(total[2]),
                       int(total[3]))
