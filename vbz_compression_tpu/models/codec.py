"""Device codec backend — the host-facing wrapper around the XLA data plane.

Presents the same backend interface as the NumPy oracle
(``svb_compress`` / ``svb_decompress``) so the pipeline orchestrator
(:mod:`..api`) runs the StreamVByte stage on the accelerator, plus a batched
API for bulk chunk workloads. Every flavor of the 32020 lattice (v0 with
1-, 2- or 4-byte integers, with or without zig-zag, and v1 int8) runs on the
device, at every chunk size.

Static-shape management: chunk lengths are padded to bucket sizes so the jit
cache stays small (SURVEY.md §7 "ragged reads" landmine). Buckets double from
4 Ki values up; one compiled executable serves each
(bucket, integer_size, zigzag, version) combination.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import (
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)
from ..ops import jax_svb

_SIGNED_FOR_SIZE = {1: np.int8, 2: np.int16, 4: np.int32}
_MIN_BUCKET = 4096


def bucket_size(count: int) -> int:
    b = _MIN_BUCKET
    while b < count:
        b *= 2
    return b


def _check_integer_size(integer_size: int) -> None:
    if integer_size not in _SIGNED_FOR_SIZE:
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")


def _typed_input(data, integer_size: int) -> np.ndarray:
    raw = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8).ravel()
    if raw.size % integer_size != 0:
        raise VbzError(VBZ_INPUT_SIZE_ERROR,
                       f"{raw.size} % {integer_size} != 0")
    return raw.view(_SIGNED_FOR_SIZE[integer_size])


def _as_u8(stream) -> np.ndarray:
    return np.frombuffer(bytes(stream), dtype=np.uint8) if not isinstance(
        stream, np.ndarray) else stream.astype(np.uint8, copy=False).ravel()


def decode_capacity(n_padded: int, integer_size: int, version: int) -> int:
    """Stream buffer length a decode of ``n_padded`` values accepts: the
    wire format allows 4-byte codes at every width, so a v0 stream may be
    longer than what the encoder of a narrow flavor writes."""
    if version == 1 and integer_size == 1:
        return n_padded // 4 + 2 * n_padded
    return n_padded // 4 + 4 * n_padded


class DeviceSvbBackend:
    """StreamVByte stage on the XLA device plane (:mod:`..ops.jax_svb`),
    bit-exact with the oracle (:mod:`..ops.scalar`)."""

    # -- encode --------------------------------------------------------------

    def svb_compress(self, data, integer_size: int, use_zigzag: bool,
                     version: int) -> bytes:
        return self.svb_compress_batch([data], integer_size, use_zigzag,
                                       version)[0]

    def svb_compress_batch(self, arrays, integer_size: int, use_zigzag: bool,
                           version: int) -> list:
        """Encode many chunks: every chunk's device call is queued before
        any result is pulled, and all results come back in one transfer."""
        _check_integer_size(integer_size)
        queued = [self._queue_encode(_typed_input(a, integer_size),
                                     integer_size, use_zigzag, version)
                  for a in arrays]
        return [b"" if q is None else q[0][0, : q[1][0]].tobytes()
                for q in jax.device_get(queued)]

    @staticmethod
    def _queue_encode(typed: np.ndarray, integer_size: int, use_zigzag: bool,
                      version: int):
        """Start one chunk's device encode; returns the device arrays
        ``(streams [1, M], totals [1])``, or None for an empty chunk."""
        n = typed.size
        if n == 0:
            return None
        x = np.zeros((1, bucket_size(n)), typed.dtype)
        x[0, :n] = typed
        return jax_svb.encode_rows(jnp.asarray(x), jnp.asarray([n], jnp.int32),
                                   integer_size, use_zigzag, version)

    # -- decode --------------------------------------------------------------

    def svb_decompress(self, stream, count: int, integer_size: int,
                       use_zigzag: bool, version: int) -> np.ndarray:
        return self.svb_decompress_batch([stream], [count], integer_size,
                                         use_zigzag, version)[0]

    def svb_decompress_batch(self, streams, counts, integer_size: int,
                             use_zigzag: bool, version: int) -> list:
        """Decode many chunks (mirror of :meth:`svb_compress_batch`). A
        stream the oracle would reject raises ``VbzError``."""
        _check_integer_size(integer_size)
        queued = []
        for stream, count in zip(streams, counts):
            buf = _as_u8(stream)
            if count == 0 or buf.size == 0:
                if buf.size != count:
                    raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                                   "empty stream mismatch")
                queued.append(None)
                continue
            N = bucket_size(count)
            M = decode_capacity(N, integer_size, version)
            if buf.size > M:
                raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream too long")
            s = np.zeros((1, M), np.uint8)
            s[0, : buf.size] = buf
            queued.append(jax_svb.decode_rows(
                jnp.asarray(s), jnp.asarray([count], jnp.int32),
                jnp.asarray([buf.size], jnp.int32), integer_size, use_zigzag,
                N, version))
        outs = []
        for q, count in zip(jax.device_get(queued), counts):
            if q is None:
                outs.append(np.zeros(0, _SIGNED_FOR_SIZE[integer_size]))
                continue
            values, ok = q
            if not ok[0]:
                raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                               "data length disagrees with the key codes")
            outs.append(values[0, :count])
        return outs


device_backend = DeviceSvbBackend()
