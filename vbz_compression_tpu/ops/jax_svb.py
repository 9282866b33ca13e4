"""XLA StreamVByte data plane — the codec's device path.

A jit-able implementation of the VBZ transform and variable-byte stage on
static padded shapes with runtime valid counts, batched over rows ``[B, N]``
(one chunk per row). It covers the whole 32020 lattice: v0 classic
StreamVByte with 1-, 2- or 4-byte integers, with or without delta/zig-zag,
and the v1 half-byte format for ``integer_size == 1``.

Wire-format semantics are identical to the NumPy oracle (:mod:`.scalar`) and
therefore to the reference codec: width-exact delta/zig-zag (16-bit
wraparound for int16 — the SSE kernel semantics of
``vbz/v0/vbz_streamvbyte_impl_sse3.h:431-440``). A stream is
``[(count+3)//4 key bytes][data]`` (reference ``sse3.h:415-417``).

The formulation is the direct one: codes -> exclusive prefix sum of the
per-value lengths -> one byte (or nibble) scatter at unique offsets to
encode, one gather at the same offsets to decode, with rows batched
natively rather than scanned. On the GPU this encoder beat the
doubling, block-doubling and bisection encoders at every size measured,
and the gather decoder beat the halving one (PERF.md, findings).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def max_bytes_per_value(integer_size: int, use_zigzag: bool) -> int:
    """Most data bytes the encoder writes per value: int16 zig-zag wraps in
    16 bits and int8 zig-zag deltas are at most 510; every other flavor can
    sign-extend to 32 bits."""
    return 2 if use_zigzag and integer_size in (1, 2) else 4


def stream_capacity(n_padded: int, integer_size: int, use_zigzag: bool,
                    version: int = 0) -> int:
    """Static length of the stream buffer the encoder writes for
    ``n_padded`` values."""
    if version == 1 and integer_size == 1:
        return n_padded // 4 + 2 * n_padded
    return n_padded // 4 + max_bytes_per_value(integer_size, use_zigzag) \
        * n_padded


def _cumsum(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum along the last axis (wrapping in ``x.dtype``).
    XLA's own lowering beat ``lax.associative_scan`` for one read per row
    (PERF.md, findings)."""
    return jnp.cumsum(x, axis=-1, dtype=x.dtype)


def _delta_fwd(x: jax.Array, integer_size: int) -> jax.Array:
    """[B, N] signed rows -> uint32 zig-zag deltas (as
    ``scalar.zigzag_delta_encode``)."""
    if integer_size == 2:
        x = x.astype(jnp.int16)
        d = x - jnp.pad(x[:, :-1], ((0, 0), (1, 0)))
        zz = (d.astype(jnp.uint16) << 1) ^ (d >> 15).astype(jnp.uint16)
        return zz.astype(jnp.uint32)
    x = x.astype(jnp.int32)
    d = x - jnp.pad(x[:, :-1], ((0, 0), (1, 0)))
    return (d.astype(jnp.uint32) << 1) ^ (d >> 31).astype(jnp.uint32)


def _delta_inv(v: jax.Array, integer_size: int) -> jax.Array:
    """uint32 zig-zag deltas -> signed rows (as ``scalar.zigzag_delta_decode``;
    int16 truncates each value to 16 bits first)."""
    if integer_size == 2:
        v = v.astype(jnp.uint16)
        d = (v >> 1) ^ (-(v & 1).astype(jnp.int16)).astype(jnp.uint16)
        return _cumsum(d).view(jnp.int16)
    d = (v >> 1) ^ (-(v & 1).astype(jnp.int32)).astype(jnp.uint32)
    out = _cumsum(d).view(jnp.int32)
    return out.astype(jnp.int8) if integer_size == 1 else out


def _narrow(v: jax.Array, integer_size: int) -> jax.Array:
    if integer_size == 1:
        return v.astype(jnp.uint8).view(jnp.int8)
    if integer_size == 2:
        return v.astype(jnp.uint16).view(jnp.int16)
    return v.view(jnp.int32)


def _decoded_bits(integer_size: int, use_zigzag: bool) -> int:
    """Low bits of each decoded uint32 that can reach the output: int16
    truncates to 16 bits, an int8 zig-zag delta needs bit 8."""
    if integer_size == 2:
        return 16
    return min(8 * integer_size + int(use_zigzag), 32)


def _check_row_index(largest: int) -> None:
    """Indices are int32 and never span rows, so only one row's extent
    bounds them: refuse a row whose largest index would wrap."""
    if largest >= 2**31:
        raise ValueError(f"a row needs index {largest}, past int32; split "
                         f"the chunk")


def _scatter_rows(width: int, pos, vals, keep):
    """Write ``vals`` at positions ``pos`` [B, ...] into a zero [B, width]
    u8 buffer, row b of ``pos`` indexing row b. Entries with ``keep`` False
    go to distinct slots past the row's end and are dropped, so every
    (row, position) pair stays unique. On the H200 this was as fast as or
    faster than one flat index over the whole batch and than a vmap of the
    one-row scatter (PERF.md, findings)."""
    B, per_row = pos.shape[0], pos[0].size
    _check_row_index(width + per_row)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32).reshape(
        (B,) + (1,) * (pos.ndim - 1)), pos.shape)
    spare = width + jnp.arange(per_row, dtype=jnp.int32).reshape(pos.shape[1:])
    return jnp.zeros((B, width), jnp.uint8).at[
        rows, jnp.where(keep, pos, spare)].set(
        vals.astype(jnp.uint8), mode="drop", unique_indices=True)


def _gather_rows(streams: jax.Array, idx: jax.Array) -> jax.Array:
    B, M = streams.shape
    flat = jnp.clip(idx, 0, M - 1).reshape(B, -1)
    return jnp.take_along_axis(streams, flat, axis=1).reshape(idx.shape)


@functools.partial(jax.jit, static_argnames=("integer_size", "use_zigzag",
                                              "version"))
def encode_rows(x: jax.Array, n: jax.Array, integer_size: int,
                use_zigzag: bool, version: int = 0):
    """Encode ``x`` [B, N] (N a multiple of 4; row b holds ``n[b]`` valid
    values) into wire-format streams.

    Returns ``(streams u8 [B, stream_capacity(N)], totals i32 [B])``; bytes
    past ``totals[b]`` are zero.
    """
    B, N = x.shape
    assert N % 4 == 0
    valid = jnp.arange(N, dtype=jnp.int32)[None, :] < n[:, None]
    v = _delta_fwd(x, integer_size) if use_zigzag else \
        x.astype(jnp.int32).view(jnp.uint32)
    v = jnp.where(valid, v, 0)
    key_len = (n + 3) // 4
    M = stream_capacity(N, integer_size, use_zigzag, version)
    if version == 1 and integer_size == 1:
        # Codes 0..3 carry 0, 1, 2 or 4 nibbles (reference v1/impl.h:112-125).
        codes = jnp.where(v == 0, 0, jnp.where(
            v < 16, 1, jnp.where(v < 256, 2, 3))).astype(jnp.int32)
        units, unit_bits, per_value = (1 << codes) >> 1, 4, 4
        width, base = 2 * M, 2 * key_len      # nibble slots
    else:
        codes = ((v > 0xFF).astype(jnp.int32) + (v > 0xFFFF)
                 + (v > 0xFFFFFF))
        units, unit_bits = jnp.where(valid, codes + 1, 0), 8
        per_value = max_bytes_per_value(integer_size, use_zigzag)
        width, base = M, key_len
    kc = codes.reshape(B, N // 4, 4)
    keys = (kc[..., 0] | (kc[..., 1] << 2) | (kc[..., 2] << 4)
            | (kc[..., 3] << 6)).astype(jnp.uint8)
    offs = _cumsum(units) - units + base[:, None]
    col = jnp.arange(per_value, dtype=jnp.int32)
    data = _scatter_rows(
        width, offs[..., None] + col,
        (v[..., None] >> (unit_bits * col).astype(jnp.uint32))
        & ((1 << unit_bits) - 1),
        col < units[..., None])
    total_units = jnp.sum(units, axis=1)
    if unit_bits == 4:
        data = data[:, 0::2] | (data[:, 1::2] << 4)
        total = key_len + (total_units + 1) // 2
    else:
        total = key_len + total_units
    # Key bytes past key_len are zero (padding has code 0), and no data
    # lands before key_len, so OR-ing the two sections assembles the stream.
    return data | jnp.pad(keys, ((0, 0), (0, M - N // 4))), total


@functools.partial(jax.jit, static_argnames=("integer_size", "use_zigzag",
                                              "out_n", "version"))
def decode_rows(streams: jax.Array, n: jax.Array, stream_len: jax.Array,
                integer_size: int, use_zigzag: bool, out_n: int,
                version: int = 0):
    """Decode [B, M] streams (row b: ``stream_len[b]`` bytes holding
    ``n[b]`` values, ``n[b] <= out_n``) into ``(x [B, out_n] signed,
    ok [B])``.

    ``ok`` is False where the data section length disagrees with the key
    codes (``streamvbyte_validate_stream``, ``v0/impl.h:49-67``; the
    half-byte check of ``v1/impl.h:183-216``) — the streams the oracle
    rejects.
    """
    B, M = streams.shape
    N = out_n
    assert N % 4 == 0 and M >= N // 4
    _check_row_index(N // 4 + 4 * N + 4)   # key bytes + 4-byte codes
    valid = jnp.arange(N, dtype=jnp.int32)[None, :] < n[:, None]
    key_len = (n + 3) // 4
    kb = streams[:, : N // 4].astype(jnp.int32)
    codes = ((kb[..., None] >> jnp.arange(0, 8, 2, dtype=jnp.int32)) & 3
             ).reshape(B, N)
    codes = jnp.where(valid, codes, 0)
    if version == 1 and integer_size == 1:
        units, unit_bits = (1 << codes) >> 1, 4
        total = key_len + (jnp.sum(units, axis=1) + 1) // 2
    else:
        units, unit_bits = jnp.where(valid, codes + 1, 0), 8
        total = key_len + jnp.sum(units, axis=1)
    ok = (total == stream_len) & (key_len <= stream_len)
    # Only the units that can reach the output are read.
    bits = _decoded_bits(integer_size, use_zigzag)
    col = jnp.arange(-(-bits // unit_bits), dtype=jnp.int32)
    q = (_cumsum(units) - units)[..., None] + col
    if unit_bits == 4:
        raw = _gather_rows(streams, key_len[:, None, None] + (q >> 1))
        piece = (raw.astype(jnp.uint32) >> (4 * (q & 1)).astype(jnp.uint32)) \
            & 0xF
    else:
        piece = _gather_rows(streams, key_len[:, None, None] + q).astype(
            jnp.uint32)
    vals = jnp.sum(jnp.where(col < units[..., None],
                             piece << (unit_bits * col).astype(jnp.uint32),
                             0), axis=-1, dtype=jnp.uint32)
    vals = jnp.where(valid, vals, 0)
    if use_zigzag:
        return _delta_inv(vals, integer_size), ok
    return _narrow(vals, integer_size), ok
