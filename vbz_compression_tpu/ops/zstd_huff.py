"""From-scratch zstd-frame encoder: Huffman-literals blocks (RFC 8878).

This is stage one of the device-resident entropy coder (SURVEY.md §7 step 3b):
a zstd *frame* writer whose compressed blocks use order-0 Huffman coding of
the whole block as literals with zero sequences. Any stock zstd decoder
(including the reference's ``ZSTD_decompress``) reads these frames — frame
compatibility is validated in tests against libzstd.

Layout produced per frame (RFC 8878 §3.1.1):
  magic 0xFD2FB528 | frame header (single-segment, FCS) | blocks | (no checksum)

Per block (≤ 128 KiB regenerated):
  - if Huffman saves nothing → Raw_Block.
  - else Compressed_Block:
      Literals_Section_Header (Compressed_Literals_Block, 1 stream,
      size_format=00/01/10 as needed)
      | Huffman tree description (direct 4-bit weights)
      | Huffman bitstream (written backwards, final 1-bit sentinel)
      | 0x00 (Number_of_Sequences = 0)

The canonical-code and weight conventions follow the spec exactly:
weight(s) = Max_Bits + 1 - nbits(s); codes are assigned per increasing
bit-count with ties broken by "natural sequential order" — concretely, the
values are ranked by (nbits, symbol) and codes count down from the top of
each bit-length band; see build_codes().

The bit-packing step reuses the codec's prefix-sum machinery and is
expressible on the accelerator; the NumPy path here is the oracle.
"""

from __future__ import annotations

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
MAX_CODE_BITS = 11  # our encoder limit (spec allows up to 11 for literals)


# ---------------------------------------------------------------------------
# Canonical Huffman table construction (host-side; tables are tiny)
# ---------------------------------------------------------------------------


def _length_limited_lengths(freqs: np.ndarray, max_bits: int) -> np.ndarray:
    """Package-merge length-limited code lengths for nonzero freqs."""
    sym = np.nonzero(freqs)[0]
    n = sym.size
    if n == 0:
        return np.zeros(256, dtype=np.int32)
    if n == 1:
        out = np.zeros(256, dtype=np.int32)
        out[sym[0]] = 1
        return out
    f = freqs[sym].astype(np.int64)

    # Package-merge algorithm.
    items = [(int(fi), (int(s),)) for fi, s in zip(f, sym)]
    items.sort()
    packages = list(items)
    merged = list(items)
    for _ in range(max_bits - 1):
        # pair up adjacent packages
        paired = []
        for i in range(0, len(merged) - 1, 2):
            w = merged[i][0] + merged[i + 1][0]
            syms = merged[i][1] + merged[i + 1][1]
            paired.append((w, syms))
        merged = sorted(items + paired)
    # take first 2n-2 packages; count symbol occurrences = code length
    counts = {int(s): 0 for s in sym}
    for w, syms in merged[: 2 * n - 2]:
        for s in syms:
            counts[s] += 1
    out = np.zeros(256, dtype=np.int32)
    for s, c in counts.items():
        out[s] = c
    return out


def build_codes(data: np.ndarray):
    """Return (nbits[256], code[256], weights list, max_bits) per zstd rules,
    or None when Huffman coding is not applicable (single distinct symbol).
    """
    freqs = np.bincount(data, minlength=256)
    nz = int((freqs > 0).sum())
    if nz <= 1:
        return None
    lib = _native_bits()
    if lib is not None and hasattr(lib, "vbz_huff_build_codes"):
        import ctypes

        f64 = np.ascontiguousarray(freqs.astype(np.int64))
        nbits = np.zeros(256, np.uint8)
        code = np.zeros(256, np.uint16)
        max_bits = int(lib.vbz_huff_build_codes(
            f64.ctypes.data_as(ctypes.c_void_p), MAX_CODE_BITS,
            nbits.ctypes.data_as(ctypes.c_void_p),
            code.ctypes.data_as(ctypes.c_void_p)))
        weights = np.where(nbits > 0, max_bits + 1 - nbits.astype(np.int32),
                           0).astype(np.int32)
        return nbits, code, weights, max_bits
    nbits = _length_limited_lengths(freqs, MAX_CODE_BITS)
    max_bits = int(nbits.max())
    # zstd weights: weight = max_bits + 1 - nbits (0 for absent symbols).
    weights = np.where(nbits > 0, max_bits + 1 - nbits, 0).astype(np.int32)

    # Canonical code assignment (spec: "codes are sorted in natural
    # sequential order" within a weight; lower weights = longer codes get the
    # numerically smaller codes starting at 0).
    code = np.zeros(256, dtype=np.uint16)
    cur = 0
    for bits in range(max_bits, 0, -1):
        symbols = np.nonzero(nbits == bits)[0]
        for s in symbols:
            code[s] = cur
            cur += 1
        cur >>= 1  # moving to one bit shorter halves the next start
    # u16 codes / u8 lengths: code[chunk] / nbits[chunk] feed the native
    # bit packer without per-call astype copies.
    return nbits.astype(np.uint8), code, weights, max_bits


def encode_weights_direct(weights: np.ndarray) -> bytes:
    """Huffman tree description, direct representation (headerByte ≥ 128):
    4-bit weights for symbols 0..Number_of_Symbols-2 (last weight implied)."""
    present = np.nonzero(weights > 0)[0]
    last = int(present[-1])
    # Number_of_Weights = headerByte - 127 explicit weights for symbols
    # 0..last-1; the decoder infers the weight of symbol `last` from the
    # Kraft completion.
    stored = weights[:last]
    if last > 127:
        raise ValueError("direct weights limited to 128 symbols")
    header = bytes([127 + last])
    nibbles = list(stored)
    if len(nibbles) % 2:
        nibbles.append(0)
    payload = bytes(
        ((int(nibbles[i]) << 4) | int(nibbles[i + 1]))
        for i in range(0, len(nibbles), 2))
    return header + payload


def _check_implied_weight(weights: np.ndarray, max_bits: int) -> bool:
    """The last present symbol's weight is implied by the kraft completion;
    verify our table satisfies zstd's reconstruction rule."""
    present = np.nonzero(weights > 0)[0]
    last = int(present[-1])
    total = int(np.sum((1 << (weights[:last][weights[:last] > 0])) // 2))
    # decoder computes: nearest power of two above total, implied weight from
    # the remainder — must be a power of two.
    target = 1 << max_bits
    rest = target - total
    return rest > 0 and (rest & (rest - 1)) == 0 and \
        rest == (1 << (weights[last] - 1))


# ---------------------------------------------------------------------------
# Bitstream packing (NumPy oracle; device path mirrors this with prefix sums)
# ---------------------------------------------------------------------------


def _native_bits():
    """The native bit packer (vbz_native.cpp) when the lib is built."""
    try:
        from .. import native_backend as nb

        lib = nb.lib()
        return lib if hasattr(lib, "vbz_bits_pack_backward") else None
    except Exception:
        return None


def pack_bits_backward(codes: np.ndarray, nbits: np.ndarray) -> bytes:
    """zstd Huffman stream: symbols pushed LSB-first in *reverse* input
    order, closed with a single 1 sentinel bit, padded to a byte."""
    lib = _native_bits()
    if lib is not None and codes.size:
        import ctypes

        c = np.ascontiguousarray(codes.astype(np.uint16, copy=False))
        b = np.ascontiguousarray(nbits.astype(np.uint8, copy=False))
        cap = int(b.astype(np.int64).sum()) // 8 + 16
        out = np.empty(cap, np.uint8)
        m = int(lib.vbz_bits_pack_backward(
            c.ctypes.data_as(ctypes.c_void_p),
            b.ctypes.data_as(ctypes.c_void_p), c.size,
            out.ctypes.data_as(ctypes.c_void_p), cap))
        assert m > 0, "bit packer overflow"
        return out[:m].tobytes()
    codes = codes[::-1].astype(np.uint64)
    nb = nbits[::-1].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(nb)])
    total_bits = int(offs[-1]) + 1  # + sentinel
    nwords = (total_bits + 63) // 64
    words = np.zeros(nwords + 1, dtype=np.uint64)
    w = offs[:-1] >> 6
    sh = (offs[:-1] & 63).astype(np.uint64)
    lo = (codes << sh).astype(np.uint64)
    hi = np.where(sh > 0, codes >> (np.uint64(64) - sh), 0).astype(np.uint64)
    np.bitwise_or.at(words, w, lo)
    np.bitwise_or.at(words, w + 1, hi)
    # sentinel bit
    sb = total_bits - 1
    words[sb >> 6] |= np.uint64(1) << np.uint64(sb & 63)
    nbytes = (total_bits + 7) // 8
    return words.tobytes()[:nbytes]


# ---------------------------------------------------------------------------
# Block + frame assembly
# ---------------------------------------------------------------------------


def _literals_header(regenerated: int, compressed: int,
                     four_streams: bool) -> bytes:
    """Compressed_Literals_Block section header (type=2). Size_Format:
    00 → 1 stream, 10-bit sizes (3 bytes); 01 → 4 streams, 10-bit;
    10 → 4 streams, 14-bit (4 bytes); 11 → 4 streams, 18-bit (5 bytes)."""
    if not four_streams:
        assert regenerated < (1 << 10) and compressed < (1 << 10)
        bits = 0b10 | (0b00 << 2) | (regenerated << 4) | (compressed << 14)
        return int(bits).to_bytes(3, "little")
    if regenerated < (1 << 10) and compressed < (1 << 10):
        bits = 0b10 | (0b01 << 2) | (regenerated << 4) | (compressed << 14)
        return int(bits).to_bytes(3, "little")
    if regenerated < (1 << 14) and compressed < (1 << 14):
        bits = 0b10 | (0b10 << 2) | (regenerated << 4) | (compressed << 18)
        return int(bits).to_bytes(4, "little")
    assert regenerated < (1 << 18) and compressed < (1 << 18)
    bits = 0b10 | (0b11 << 2) | (regenerated << 4) | (compressed << 22)
    return int(bits).to_bytes(5, "little")


def raw_literals_section(chunk: np.ndarray) -> bytes:
    """Raw_Literals_Block section: header + the literal bytes verbatim."""
    n = int(chunk.size)
    if n < 32:
        header = bytes([0 | (n << 3)])
    elif n < (1 << 12):
        header = int(0 | (0b01 << 2) | (n << 4)).to_bytes(2, "little")
    else:
        assert n < (1 << 20)
        header = int(0 | (0b11 << 2) | (n << 4)).to_bytes(3, "little")
    return header + chunk.tobytes()


def literals_section(chunk: np.ndarray) -> bytes:
    """Best literals section for ``chunk``: Huffman-compressed when it wins,
    RLE when constant, raw otherwise."""
    n = int(chunk.size)
    if n == 0:
        return bytes([0])  # raw, size 0
    if np.all(chunk == chunk[0]):
        # RLE_Literals_Block (type 1): same size formats as raw, 1 data byte.
        if n < 32:
            header = bytes([1 | (n << 3)])
        elif n < (1 << 12):
            header = int(1 | (0b01 << 2) | (n << 4)).to_bytes(2, "little")
        else:
            header = int(1 | (0b11 << 2) | (n << 4)).to_bytes(3, "little")
        return header + bytes([int(chunk[0])])
    compressed = compressed_literals_section(chunk)
    raw = raw_literals_section(chunk)
    if compressed is not None and len(compressed) < len(raw):
        return compressed
    return raw


def _huffman_block(chunk: np.ndarray) -> bytes | None:
    """Compressed_Block content for one ≤BLOCK_MAX literals run: best
    literals section + "0 sequences", or None when a Raw_Block wins."""
    content_sec = compressed_literals_section(chunk)
    if content_sec is None:
        return None
    content = content_sec + b"\x00"  # 0 sequences
    if len(content) >= chunk.size:
        return None
    return content


def compressed_literals_section(chunk: np.ndarray) -> bytes | None:
    """Compressed_Literals_Block section (header + tree + streams) for one
    ≤BLOCK_MAX literals run (4-stream Huffman for blocks > 1023 bytes,
    1-stream below), or None when Huffman does not win."""
    built = build_codes(chunk)
    if built is None:
        return None
    nbits, code, weights, max_bits = built
    if not _check_implied_weight(weights, max_bits):
        return None
    table = None
    # FSE-compressed weights (headerByte < 128) — required for alphabets
    # whose last symbol exceeds 127, preferred whenever smaller.
    from . import fse

    last = int(np.nonzero(weights > 0)[0][-1])
    payload = fse.compress_weights(weights[:last])
    if payload is not None:
        table = bytes([len(payload)]) + payload
    if last <= 127:
        try:
            direct = encode_weights_direct(weights)
        except ValueError:
            direct = None
        if direct is not None and (table is None or len(direct) < len(table)):
            table = direct
    if table is None:
        return None

    if chunk.size < 6 or (chunk.size < (1 << 10)
                          and len(table) + chunk.size < (1 << 10)):
        stream = pack_bits_backward(code[chunk], nbits[chunk])
        lit_compressed = len(table) + len(stream)
        if lit_compressed >= chunk.size:
            return None
        header = _literals_header(chunk.size, lit_compressed, False)
    else:
        # 4 streams: first three regenerate ceil(n/4), the fourth the rest
        # (RFC 8878 §3.1.1.3.1.6), one shared table, 6-byte jump table.
        part = (chunk.size + 3) // 4
        parts = [chunk[0:part], chunk[part:2 * part],
                 chunk[2 * part:3 * part], chunk[3 * part:]]
        if parts[3].size == 0:
            return None  # degenerate split; raw is fine at this size
        streams = [pack_bits_backward(code[p], nbits[p]) for p in parts]
        if any(len(s) >= (1 << 16) for s in streams[:3]):
            return None
        jump = b"".join(int(len(s)).to_bytes(2, "little")
                        for s in streams[:3])
        lit_compressed = len(table) + 6 + sum(len(s) for s in streams)
        if lit_compressed >= chunk.size or lit_compressed >= (1 << 18):
            return None
        header = _literals_header(chunk.size, lit_compressed, True)
        stream = jump + b"".join(streams)
    return header + table + stream


def compress_frame(data: bytes, level_hint: int = 1) -> bytes:
    """Produce a complete zstd frame for ``data`` using Huffman-literals
    blocks where they help, raw blocks otherwise."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size

    # Frame header: single-segment when content size < 256 fits FCS byte;
    # general: descriptor with FCS field.
    if n < 256:
        header = bytes([0x20, n])
    elif n < (1 << 16) + 256:
        header = bytes([0x60]) + int(n - 256).to_bytes(2, "little")
    else:
        header = bytes([0xA0]) + int(n).to_bytes(4, "little")
    out = [ZSTD_MAGIC.to_bytes(4, "little"), header]

    step = BLOCK_MAX
    pos = 0
    if n == 0:
        out.append((1 | (0 << 1) | (0 << 3)).to_bytes(3, "little"))
        return b"".join(out)
    while pos < n:
        chunk = buf[pos: pos + step]
        # Extend constant runs into an RLE block (up to Block_Maximum_Size).
        if chunk.size and np.all(chunk == chunk[0]):
            run_end = pos + chunk.size
            while run_end < min(n, pos + BLOCK_MAX) and buf[run_end] == chunk[0]:
                run_end += 1
            run = run_end - pos
            if run >= 4:
                pos = run_end
                last = 1 if pos >= n else 0
                bh = last | (1 << 1) | (run << 3)  # RLE_Block
                out.append(int(bh).to_bytes(3, "little"))
                out.append(bytes([int(chunk[0])]))
                continue
        pos += chunk.size
        last = 1 if pos >= n else 0
        content = _huffman_block(chunk)
        if content is None:
            bh = last | (0 << 1) | (chunk.size << 3)  # Raw_Block
            out.append(int(bh).to_bytes(3, "little"))
            out.append(chunk.tobytes())
        else:
            bh = last | (2 << 1) | (len(content) << 3)  # Compressed_Block
            out.append(int(bh).to_bytes(3, "little"))
            out.append(content)
    return b"".join(out)
