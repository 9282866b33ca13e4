// vbz_native — native C++ runtime codec for the VBZ framework.
//
// A from-scratch scalar implementation of the VBZ pipeline with the exact
// C ABI of the reference library (reference: vbz/vbz.h:56-141). It backs the
// HDF5 filter plugin (vbz_plugin.cpp) and serves as the single-core CPU
// baseline the device data plane is compared with.
//
// Wire-format semantics mirror the reference (see SURVEY.md §2 and the
// Python oracle vbz_compression_tpu/ops/scalar.py):
//   v0: classic StreamVByte — (count+3)/4 key bytes, 2-bit codes, code c →
//       c+1 little-endian data bytes (reference: vbz/v0/).
//   v1: half-byte codes for integer_size==1 — 0 bytes / 1 nibble / 1 byte /
//       2 bytes, nibble-packed data (reference: vbz/v1/vbz_streamvbyte_impl.h);
//       widths 2 and 4 delegate to v0 (vbz/v1/vbz_streamvbyte.cpp:46-61).
//   delta/zig-zag width semantics: 16-bit wraparound for int16 (the SSE
//   kernel semantics, vbz/v0/vbz_streamvbyte_impl_sse3.h:431-440); 32-bit
//   for int8/int32 (generic path, vbz/v0/vbz_streamvbyte_impl.h:32-34).
//
// This file is an independent implementation: structured around flat
// encode/decode loops over a uint32 value buffer, not the reference's
// template-worker design.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <vector>
#include <algorithm>

#include <zstd.h>

#include "vbz_native.h"
#include "vbz_simd.h"

namespace {

constexpr vbz_size_t kSizedHeaderBytes = 4;

bool valid_integer_size(const CompressionOptions* o) {
    unsigned s = o->integer_size;
    return s == 0 || s == 1 || s == 2 || s == 4;
}

vbz_size_t svb_bound(vbz_size_t count) {
    return (count + 3) / 4 + count * 4u;
}

// ---------------------------------------------------------------------------
// Transforms: input bytes -> uint32 value stream (and back)
// ---------------------------------------------------------------------------

void values_from_input(const uint8_t* src, vbz_size_t count,
                       unsigned integer_size, bool zigzag,
                       std::vector<uint32_t>& out) {
    out.resize(count);
    if (integer_size == 2 && zigzag) {
        // 16-bit wraparound deltas + 16-bit zig-zag.
        uint16_t prev = 0;
        for (vbz_size_t i = 0; i < count; ++i) {
            uint16_t cur;
            std::memcpy(&cur, src + 2 * i, 2);
            uint16_t delta = static_cast<uint16_t>(cur - prev);
            prev = cur;
            int16_t sd;
            std::memcpy(&sd, &delta, 2);
            out[i] = static_cast<uint16_t>((delta << 1) ^
                                           static_cast<uint16_t>(sd >> 15));
        }
        return;
    }
    // Widen to int32 then 32-bit delta/zig-zag (or plain widen).
    auto load = [&](vbz_size_t i) -> int32_t {
        switch (integer_size) {
            case 1: return static_cast<int8_t>(src[i]);
            case 2: { int16_t v; std::memcpy(&v, src + 2 * i, 2); return v; }
            default: { int32_t v; std::memcpy(&v, src + 4 * i, 4); return v; }
        }
    };
    if (!zigzag) {
        for (vbz_size_t i = 0; i < count; ++i)
            out[i] = static_cast<uint32_t>(load(i));
        return;
    }
    int32_t prev = 0;
    for (vbz_size_t i = 0; i < count; ++i) {
        int32_t cur = load(i);
        uint32_t delta = static_cast<uint32_t>(cur) - static_cast<uint32_t>(prev);
        prev = cur;
        int32_t sd;
        std::memcpy(&sd, &delta, 4);
        out[i] = (delta << 1) ^ static_cast<uint32_t>(sd >> 31);
    }
}

void values_to_output(const uint32_t* values, vbz_size_t count,
                      unsigned integer_size, bool zigzag, uint8_t* dst) {
    if (integer_size == 2 && zigzag) {
        // Truncate-first un-zig-zag + 16-bit wraparound prefix sum
        // (SSE decoder semantics).
        uint16_t acc = 0;
        for (vbz_size_t i = 0; i < count; ++i) {
            uint16_t v = static_cast<uint16_t>(values[i]);
            uint16_t delta = static_cast<uint16_t>(
                (v >> 1) ^ static_cast<uint16_t>(-(v & 1u)));
            acc = static_cast<uint16_t>(acc + delta);
            std::memcpy(dst + 2 * i, &acc, 2);
        }
        return;
    }
    auto store = [&](vbz_size_t i, uint32_t v) {
        switch (integer_size) {
            case 1: dst[i] = static_cast<uint8_t>(v); break;
            case 2: { uint16_t t = static_cast<uint16_t>(v);
                      std::memcpy(dst + 2 * i, &t, 2); break; }
            default: std::memcpy(dst + 4 * i, &v, 4); break;
        }
    };
    if (!zigzag) {
        for (vbz_size_t i = 0; i < count; ++i) store(i, values[i]);
        return;
    }
    uint32_t acc = 0;
    for (vbz_size_t i = 0; i < count; ++i) {
        uint32_t v = values[i];
        uint32_t delta = (v >> 1) ^ (~(v & 1u) + 1u);
        acc += delta;
        store(i, acc);
    }
}

// ---------------------------------------------------------------------------
// v0 StreamVByte packing
// ---------------------------------------------------------------------------

vbz_size_t svb0_encode(const uint32_t* values, vbz_size_t count,
                       uint8_t* dst, vbz_size_t capacity) {
    if (count == 0) return 0;
    vbz_size_t key_len = (count + 3) / 4;
    if (capacity < key_len) return VBZ_DESTINATION_SIZE_ERROR;
    uint8_t* keys = dst;
    uint8_t* data = dst + key_len;
    uint8_t* const end = dst + capacity;
    std::memset(keys, 0, key_len);
    for (vbz_size_t i = 0; i < count; ++i) {
        uint32_t v = values[i];
        unsigned code = (v > 0xFFu) + (v > 0xFFFFu) + (v > 0xFFFFFFu);
        keys[i >> 2] |= static_cast<uint8_t>(code << ((i & 3) * 2));
        if (data + code + 1 > end) return VBZ_DESTINATION_SIZE_ERROR;
        // Little-endian low bytes.
        for (unsigned b = 0; b <= code; ++b)
            *data++ = static_cast<uint8_t>(v >> (8 * b));
    }
    return static_cast<vbz_size_t>(data - dst);
}

vbz_size_t svb0_decode(const uint8_t* src, vbz_size_t src_size,
                       uint32_t* values, vbz_size_t count) {
    if (count == 0 || src_size == 0)
        return (count == src_size) ? 0 : VBZ_STREAMVBYTE_STREAM_ERROR;
    vbz_size_t key_len = (count + 3) / 4;
    if (key_len > src_size) return VBZ_STREAMVBYTE_STREAM_ERROR;
    const uint8_t* keys = src;
    const uint8_t* data = src + key_len;
    const uint8_t* const end = src + src_size;
    for (vbz_size_t i = 0; i < count; ++i) {
        unsigned code = (keys[i >> 2] >> ((i & 3) * 2)) & 3u;
        if (data + code + 1 > end) return VBZ_STREAMVBYTE_STREAM_ERROR;
        uint32_t v = 0;
        for (unsigned b = 0; b <= code; ++b)
            v |= static_cast<uint32_t>(*data++) << (8 * b);
        values[i] = v;
    }
    if (data != end) return VBZ_STREAMVBYTE_STREAM_ERROR;
    return count;
}

// ---------------------------------------------------------------------------
// v1 half-byte packing (integer_size == 1 only)
// ---------------------------------------------------------------------------

struct NibbleWriter {
    uint8_t* p;
    bool half = false;  // low nibble already written in *p
    void put(uint8_t nib) {
        if (half) { *p |= static_cast<uint8_t>(nib << 4); ++p; half = false; }
        else      { *p = nib; half = true; }
    }
    uint8_t* finish() { return half ? p + 1 : p; }
};

struct NibbleReader {
    const uint8_t* p;
    bool half = false;
    uint8_t get() {
        uint8_t v;
        if (half) { v = *p >> 4; ++p; half = false; }
        else      { v = *p & 0xF; half = true; }
        return v;
    }
    const uint8_t* finish() const { return half ? p + 1 : p; }
};

vbz_size_t svb1_encode(const uint32_t* values, vbz_size_t count,
                       uint8_t* dst, vbz_size_t capacity) {
    if (count == 0) return 0;
    vbz_size_t key_len = (count + 3) / 4;
    if (capacity < key_len) return VBZ_DESTINATION_SIZE_ERROR;
    uint8_t* keys = dst;
    std::memset(keys, 0, key_len);
    NibbleWriter w{dst + key_len};
    for (vbz_size_t i = 0; i < count; ++i) {
        uint32_t v = values[i];
        unsigned code;
        if (v == 0) code = 0;
        else if (v < 16) { code = 1; w.put(v & 0xF); }
        else if (v < 256) { code = 2; w.put(v & 0xF); w.put((v >> 4) & 0xF); }
        else { code = 3; for (int k = 0; k < 4; ++k) w.put((v >> (4 * k)) & 0xF); }
        keys[i >> 2] |= static_cast<uint8_t>(code << ((i & 3) * 2));
    }
    return static_cast<vbz_size_t>(w.finish() - dst);
}

vbz_size_t svb1_decode(const uint8_t* src, vbz_size_t src_size,
                       uint32_t* values, vbz_size_t count) {
    if (count == 0 || src_size == 0)
        return (count == src_size) ? 0 : VBZ_STREAMVBYTE_STREAM_ERROR;
    vbz_size_t key_len = (count + 3) / 4;
    if (key_len > src_size) return VBZ_STREAMVBYTE_STREAM_ERROR;
    // Validate: accumulate nibble sizes (reference: v1/impl.h:183-216).
    uint64_t nibbles = 0;
    for (vbz_size_t i = 0; i < count; ++i) {
        unsigned code = (src[i >> 2] >> ((i & 3) * 2)) & 3u;
        nibbles += (1u << code) >> 1;
    }
    if ((nibbles + 1) / 2 != src_size - key_len)
        return VBZ_STREAMVBYTE_STREAM_ERROR;
    NibbleReader r{src + key_len};
    for (vbz_size_t i = 0; i < count; ++i) {
        unsigned code = (src[i >> 2] >> ((i & 3) * 2)) & 3u;
        uint32_t v = 0;
        unsigned n = (1u << code) >> 1;
        for (unsigned k = 0; k < n; ++k)
            v |= static_cast<uint32_t>(r.get()) << (4 * k);
        values[i] = v;
    }
    return count;
}

// ---------------------------------------------------------------------------
// StreamVByte stage dispatch
// ---------------------------------------------------------------------------

vbz_size_t svb_stage_compress(const uint8_t* src, vbz_size_t src_size,
                              uint8_t* dst, vbz_size_t capacity,
                              const CompressionOptions* o) {
    if (src_size % o->integer_size != 0) return VBZ_INPUT_SIZE_ERROR;
    vbz_size_t count = src_size / o->integer_size;
#if VBZ_SIMD16Z
    // Hot path (fast5 signal): fused int16 zigzag-delta + encode, one
    // shuffle per 8 values (vbz_simd.h). v1 int16 delegates to v0 wire
    // format, so both versions take it.
    if (o->integer_size == 2 && o->perform_delta_zig_zag && count != 0 &&
        capacity >= (count + 3) / 4 && vbz_simd::usable()) {
        uint32_t r = vbz_simd::encode_16z(src, count, dst, capacity,
                                          (count + 3) / 4);
        if (r != 0) return r;  // 0: capacity-tight, redo via scalar bound
    }
#endif
    std::vector<uint32_t> values;
    values_from_input(src, count, o->integer_size,
                      o->perform_delta_zig_zag, values);
    if (o->vbz_version == 1 && o->integer_size == 1)
        return svb1_encode(values.data(), count, dst, capacity);
    return svb0_encode(values.data(), count, dst, capacity);
}

vbz_size_t svb_stage_decompress(const uint8_t* src, vbz_size_t src_size,
                                uint8_t* dst, vbz_size_t dst_size,
                                const CompressionOptions* o) {
    if (dst_size % o->integer_size != 0) return VBZ_DESTINATION_SIZE_ERROR;
    vbz_size_t count = dst_size / o->integer_size;
#if VBZ_SIMD16Z
    if (o->integer_size == 2 && o->perform_delta_zig_zag && count != 0 &&
        src_size != 0 && vbz_simd::usable()) {
        uint32_t r = vbz_simd::decode_16z(src, src_size, dst, count);
        if (r == UINT32_MAX) return VBZ_STREAMVBYTE_STREAM_ERROR;
        return dst_size;
    }
#endif
    std::vector<uint32_t> values(count);
    vbz_size_t r = (o->vbz_version == 1 && o->integer_size == 1)
        ? svb1_decode(src, src_size, values.data(), count)
        : svb0_decode(src, src_size, values.data(), count);
    if (vbz_is_error(r)) return r;
    values_to_output(values.data(), count, o->integer_size,
                     o->perform_delta_zig_zag, dst);
    return dst_size;
}

}  // namespace

// ---------------------------------------------------------------------------
// Public C ABI (mirrors vbz/vbz.h)
// ---------------------------------------------------------------------------

extern "C" {

bool vbz_is_error(vbz_size_t v) { return v >= VBZ_FIRST_ERROR; }

const char* vbz_error_string(vbz_size_t e) {
    switch (e) {
        case VBZ_ZSTD_ERROR: return "VBZ_ZSTD_ERROR";
        case VBZ_INPUT_SIZE_ERROR: return "VBZ_INPUT_SIZE_ERROR";
        case VBZ_INTEGER_SIZE_ERROR: return "VBZ_INTEGER_SIZE_ERROR";
        case VBZ_DESTINATION_SIZE_ERROR: return "VBZ_DESTINATION_SIZE_ERROR";
        case VBZ_STREAMVBYTE_STREAM_ERROR: return "VBZ_STREAMVBYTE_STREAM_ERROR";
        case VBZ_VERSION_ERROR: return "VBZ_VERSION_ERROR";
        case VBZ_OUT_OF_MEMORY_ERROR: return "VBZ_OUT_OF_MEMORY_ERROR";
        default: return "VBZ_UNKNOWN_ERROR";
    }
}

vbz_size_t vbz_max_compressed_size(vbz_size_t source_size,
                                   const CompressionOptions* options) {
    if (!valid_integer_size(options)) return VBZ_INTEGER_SIZE_ERROR;
    vbz_size_t max_size = source_size;
    if (options->integer_size != 0) {
        if (options->vbz_version > 1) return VBZ_VERSION_ERROR;
        if (source_size % options->integer_size != 0)
            return VBZ_INPUT_SIZE_ERROR;
        max_size = svb_bound(source_size / options->integer_size);
    }
    if (options->zstd_compression_level != 0)
        max_size = static_cast<vbz_size_t>(ZSTD_compressBound(max_size));
    return max_size + kSizedHeaderBytes;
}

vbz_size_t vbz_compress(const void* source, vbz_size_t source_size,
                        void* destination, vbz_size_t destination_capacity,
                        const CompressionOptions* options) {
    if (!valid_integer_size(options)) return VBZ_INTEGER_SIZE_ERROR;
    const uint8_t* src = static_cast<const uint8_t*>(source);
    uint8_t* dst = static_cast<uint8_t*>(destination);

    if (options->zstd_compression_level == 0 && options->integer_size == 0) {
        if (source_size > destination_capacity)
            return VBZ_DESTINATION_SIZE_ERROR;
        std::memcpy(dst, src, source_size);
        return source_size;
    }

    // Uninitialized malloc, not a zeroing vector: the bound is ~4.25x the
    // input and zero-filling it dominated the zstd stage (the svb stage
    // writes only the compressed prefix).
    std::unique_ptr<uint8_t[], decltype(&std::free)> intermediate(
        nullptr, &std::free);
    const uint8_t* cur = src;
    vbz_size_t cur_size = source_size;

    if (options->integer_size != 0) {
        if (options->vbz_version > 1) return VBZ_VERSION_ERROR;
        if (source_size % options->integer_size != 0)
            return VBZ_INPUT_SIZE_ERROR;
        vbz_size_t bound = svb_bound(source_size / options->integer_size);
        uint8_t* stage_dst = dst;
        vbz_size_t stage_cap = destination_capacity;
        if (options->zstd_compression_level != 0) {
            intermediate.reset(
                static_cast<uint8_t*>(std::malloc(bound)));
            if (!intermediate) return VBZ_OUT_OF_MEMORY_ERROR;
            stage_dst = intermediate.get();
            stage_cap = bound;
        } else if (bound > destination_capacity) {
            return VBZ_DESTINATION_SIZE_ERROR;
        }
        vbz_size_t r = svb_stage_compress(src, source_size, stage_dst,
                                          stage_cap, options);
        if (vbz_is_error(r)) return r;
        cur = stage_dst;
        cur_size = r;
    }

    if (options->zstd_compression_level == 0) return cur_size;

    size_t z = ZSTD_compress(dst, destination_capacity, cur, cur_size,
                             static_cast<int>(options->zstd_compression_level));
    if (ZSTD_isError(z)) return VBZ_ZSTD_ERROR;
    return static_cast<vbz_size_t>(z);
}

vbz_size_t vbz_decompress(const void* source, vbz_size_t source_size,
                          void* destination, vbz_size_t destination_size,
                          const CompressionOptions* options) {
    if (!valid_integer_size(options)) return VBZ_INTEGER_SIZE_ERROR;
    const uint8_t* src = static_cast<const uint8_t*>(source);
    uint8_t* dst = static_cast<uint8_t*>(destination);

    if (options->zstd_compression_level == 0 && options->integer_size == 0) {
        if (source_size > destination_size) return VBZ_DESTINATION_SIZE_ERROR;
        std::memcpy(dst, src, source_size);
        return source_size;
    }

    std::unique_ptr<uint8_t[], decltype(&std::free)> intermediate(
        nullptr, &std::free);
    const uint8_t* cur = src;
    vbz_size_t cur_size = source_size;

    if (options->zstd_compression_level != 0) {
        unsigned long long content =
            ZSTD_getFrameContentSize(src, source_size);
        if (content == ZSTD_CONTENTSIZE_ERROR ||
            content == ZSTD_CONTENTSIZE_UNKNOWN)
            return VBZ_ZSTD_ERROR;
        uint8_t* zdst = dst;
        size_t zcap = destination_size;
        if (options->integer_size != 0) {
            intermediate.reset(
                static_cast<uint8_t*>(std::malloc(content)));
            if (!intermediate) return VBZ_OUT_OF_MEMORY_ERROR;
            zdst = intermediate.get();
            zcap = content;
        } else if (content > destination_size) {
            return VBZ_DESTINATION_SIZE_ERROR;
        }
        size_t z = ZSTD_decompress(zdst, zcap, src, source_size);
        if (ZSTD_isError(z)) return VBZ_ZSTD_ERROR;
        cur = zdst;
        cur_size = static_cast<vbz_size_t>(z);
    }

    if (options->integer_size == 0) return cur_size;
    if (options->vbz_version > 1) return VBZ_VERSION_ERROR;
    return svb_stage_decompress(cur, cur_size, dst, destination_size, options);
}

vbz_size_t vbz_compress_sized(const void* source, vbz_size_t source_size,
                              void* destination,
                              vbz_size_t destination_capacity,
                              const CompressionOptions* options) {
    if (!valid_integer_size(options)) return VBZ_INTEGER_SIZE_ERROR;
    if (destination_capacity < kSizedHeaderBytes)
        return VBZ_DESTINATION_SIZE_ERROR;
    uint8_t* dst = static_cast<uint8_t*>(destination);
    uint32_t sz = source_size;  // little-endian store
    std::memcpy(dst, &sz, kSizedHeaderBytes);
    vbz_size_t r = vbz_compress(source, source_size, dst + kSizedHeaderBytes,
                                destination_capacity - kSizedHeaderBytes,
                                options);
    if (vbz_is_error(r)) return r;
    return r + kSizedHeaderBytes;
}

vbz_size_t vbz_decompressed_size(const void* source, vbz_size_t source_size,
                                 const CompressionOptions* options) {
    if (!valid_integer_size(options)) return VBZ_INTEGER_SIZE_ERROR;
    if (source_size < kSizedHeaderBytes) return VBZ_INPUT_SIZE_ERROR;
    uint32_t sz;
    std::memcpy(&sz, source, kSizedHeaderBytes);
    return sz;
}

vbz_size_t vbz_decompress_sized(const void* source, vbz_size_t source_size,
                                void* destination,
                                vbz_size_t destination_capacity,
                                const CompressionOptions* options) {
    vbz_size_t sz = vbz_decompressed_size(source, source_size, options);
    if (vbz_is_error(sz)) return sz;
    if (destination_capacity < sz) return VBZ_DESTINATION_SIZE_ERROR;
    const uint8_t* src = static_cast<const uint8_t*>(source);
    return vbz_decompress(src + kSizedHeaderBytes,
                          source_size - kSizedHeaderBytes, destination, sz,
                          options);
}

// ---------------------------------------------------------------------------
// LZ77 greedy matcher for the from-scratch zstd encoder (zstd_seq.py).
// Exact native counterpart of build_match_index + find_sequences: 17-bit
// Fibonacci hash of every little-endian 4-byte window, single-probe
// last-previous-occurrence chain, greedy scan with verified candidates.
// The Python lexsort index was 61% of the encoder's time (ROADMAP "Entropy
// stage"); these run the same semantics at C speed so the produced frames
// are byte-identical.
// ---------------------------------------------------------------------------

static inline uint32_t lz_load32(const uint8_t* p) {
    // Byte-composed so the window value matches the NumPy v4 path on any
    // host endianness (compiles to a single load on x86).
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
}

// prev[i] = most recent j < i with the same 17-bit hash, else -1;
// fills n - 3 entries (one per 4-byte window). Returns the entry count.
int64_t vbz_lz_match_index(const uint8_t* buf, int64_t n, int32_t* prev) {
    if (n < 4) return 0;
    const int64_t m = n - 3;
    const int hash_bits = 17;
    std::vector<int32_t> table(static_cast<size_t>(1) << hash_bits, -1);
    for (int64_t i = 0; i < m; ++i) {
        uint32_t h = (lz_load32(buf + i) * 2654435761u) >> (32 - hash_bits);
        prev[i] = table[h];
        table[h] = static_cast<int32_t>(i);
    }
    return m;
}

// Greedy sequence scan over [bstart, bend): for each verified candidate
// (prev[i] >= 0 and equal 4-byte windows) emit (lit_len, offset,
// match_len) and jump past the match. Returns the number of sequences
// written (each 3 consecutive int32s in seqs); seqs must hold
// 3 * ((bend - bstart) / 4 + 1) entries.
// Backward-read bitstream writer (zstd Huffman / FSE convention): values
// pushed LSB-first in forward order, closed with one 1 sentinel bit,
// padded to a byte. Counterpart of zstd_huff.pack_bits_backward /
// fse.BitWriter — the Python encoder's two hot packing loops.
namespace {
struct BitPush {
    uint8_t* out;
    int64_t cap;
    int64_t nbytes = 0;
    uint64_t acc = 0;
    int used = 0;
    bool ok = true;
    void push(uint64_t value, int nbits) {
        if (!nbits) return;
        acc |= (value & ((nbits >= 64 ? ~0ull : (1ull << nbits) - 1)))
               << used;
        used += nbits;
        while (used >= 8) {
            if (nbytes >= cap) { ok = false; return; }
            out[nbytes++] = static_cast<uint8_t>(acc);
            acc >>= 8;
            used -= 8;
        }
    }
    int64_t close() {
        push(1, 1);  // sentinel
        if (used) {
            if (nbytes >= cap) return -1;
            out[nbytes++] = static_cast<uint8_t>(acc);
            acc = 0;
            used = 0;
        }
        return ok ? nbytes : -1;
    }
};
}  // namespace

// Pack `n` Huffman codes (values < 2^16, lengths <= 16) in REVERSE input
// order, sentinel-closed. Returns bytes written, -1 on overflow.
int64_t vbz_bits_pack_backward(const uint16_t* codes, const uint8_t* nbits,
                               int64_t n, uint8_t* out, int64_t cap) {
    BitPush bw{out, cap};
    for (int64_t i = n - 1; i >= 0; --i) bw.push(codes[i], nbits[i]);
    return bw.close();
}

// One FSE channel's encode tables (fse.CTable, int32-narrowed).
struct vbz_fse_ctable {
    const int32_t* state_table;      // size 1 << accuracy_log
    const int32_t* delta_nb_bits;    // per symbol
    const int32_t* delta_find_state; // per symbol
    int32_t accuracy_log;
};

namespace {
struct FseState {
    const vbz_fse_ctable* ct;
    int32_t state = 0;
    void init(int32_t sym) {
        int32_t dnb = ct->delta_nb_bits[sym];
        int32_t nbits = (dnb + (1 << 15)) >> 16;
        int32_t sub = (nbits << 16) - dnb;
        state = ct->state_table[(sub >> nbits) + ct->delta_find_state[sym]];
    }
    void encode(int32_t sym, BitPush& bw) {
        int32_t nbits = (state + ct->delta_nb_bits[sym]) >> 16;
        bw.push(static_cast<uint32_t>(state), nbits);
        state = ct->state_table[(state >> nbits)
                                + ct->delta_find_state[sym]];
    }
    void flush(BitPush& bw) {
        bw.push(static_cast<uint32_t>(state), ct->accuracy_log);
    }
};
}  // namespace

// The interleaved sequences bitstream (zstd_seq.encode_sequences' tail):
// libzstd ZSTD_encodeSequences order — init states on the LAST sequence
// (ML, OF, LL), push its extras (LL, ML, OF), walk backwards encoding
// (OF, ML, LL states then LL, ML, OF extras), flush ML, OF, LL.
// Channel tables may be NULL (Predefined-with-RLE / absent channel —
// matches the Python `if xx_st:` guards). Returns bytes written.
int64_t vbz_zstd_seq_bitstream(
    int64_t n,
    const int32_t* llc, const int32_t* ll_extra, const int32_t* ll_bits,
    const int32_t* ofc, const int32_t* of_extra, const int32_t* of_bits,
    const int32_t* mlc, const int32_t* ml_extra, const int32_t* ml_bits,
    const vbz_fse_ctable* ll_ct, const vbz_fse_ctable* of_ct,
    const vbz_fse_ctable* ml_ct, uint8_t* out, int64_t cap) {
    if (n <= 0) return 0;
    BitPush bw{out, cap};
    FseState ll{ll_ct}, of{of_ct}, ml{ml_ct};
    if (ml_ct) ml.init(mlc[n - 1]);
    if (of_ct) of.init(ofc[n - 1]);
    if (ll_ct) ll.init(llc[n - 1]);
    bw.push(static_cast<uint32_t>(ll_extra[n - 1]), ll_bits[n - 1]);
    bw.push(static_cast<uint32_t>(ml_extra[n - 1]), ml_bits[n - 1]);
    bw.push(static_cast<uint32_t>(of_extra[n - 1]), of_bits[n - 1]);
    for (int64_t i = n - 2; i >= 0; --i) {
        if (of_ct) of.encode(ofc[i], bw);
        if (ml_ct) ml.encode(mlc[i], bw);
        if (ll_ct) ll.encode(llc[i], bw);
        bw.push(static_cast<uint32_t>(ll_extra[i]), ll_bits[i]);
        bw.push(static_cast<uint32_t>(ml_extra[i]), ml_bits[i]);
        bw.push(static_cast<uint32_t>(of_extra[i]), of_bits[i]);
    }
    if (ml_ct) ml.flush(bw);
    if (of_ct) of.flush(bw);
    if (ll_ct) ll.flush(bw);
    return bw.close();
}

// Length-limited canonical Huffman construction — the exact counterpart
// of zstd_huff._length_limited_lengths (package-merge with PYTHON TUPLE
// ordering: packages sorted by (weight, symbol-tuple lexicographic), so
// the produced lengths — and therefore the frame bytes — are identical
// to the NumPy encoder's) plus build_codes' canonical assignment.
// Returns max_bits, or 0 when fewer than two symbols are present.
int32_t vbz_huff_build_codes(const int64_t* freqs, int32_t max_code_bits,
                             uint8_t* nbits_out, uint16_t* code_out) {
    struct Pkg {
        int64_t w;
        std::vector<int16_t> syms;
        bool operator<(const Pkg& o) const {
            if (w != o.w) return w < o.w;
            return std::lexicographical_compare(
                syms.begin(), syms.end(), o.syms.begin(), o.syms.end());
        }
    };
    std::vector<int16_t> sym;
    for (int s = 0; s < 256; ++s)
        if (freqs[s] > 0) sym.push_back(static_cast<int16_t>(s));
    std::memset(nbits_out, 0, 256);
    std::memset(code_out, 0, 256 * sizeof(uint16_t));
    const size_t n = sym.size();
    if (n == 0) return 0;
    // n == 1: one present symbol gets a 1-bit code; report max_bits = 1
    // (the longest length actually assigned) so weight = max_bits + 1 -
    // nbits stays consistent for any caller that reaches this case.
    if (n == 1) { nbits_out[sym[0]] = 1; return 1; }

    std::vector<Pkg> items;
    items.reserve(n);
    for (int16_t s : sym) items.push_back({freqs[s], {s}});
    std::sort(items.begin(), items.end());
    std::vector<Pkg> merged = items;
    for (int32_t level = 0; level < max_code_bits - 1; ++level) {
        std::vector<Pkg> next = items;
        for (size_t i = 0; i + 1 < merged.size(); i += 2) {
            Pkg p;
            p.w = merged[i].w + merged[i + 1].w;
            p.syms = merged[i].syms;
            p.syms.insert(p.syms.end(), merged[i + 1].syms.begin(),
                          merged[i + 1].syms.end());
            next.push_back(std::move(p));
        }
        std::sort(next.begin(), next.end());
        merged = std::move(next);
    }
    for (size_t k = 0; k < 2 * n - 2 && k < merged.size(); ++k)
        for (int16_t s : merged[k].syms) ++nbits_out[s];

    int32_t max_bits = 0;
    for (int16_t s : sym)
        if (nbits_out[s] > max_bits) max_bits = nbits_out[s];
    // Canonical assignment: within a bit length, ascending symbol order;
    // moving to one bit shorter halves the next start.
    uint32_t cur = 0;
    for (int32_t bits = max_bits; bits > 0; --bits) {
        for (int s = 0; s < 256; ++s)
            if (nbits_out[s] == bits)
                code_out[s] = static_cast<uint16_t>(cur++);
        cur >>= 1;
    }
    return max_bits;
}

int64_t vbz_lz_sequences(const uint8_t* buf, int64_t n, int64_t bstart,
                         int64_t bend, const int32_t* prev, int32_t* seqs) {
    if (n < 4) return 0;
    const int64_t m = n - 3;
    int64_t hi = bend - 4 < m - 1 ? bend - 4 : m - 1;  // min(bend-4, m-1)
    int64_t count = 0, anchor = bstart;
    for (int64_t i = bstart; i <= hi;) {
        int32_t c = prev[i];
        if (c < 0 || lz_load32(buf + c) != lz_load32(buf + i)) {
            ++i;
            continue;
        }
        // Common prefix beyond the verified 4 bytes, capped like the
        // Python scan: min(bend - i, 131074).
        int64_t limit = bend - i < 131074 ? bend - i : 131074;
        int64_t ml = 4;
        while (ml < limit && buf[c + ml] == buf[i + ml]) ++ml;
        seqs[3 * count] = static_cast<int32_t>(i - anchor);
        seqs[3 * count + 1] = static_cast<int32_t>(i - c);
        seqs[3 * count + 2] = static_cast<int32_t>(ml);
        ++count;
        i += ml;
        anchor = i;
    }
    return count;
}

}  // extern "C"
