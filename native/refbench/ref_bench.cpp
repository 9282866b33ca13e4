// Honest CPU baseline: the REFERENCE's own codec, compiled from
// /root/reference/vbz (vbz.cpp + v0/v1 streamvbyte workers, -O3 -mssse3),
// timed on the exact workload bench.py and native/vbz_bench use.
//
// Two tiers are measured (mirroring the reference's perf harness configs,
// vbz/perf/vbz_perf.cpp:145-171):
//   - svb:  the StreamVByte stage only (zstd level 0) — int16 + zigzag runs
//           the reference's hand-vectorized SSSE3 hot path
//           (vbz/v0/vbz_streamvbyte_impl_sse3.h:403-660).
//   - pipe: the full pipeline (svb + zstd level 1), vbz_compress_sized /
//           vbz_decompress_sized — what the HDF5 plugin actually executes
//           per chunk (vbz_plugin/vbz_plugin.cpp:150-229).
//
// Output: one JSON line with GB/s per tier (uncompressed bytes / wall time).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "vbz.h"

namespace {

double time_reps(int reps, vbz_size_t (*fn)(const void*, vbz_size_t, void*,
                                            vbz_size_t,
                                            CompressionOptions const*),
                 const void* src, vbz_size_t src_size, void* dst,
                 vbz_size_t dst_cap, CompressionOptions const* opts,
                 vbz_size_t* out_size) {
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
        vbz_size_t sz = fn(src, src_size, dst, dst_cap, opts);
        if (vbz_is_error(sz)) {
            std::fprintf(stderr, "vbz error: %s\n", vbz_error_string(sz));
            std::exit(1);
        }
        *out_size = sz;
    }
    auto t1 = std::chrono::steady_clock::now();
    return std::chrono::duration<double>(t1 - t0).count() / reps;
}

}  // namespace

int main(int argc, char** argv) {
    // Usage: ref_bench [TOTAL_MB] [SIGNAL_FILE]
    // With SIGNAL_FILE (written by native/gen_signal), the workload is the
    // byte-identical stream the other benchmarks time.
    size_t total_mb = argc > 1 ? std::strtoul(argv[1], nullptr, 10) : 64;
    size_t total = total_mb << 20;
    std::vector<int16_t> signal;
    if (argc > 2) {
        FILE* f = std::fopen(argv[2], "rb");
        if (!f) {
            std::fprintf(stderr, "cannot open %s\n", argv[2]);
            return 2;
        }
        std::fseek(f, 0, SEEK_END);
        total = std::min<size_t>(std::ftell(f), total);
        std::fseek(f, 0, SEEK_SET);
        signal.resize(total / 2);
        if (std::fread(signal.data(), 1, total, f) != total) {
            std::fprintf(stderr, "short read: %s\n", argv[2]);
            return 2;
        }
        std::fclose(f);
        total_mb = total >> 20;
    } else {
        // Self-contained fallback: same generator as native/gen_signal.cpp
        // defaults (mt19937(42), sigma 12, reset-to-midpoint on [0,2000]).
        std::mt19937 rng(42);
        std::normal_distribution<float> step(0.f, 12.f);
        signal.resize(total / 2);
        float acc = 1000.f;
        for (auto& s : signal) {
            acc += step(rng);
            if (acc < 0 || acc > 2000) acc = 1000.f;
            s = static_cast<int16_t>(acc);
        }
    }

    std::vector<int16_t> out(signal.size());
    const int reps = 3;
    double enc_svb_s, dec_svb_s, enc_pipe_s, dec_pipe_s;
    vbz_size_t svb_size = 0, pipe_size = 0, dsz = 0;

    {  // svb stage only: zstd level 0.
        CompressionOptions opts{true, 2, 0, 0};
        vbz_size_t bound =
            vbz_max_compressed_size(static_cast<vbz_size_t>(total), &opts);
        std::vector<uint8_t> comp(bound);
        // Untimed warmup rep (first-touch page faults on the fresh buffer).
        time_reps(1, vbz_compress, signal.data(),
                  static_cast<vbz_size_t>(total), comp.data(), bound, &opts,
                  &svb_size);
        enc_svb_s = time_reps(reps, vbz_compress, signal.data(),
                              static_cast<vbz_size_t>(total), comp.data(),
                              bound, &opts, &svb_size);
        dec_svb_s = time_reps(
            reps,
            [](const void* s, vbz_size_t ss, void* d, vbz_size_t dc,
               CompressionOptions const* o) {
                return vbz_decompress(s, ss, d, dc, o);
            },
            comp.data(), svb_size, out.data(),
            static_cast<vbz_size_t>(total), &opts, &dsz);
        if (dsz != total ||
            std::memcmp(signal.data(), out.data(), total) != 0) {
            std::fprintf(stderr, "svb round-trip mismatch\n");
            return 1;
        }
    }

    {  // full pipeline: svb + zstd level 1, sized framing.
        CompressionOptions opts{true, 2, 1, 0};
        vbz_size_t bound =
            vbz_max_compressed_size(static_cast<vbz_size_t>(total), &opts);
        std::vector<uint8_t> comp(bound);
        time_reps(1, vbz_compress_sized, signal.data(),  // untimed warmup
                  static_cast<vbz_size_t>(total), comp.data(), bound, &opts,
                  &pipe_size);
        enc_pipe_s = time_reps(reps, vbz_compress_sized, signal.data(),
                               static_cast<vbz_size_t>(total), comp.data(),
                               bound, &opts, &pipe_size);
        std::memset(out.data(), 0, total);
        dec_pipe_s = time_reps(reps, vbz_decompress_sized, comp.data(),
                               pipe_size, out.data(),
                               static_cast<vbz_size_t>(total), &opts, &dsz);
        if (dsz != total ||
            std::memcmp(signal.data(), out.data(), total) != 0) {
            std::fprintf(stderr, "pipe round-trip mismatch\n");
            return 1;
        }
    }

    std::printf(
        "{\"workload_mb\": %zu, "
        "\"svb_encode_gb_s\": %.4f, \"svb_decode_gb_s\": %.4f, "
        "\"pipe_encode_gb_s\": %.4f, \"pipe_decode_gb_s\": %.4f, "
        "\"svb_ratio\": %.4f, \"pipe_ratio\": %.4f}\n",
        total_mb, total / enc_svb_s / 1e9, total / dec_svb_s / 1e9,
        total / enc_pipe_s / 1e9, total / dec_pipe_s / 1e9,
        double(svb_size) / double(total), double(pipe_size) / double(total));
    return 0;
}
