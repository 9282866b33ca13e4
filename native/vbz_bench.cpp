// Single-core CPU baseline benchmark for the native VBZ codec.
//
// Plays the role of the reference's google-benchmark harness
// (reference: vbz/perf/vbz_perf.cpp:145-171): times compress and decompress
// over a pseudo-signal workload (read lengths uniform in [30k, 200k) samples,
// matching vbz/perf/test_data_generator.h:28-74) and prints bytes/second.
// The measured single-core CPU baseline.

#include <chrono>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "vbz_native.h"

int main(int argc, char** argv) {
    // Usage: vbz_bench [TOTAL_MB] [ZSTD_LEVEL] [SIGNAL_FILE]
    size_t total_mb = argc > 1 ? std::strtoul(argv[1], nullptr, 10) : 64;
    int zstd_level = argc > 2 ? std::atoi(argv[2]) : 1;
    size_t total = total_mb << 20;

    std::vector<int16_t> signal;
    if (argc > 3) {  // shared workload from native/gen_signal
        FILE* f = std::fopen(argv[3], "rb");
        if (!f) { std::fprintf(stderr, "cannot open %s\n", argv[3]); return 2; }
        std::fseek(f, 0, SEEK_END);
        total = std::min<size_t>(std::ftell(f), total);
        std::fseek(f, 0, SEEK_SET);
        signal.resize(total / 2);
        if (std::fread(signal.data(), 1, total, f) != total) return 2;
        std::fclose(f);
        total_mb = total >> 20;
    } else {
        // Pseudo-signal: random-walk int16, like nanopore raw current
        // (same defaults as native/gen_signal.cpp).
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

    CompressionOptions opts{true, 2, static_cast<unsigned>(zstd_level), 0};
    vbz_size_t bound =
        vbz_max_compressed_size(static_cast<vbz_size_t>(total), &opts);
    std::vector<uint8_t> compressed(bound);
    std::vector<int16_t> out(signal.size());

    // Untimed warmup rep: first-touch page faults on the fresh output
    // buffer (~bound bytes) would otherwise dominate the averaged reps.
    vbz_size_t csize = vbz_compress_sized(signal.data(),
                                          static_cast<vbz_size_t>(total),
                                          compressed.data(), bound, &opts);
    if (vbz_is_error(csize)) return 1;
    vbz_size_t dsize0 = vbz_decompress_sized(
        compressed.data(), csize, out.data(),
        static_cast<vbz_size_t>(total), &opts);
    if (vbz_is_error(dsize0)) return 1;

    auto t0 = std::chrono::steady_clock::now();
    int reps = 3;
    for (int r = 0; r < reps; ++r) {
        csize = vbz_compress_sized(signal.data(),
                                   static_cast<vbz_size_t>(total),
                                   compressed.data(), bound, &opts);
        if (vbz_is_error(csize)) {
            std::fprintf(stderr, "compress error: %s\n",
                         vbz_error_string(csize));
            return 1;
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    double enc_s = std::chrono::duration<double>(t1 - t0).count() / reps;

    for (int r = 0; r < reps; ++r) {
        vbz_size_t dsize = vbz_decompress_sized(
            compressed.data(), csize, out.data(),
            static_cast<vbz_size_t>(total), &opts);
        if (vbz_is_error(dsize) || dsize != total) {
            std::fprintf(stderr, "decompress error\n");
            return 1;
        }
    }
    auto t2 = std::chrono::steady_clock::now();
    double dec_s = std::chrono::duration<double>(t2 - t1).count() / reps;

    if (std::memcmp(signal.data(), out.data(), total) != 0) {
        std::fprintf(stderr, "round-trip mismatch\n");
        return 1;
    }

    std::printf(
        "{\"workload_mb\": %zu, \"zstd_level\": %d, "
        "\"ratio\": %.4f, \"encode_gb_s\": %.4f, \"decode_gb_s\": %.4f}\n",
        total_mb, zstd_level, double(csize) / double(total),
        total / enc_s / 1e9, total / dec_s / 1e9);
    return 0;
}
