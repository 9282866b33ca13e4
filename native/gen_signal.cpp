// Shared workload generator: every benchmark (bench.py, native/vbz_bench,
// native/ref_bench) must time the IDENTICAL byte stream, so the pseudo-signal
// is generated once here and loaded from file everywhere.
//
// Matches the reference perf harness's intent (vbz/perf/test_data_generator.h:
// pseudo-signal reads): an int16 random walk that RESETS to the midpoint when
// it leaves [lo, hi]. (An earlier bench.py used np.clip instead of a reset —
// the walk pinned at the bounds for most samples, making the device workload
// near-constant while the CPU baseline got realistic data.)
//
// Usage: gen_signal OUT_FILE TOTAL_MB [SIGMA=12] [LO=0] [HI=2000] [SEED=42]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

int main(int argc, char** argv) {
    if (argc < 3) {
        std::fprintf(stderr,
                     "usage: %s OUT TOTAL_MB [SIGMA] [LO] [HI] [SEED]\n",
                     argv[0]);
        return 2;
    }
    const char* path = argv[1];
    size_t total = std::strtoul(argv[2], nullptr, 10) << 20;
    float sigma = argc > 3 ? std::atof(argv[3]) : 12.f;
    long lo = argc > 4 ? std::atol(argv[4]) : 0;
    long hi = argc > 5 ? std::atol(argv[5]) : 2000;
    unsigned seed = argc > 6 ? std::atoi(argv[6]) : 42;

    std::mt19937 rng(seed);
    std::normal_distribution<float> step(0.f, sigma);
    std::vector<int16_t> signal(total / 2);
    float mid = 0.5f * (lo + hi);
    float acc = mid;
    for (auto& s : signal) {
        acc += step(rng);
        if (acc < lo || acc > hi) acc = mid;
        s = static_cast<int16_t>(acc);
    }

    FILE* f = std::fopen(path, "wb");
    if (!f || std::fwrite(signal.data(), 1, total, f) != total) {
        std::fprintf(stderr, "write failed: %s\n", path);
        return 1;
    }
    std::fclose(f);
    return 0;
}
