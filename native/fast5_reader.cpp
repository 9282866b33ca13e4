// Native fast5 chunk iterator — dlopen-late-bound HDF5, no build-time dep.
//
// Reads raw (still-compressed) HDF5 chunks of fast5 signal datasets plus the
// filter metadata needed to decode them, feeding the codec's bulk corpus
// path without h5py in the loop. The late-binding approach mirrors the
// reference's (dead) vbz_plugin/hdf5_dynamic.h shim — here it is the live
// production reader; the library path is supplied by the Python wrapper
// (which locates h5py's bundled libhdf5) or defaults to the system soname.
//
// C ABI (all functions return <0 / NULL on failure):
//   f5r_init(libpath)                      load libhdf5 (NULL → defaults)
//   f5r_open(path) / f5r_close(f)          file handles
//   f5r_signal_names(f, buf, cap)          '\n'-joined "read_*/Raw/Signal"
//   f5r_dataset_info(f, name, ...)         element count, filter id + params
//   f5r_chunk_count(f, name)
//   f5r_chunk_info(f, name, idx, ...)      stored size + logical offset
//   f5r_read_chunk(f, name, idx, buf, cap) raw chunk bytes (pre-filter)

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

using hid_t = int64_t;
using herr_t = int;
using hsize_t = unsigned long long;
using haddr_t = uint64_t;

namespace {

struct H5Api {
    void *lib = nullptr;
    hid_t (*Fopen)(const char *, unsigned, hid_t) = nullptr;
    herr_t (*Fclose)(hid_t) = nullptr;
    hid_t (*Dopen2)(hid_t, const char *, hid_t) = nullptr;
    herr_t (*Dclose)(hid_t) = nullptr;
    hid_t (*Dget_space)(hid_t) = nullptr;
    int (*Sget_simple_extent_dims)(hid_t, hsize_t *, hsize_t *) = nullptr;
    herr_t (*Sclose)(hid_t) = nullptr;
    hid_t (*Dget_create_plist)(hid_t) = nullptr;
    int (*Pget_nfilters)(hid_t) = nullptr;
    int (*Pget_filter2)(hid_t, unsigned, unsigned *, size_t *, unsigned *,
                        size_t, char *, unsigned *) = nullptr;
    herr_t (*Pclose)(hid_t) = nullptr;
    herr_t (*Dget_num_chunks)(hid_t, hid_t, hsize_t *) = nullptr;
    herr_t (*Dget_chunk_info)(hid_t, hid_t, hsize_t, hsize_t *, unsigned *,
                              haddr_t *, hsize_t *) = nullptr;
    herr_t (*Dread_chunk)(hid_t, hid_t, const hsize_t *, unsigned *,
                          void *) = nullptr;
    herr_t (*Literate)(hid_t, int, int, hsize_t *,
                       herr_t (*)(hid_t, const char *, const void *, void *),
                       void *) = nullptr;
    herr_t (*Eset_auto2)(hid_t, void *, void *) = nullptr;
    int (*Lexists_)(hid_t, const char *, hid_t) = nullptr;
};

H5Api g_api;

template <typename T>
bool bind(void *lib, const char *name, T &fn) {
    fn = reinterpret_cast<T>(dlsym(lib, name));
    return fn != nullptr;
}

// Versioned symbols: 1.14 exports H5Literate2 (the H5Literate name is gone);
// the info struct is opaque to us, so either ABI works.
template <typename T>
bool bind2(void *lib, const char *n1, const char *n2, T &fn) {
    return bind(lib, n1, fn) || bind(lib, n2, fn);
}

bool load_lib(const char *path) {
    const char *candidates[] = {
        path,
        "libhdf5_serial.so.103",
        "libhdf5.so.310",
        "libhdf5.so.200",
        "libhdf5.so",
        nullptr,
    };
    for (const char *c : candidates) {
        if (!c) continue;
        void *lib = dlopen(c, RTLD_NOW | RTLD_GLOBAL);
        if (lib) {
            g_api.lib = lib;
            return true;
        }
    }
    return false;
}

}  // namespace

extern "C" {

int f5r_init(const char *libpath) {
    if (g_api.lib) return 0;
    if (!load_lib(libpath)) return -1;
    void *lib = g_api.lib;
    bool ok = bind(lib, "H5Fopen", g_api.Fopen) &&
              bind(lib, "H5Fclose", g_api.Fclose) &&
              bind(lib, "H5Dopen2", g_api.Dopen2) &&
              bind(lib, "H5Dclose", g_api.Dclose) &&
              bind(lib, "H5Dget_space", g_api.Dget_space) &&
              bind(lib, "H5Sget_simple_extent_dims",
                   g_api.Sget_simple_extent_dims) &&
              bind(lib, "H5Sclose", g_api.Sclose) &&
              bind(lib, "H5Dget_create_plist", g_api.Dget_create_plist) &&
              bind(lib, "H5Pget_nfilters", g_api.Pget_nfilters) &&
              bind(lib, "H5Pget_filter2", g_api.Pget_filter2) &&
              bind(lib, "H5Pclose", g_api.Pclose) &&
              bind(lib, "H5Dget_num_chunks", g_api.Dget_num_chunks) &&
              bind(lib, "H5Dget_chunk_info", g_api.Dget_chunk_info) &&
              bind(lib, "H5Dread_chunk", g_api.Dread_chunk) &&
              bind2(lib, "H5Literate2", "H5Literate", g_api.Literate) &&
              bind(lib, "H5Lexists", g_api.Lexists_);
    if (!ok) return -2;
    // Quiet the default error stack (we report via return codes).
    if (bind(lib, "H5Eset_auto2", g_api.Eset_auto2)) {
        g_api.Eset_auto2(0 /*H5E_DEFAULT*/, nullptr, nullptr);
    }
    return 0;
}

int64_t f5r_open(const char *path) {
    if (!g_api.lib && f5r_init(nullptr) != 0) return -1;
    hid_t f = g_api.Fopen(path, 0 /*H5F_ACC_RDONLY*/, 0 /*H5P_DEFAULT*/);
    return f < 0 ? -1 : f;
}

int f5r_close(int64_t f) { return g_api.Fclose(f) < 0 ? -1 : 0; }

namespace {
struct NameAcc {
    std::vector<std::string> names;
};

herr_t root_link_cb(hid_t, const char *name, const void *, void *op) {
    static_cast<NameAcc *>(op)->names.emplace_back(name);
    return 0;
}
}  // namespace

// Writes '\n'-joined dataset paths of per-read signals into buf; returns the
// number of names (or <0). Handles multi-read ("read_*/Raw/Signal") and
// single-read ("Raw/Reads/<read>/Signal") fast5 layouts.
int f5r_signal_names(int64_t f, char *buf, size_t cap) {
    NameAcc acc;
    hsize_t idx = 0;
    if (g_api.Literate(f, 0 /*H5_INDEX_NAME*/, 0 /*H5_ITER_INC*/, &idx,
                       root_link_cb, &acc) < 0) {
        return -1;
    }
    std::string out;
    int count = 0;
    auto add = [&](const std::string &path) {
        if (g_api.Lexists_(f, path.c_str(), 0) > 0) {
            if (!out.empty()) out += '\n';
            out += path;
            ++count;
        }
    };
    for (const auto &n : acc.names) {
        add(n + "/Raw/Signal");
    }
    // Single-read layout: Raw/Reads/Read_<n>/Signal. The per-read group
    // names are not enumerable without a group handle API; probe the
    // common Read_<n> names directly.
    if (count == 0 && g_api.Lexists_(f, "Raw", 0) > 0) {
        for (int i = 0; i < 4096 && count == 0; ++i) {
            add("Raw/Reads/Read_" + std::to_string(i) + "/Signal");
        }
    }
    if (out.size() + 1 > cap) return -2;
    std::memcpy(buf, out.c_str(), out.size() + 1);
    return count;
}

// nelems: logical element count; cd buffer receives the LAST filter's
// params (fast5 signal datasets have a single vbz/gzip filter).
int f5r_dataset_info(int64_t f, const char *name, int64_t *nelems,
                     int *filter_id, unsigned *cd_values, int *n_cd) {
    hid_t d = g_api.Dopen2(f, name, 0);
    if (d < 0) return -1;
    hid_t sp = g_api.Dget_space(d);
    hsize_t dims[4] = {0, 0, 0, 0};
    int nd = g_api.Sget_simple_extent_dims(sp, dims, nullptr);
    int64_t n = nd >= 1 ? static_cast<int64_t>(dims[0]) : 0;
    for (int i = 1; i < nd; ++i) n *= static_cast<int64_t>(dims[i]);
    g_api.Sclose(sp);
    *nelems = n;
    hid_t pl = g_api.Dget_create_plist(d);
    int nf = g_api.Pget_nfilters(pl);
    *filter_id = -1;
    *n_cd = 0;
    for (int i = 0; i < nf; ++i) {
        unsigned flags = 0, filter_config = 0;
        size_t cd_n = 16;
        unsigned cd[16] = {0};
        char fname[64] = {0};
        int fid = g_api.Pget_filter2(pl, static_cast<unsigned>(i), &flags,
                                     &cd_n, cd, sizeof fname, fname,
                                     &filter_config);
        if (fid < 0) break;
        *filter_id = fid;
        *n_cd = static_cast<int>(cd_n > 16 ? 16 : cd_n);
        for (int k = 0; k < *n_cd; ++k) cd_values[k] = cd[k];
    }
    g_api.Pclose(pl);
    g_api.Dclose(d);
    return 0;
}

int64_t f5r_chunk_count(int64_t f, const char *name) {
    hid_t d = g_api.Dopen2(f, name, 0);
    if (d < 0) return -1;
    hsize_t n = 0;
    herr_t rc = g_api.Dget_num_chunks(d, 0 /*H5S_ALL*/, &n);
    g_api.Dclose(d);
    return rc < 0 ? -1 : static_cast<int64_t>(n);
}

// stored_size: on-disk (compressed) bytes; logical_offset: chunk's first
// element index; filter_mask: skipped-filter bits (0 → all filters applied).
int f5r_chunk_info(int64_t f, const char *name, int64_t idx,
                   int64_t *stored_size, int64_t *logical_offset,
                   unsigned *filter_mask) {
    hid_t d = g_api.Dopen2(f, name, 0);
    if (d < 0) return -1;
    hsize_t off[4] = {0, 0, 0, 0};
    unsigned mask = 0;
    haddr_t addr = 0;
    hsize_t size = 0;
    herr_t rc = g_api.Dget_chunk_info(d, 0, static_cast<hsize_t>(idx), off,
                                      &mask, &addr, &size);
    g_api.Dclose(d);
    if (rc < 0) return -1;
    *stored_size = static_cast<int64_t>(size);
    *logical_offset = static_cast<int64_t>(off[0]);
    *filter_mask = mask;
    return 0;
}

// Reads the raw (compressed) chunk bytes; returns bytes written or <0.
int64_t f5r_read_chunk(int64_t f, const char *name, int64_t idx, void *buf,
                       int64_t cap, unsigned *filter_mask) {
    int64_t stored = 0, loff = 0;
    unsigned mask = 0;
    if (f5r_chunk_info(f, name, idx, &stored, &loff, &mask) < 0) return -1;
    if (stored > cap) return -2;
    hid_t d = g_api.Dopen2(f, name, 0);
    if (d < 0) return -1;
    hid_t sp = g_api.Dget_space(d);
    hsize_t dims[4] = {0};
    g_api.Sget_simple_extent_dims(sp, dims, nullptr);
    g_api.Sclose(sp);
    hsize_t off[4] = {static_cast<hsize_t>(loff), 0, 0, 0};
    unsigned m2 = 0;
    herr_t rc = g_api.Dread_chunk(d, 0 /*H5P_DEFAULT*/, off, &m2, buf);
    g_api.Dclose(d);
    if (rc < 0) return -1;
    *filter_mask = m2;
    return stored;
}

}  // extern "C"
