// Native text IO for the .thrm/.traj formats (the port's copy of
// neuralmelting_tpu/io/native/nm_textio.cpp, byte for byte the same code).
//
// Python float formatting tops out around 1-2 MB/s, which throttles
// trajectory dumps of large replica grids, so this small C++ library does
// bulk %.9e formatting and strtof parsing. Exposed through ctypes
// (neuralmelting_tpu_torch/io/native/__init__.py); byte-identical to the
// Python writers (tests/test_torch_native_io.py).
//
// Build (io/native/__init__.py does it at first use, into build/):
//   g++ -O3 -shared -fPIC nm_textio.cpp -o libnm_textio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {
constexpr long kBuf = 1 << 20;

struct File {
    FILE* f = nullptr;
    char* buf = nullptr;
    explicit File(const char* path, const char* mode) {
        f = std::fopen(path, mode);
        if (f) {
            buf = static_cast<char*>(std::malloc(kBuf));
            if (buf) std::setvbuf(f, buf, _IOFBF, kBuf);
        }
    }
    ~File() {
        if (f) std::fclose(f);
        std::free(buf);
    }
};
}  // namespace

extern "C" {

// positions (nframes*natoms*3), boxes (nframes*3), sweeps (nframes)
int nm_write_traj(const char* path, int append, long nframes, long natoms,
                  const float* pos, const float* boxes, const long* sweeps) {
    File fp(path, append ? "a" : "w");
    if (!fp.f) return -1;
    if (!append) std::fprintf(fp.f, "# nm-traj-1\n");
    for (long k = 0; k < nframes; ++k) {
        const float* b = boxes + 3 * k;
        std::fprintf(fp.f, "%ld %.9e %.9e %.9e %ld\n", natoms,
                     static_cast<double>(b[0]), static_cast<double>(b[1]),
                     static_cast<double>(b[2]), sweeps ? sweeps[k] : 0L);
        const float* p = pos + 3 * natoms * k;
        for (long i = 0; i < natoms; ++i, p += 3) {
            std::fprintf(fp.f, "%.9e %.9e %.9e\n",
                         static_cast<double>(p[0]),
                         static_cast<double>(p[1]),
                         static_cast<double>(p[2]));
        }
    }
    return 0;
}

// First pass: count frames/atoms. Returns 0 on success.
int nm_scan_traj(const char* path, long* nframes, long* natoms) {
    File fp(path, "r");
    if (!fp.f) return -1;
    char line[512];
    if (!std::fgets(line, sizeof line, fp.f)) return -2;
    if (std::strncmp(line, "# nm-traj-1", 11) != 0) return -3;
    long frames = 0, atoms = 0;
    while (std::fgets(line, sizeof line, fp.f)) {
        if (line[0] == '\n') continue;
        char* end = nullptr;
        long na = std::strtol(line, &end, 10);
        if (end == line || na <= 0) return -4;
        if (atoms == 0) atoms = na;
        if (na != atoms) return -5;
        for (long i = 0; i < na; ++i) {
            if (!std::fgets(line, sizeof line, fp.f)) return -6;
        }
        ++frames;
    }
    *nframes = frames;
    *natoms = atoms;
    return 0;
}

// Second pass: fill caller-allocated buffers.
int nm_read_traj(const char* path, long nframes, long natoms, float* pos,
                 float* boxes, long* sweeps) {
    File fp(path, "r");
    if (!fp.f) return -1;
    char line[512];
    if (!std::fgets(line, sizeof line, fp.f)) return -2;
    for (long k = 0; k < nframes; ++k) {
        if (!std::fgets(line, sizeof line, fp.f)) return -6;
        char* s = line;
        char* end = nullptr;
        std::strtol(s, &end, 10);
        s = end;
        float* b = boxes + 3 * k;
        for (int c = 0; c < 3; ++c) {
            b[c] = std::strtof(s, &end);
            s = end;
        }
        sweeps[k] = std::strtol(s, &end, 10);
        float* p = pos + 3 * natoms * k;
        for (long i = 0; i < natoms; ++i, p += 3) {
            if (!std::fgets(line, sizeof line, fp.f)) return -6;
            s = line;
            p[0] = std::strtof(s, &end); s = end;
            p[1] = std::strtof(s, &end); s = end;
            p[2] = std::strtof(s, &end);
        }
    }
    return 0;
}

// thermo rows: first column integer sweep, remaining %.9e.
// data is row-major (nrec, ncol) float64; header written verbatim if not
// appending (may be empty).
int nm_write_thermo(const char* path, int append, long nrec, long ncol,
                    const double* data, const char* header) {
    File fp(path, append ? "a" : "w");
    if (!fp.f) return -1;
    if (!append && header && header[0]) std::fputs(header, fp.f);
    for (long r = 0; r < nrec; ++r) {
        const double* row = data + ncol * r;
        std::fprintf(fp.f, "%ld", static_cast<long>(row[0]));
        for (long c = 1; c < ncol; ++c) std::fprintf(fp.f, " %.9e", row[c]);
        std::fputc('\n', fp.f);
    }
    return 0;
}

}  // extern "C"
