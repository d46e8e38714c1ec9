// Native host-side engine: counter-based generation on CPU.
//
// An independent C++ implementation of the framework's sampling semantics
// (Philox4x32-10 streams, counter-addressed dense fill, repeated
// Fisher-Yates), compiled with OpenMP. Roles:
//   1. fast host-side generation for data prep / test oracles (the JAX CPU
//      path pays XLA dispatch overhead for small fills),
//   2. an independent cross-check of the JAX/Pallas implementations: two
//      implementations agreeing at the uint32 level pins the stream
//      contract (tests/test_native.py).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: make -C native  (produces librandblas_host.so)

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

constexpr uint32_t M4_0 = 0xD2511F53u;
constexpr uint32_t M4_1 = 0xCD9E8D57u;
constexpr uint32_t W_0 = 0x9E3779B9u;
constexpr uint32_t W_1 = 0xBB67AE85u;

struct Ctr4 {
    uint32_t v[4];
};

inline Ctr4 ctr_add64(const Ctr4 &c, uint64_t n) {
    Ctr4 r = c;
    uint64_t lo = (uint64_t)r.v[0] + (n & 0xFFFFFFFFull);
    r.v[0] = (uint32_t)lo;
    uint64_t c1 = (uint64_t)r.v[1] + (n >> 32) + (lo >> 32);
    r.v[1] = (uint32_t)c1;
    uint64_t c2 = (uint64_t)r.v[2] + (c1 >> 32);
    r.v[2] = (uint32_t)c2;
    r.v[3] += (uint32_t)(c2 >> 32);
    return r;
}

inline void philox4x32_block(const Ctr4 &ctr, uint32_t k0, uint32_t k1,
                             int rounds, uint32_t out[4]) {
    uint32_t x0 = ctr.v[0], x1 = ctr.v[1], x2 = ctr.v[2], x3 = ctr.v[3];
    for (int r = 0; r < rounds; ++r) {
        if (r > 0) {
            k0 += W_0;
            k1 += W_1;
        }
        uint64_t p0 = (uint64_t)M4_0 * x0;
        uint64_t p1 = (uint64_t)M4_1 * x2;
        uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
        uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
        x0 = hi1 ^ x1 ^ k0;
        x1 = lo1;
        x2 = hi0 ^ x3 ^ k1;
        x3 = lo0;
    }
    out[0] = x0;
    out[1] = x1;
    out[2] = x2;
    out[3] = x3;
}

constexpr uint32_t TF_PARITY = 0x1BD11BDAu;
constexpr int TF_R0[8] = {10, 11, 13, 23, 6, 17, 25, 18};
constexpr int TF_R2[8] = {26, 21, 27, 5, 20, 11, 10, 20};

inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

inline void threefry4x32_block(const Ctr4 &ctr, const uint32_t key[4],
                               int rounds, uint32_t out[4]) {
    uint32_t ks[5] = {key[0], key[1], key[2], key[3],
                      TF_PARITY ^ key[0] ^ key[1] ^ key[2] ^ key[3]};
    uint32_t x[4];
    for (int i = 0; i < 4; ++i)
        x[i] = ctr.v[i] + ks[i];
    for (int r = 0; r < rounds; ++r) {
        int r0 = TF_R0[r % 8], r2 = TF_R2[r % 8];
        if (r % 2 == 0) {
            x[0] += x[1]; x[1] = rotl32(x[1], r0) ^ x[0];
            x[2] += x[3]; x[3] = rotl32(x[3], r2) ^ x[2];
        } else {
            x[0] += x[3]; x[3] = rotl32(x[3], r0) ^ x[0];
            x[2] += x[1]; x[1] = rotl32(x[1], r2) ^ x[2];
        }
        if ((r + 1) % 4 == 0) {
            int s = (r + 1) / 4;
            for (int i = 0; i < 4; ++i)
                x[i] += ks[(s + i) % 5];
            x[3] += (uint32_t)s;
        }
    }
    for (int i = 0; i < 4; ++i)
        out[i] = x[i];
}

// ---------------------------------------------------------------------------
// 64-bit CBRNG variants. JAX runs without x64 mode, so these live only
// in the host engine; they close the reference's Random123 x64 surface
// (vendored Random123 philox.h/threefry.h; KAT vectors replayed in
// tests/test_rng_kat.py). All constants are the published Random123
// algorithm parameters (golden-ratio/sqrt-2 Weyl words, Threefish rotation
// tables).
// ---------------------------------------------------------------------------

constexpr uint64_t P2x64_M = 0xD2B74407B1CE6E93ull;
constexpr uint64_t P64_W0 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t P64_W1 = 0xBB67AE8584CAA73Bull;
constexpr uint64_t P4x64_M0 = 0xD2E7470EE14C6C93ull;
constexpr uint64_t P4x64_M1 = 0xCA5A826395121157ull;

inline void mul64_wide(uint64_t a, uint64_t b, uint64_t *hi, uint64_t *lo) {
    unsigned __int128 p = (unsigned __int128)a * b;
    *hi = (uint64_t)(p >> 64);
    *lo = (uint64_t)p;
}

inline void philox2x64_block(const uint64_t ctr[2], const uint64_t key[1],
                             int rounds, uint64_t out[2]) {
    uint64_t x0 = ctr[0], x1 = ctr[1], k0 = key[0];
    for (int r = 0; r < rounds; ++r) {
        if (r > 0) k0 += P64_W0;
        uint64_t hi, lo;
        mul64_wide(P2x64_M, x0, &hi, &lo);
        x0 = hi ^ k0 ^ x1;
        x1 = lo;
    }
    out[0] = x0;
    out[1] = x1;
}

inline void philox4x64_block(const uint64_t ctr[4], const uint64_t key[2],
                             int rounds, uint64_t out[4]) {
    uint64_t x0 = ctr[0], x1 = ctr[1], x2 = ctr[2], x3 = ctr[3];
    uint64_t k0 = key[0], k1 = key[1];
    for (int r = 0; r < rounds; ++r) {
        if (r > 0) {
            k0 += P64_W0;
            k1 += P64_W1;
        }
        uint64_t hi0, lo0, hi1, lo1;
        mul64_wide(P4x64_M0, x0, &hi0, &lo0);
        mul64_wide(P4x64_M1, x2, &hi1, &lo1);
        x0 = hi1 ^ x1 ^ k0;
        x1 = lo1;
        x2 = hi0 ^ x3 ^ k1;
        x3 = lo0;
    }
    out[0] = x0;
    out[1] = x1;
    out[2] = x2;
    out[3] = x3;
}

constexpr uint64_t TF64_PARITY = 0x1BD11BDAA9FC1A22ull;
constexpr int TF64_2_ROT[8] = {16, 42, 12, 31, 16, 32, 24, 21};
constexpr int TF64_4_R0[8] = {14, 52, 23, 5, 25, 46, 58, 32};
constexpr int TF64_4_R1[8] = {16, 57, 40, 37, 33, 12, 22, 32};

inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

inline void threefry2x64_block(const uint64_t ctr[2], const uint64_t key[2],
                               int rounds, uint64_t out[2]) {
    uint64_t ks[3] = {key[0], key[1], TF64_PARITY ^ key[0] ^ key[1]};
    uint64_t x0 = ctr[0] + ks[0], x1 = ctr[1] + ks[1];
    for (int r = 0; r < rounds; ++r) {
        x0 += x1;
        x1 = rotl64(x1, TF64_2_ROT[r % 8]) ^ x0;
        if ((r + 1) % 4 == 0) {
            int s = (r + 1) / 4;
            x0 += ks[s % 3];
            x1 += ks[(s + 1) % 3] + (uint64_t)s;
        }
    }
    out[0] = x0;
    out[1] = x1;
}

inline void threefry4x64_block(const uint64_t ctr[4], const uint64_t key[4],
                               int rounds, uint64_t out[4]) {
    uint64_t ks[5] = {key[0], key[1], key[2], key[3],
                      TF64_PARITY ^ key[0] ^ key[1] ^ key[2] ^ key[3]};
    uint64_t x[4];
    for (int i = 0; i < 4; ++i)
        x[i] = ctr[i] + ks[i];
    for (int r = 0; r < rounds; ++r) {
        int r0 = TF64_4_R0[r % 8], r1 = TF64_4_R1[r % 8];
        if (r % 2 == 0) {
            x[0] += x[1]; x[1] = rotl64(x[1], r0) ^ x[0];
            x[2] += x[3]; x[3] = rotl64(x[3], r1) ^ x[2];
        } else {
            x[0] += x[3]; x[3] = rotl64(x[3], r0) ^ x[0];
            x[2] += x[1]; x[1] = rotl64(x[1], r1) ^ x[2];
        }
        if ((r + 1) % 4 == 0) {
            int s = (r + 1) / 4;
            for (int i = 0; i < 4; ++i)
                x[i] += ks[(s + i) % 5];
            x[3] += (uint64_t)s;
        }
    }
    for (int i = 0; i < 4; ++i)
        out[i] = x[i];
}

// little-endian multiword add over uint64 counter words (Random123
// ctr.incr semantics for the x64 CBRNGs)
inline void ctr_add_u64(uint64_t *v, int w, uint64_t n) {
    uint64_t prev = v[0];
    v[0] += n;
    uint64_t carry = (v[0] < prev) ? 1u : 0u;
    for (int i = 1; i < w && carry; ++i) {
        prev = v[i];
        v[i] += carry;
        carry = (v[i] < prev) ? 1u : 0u;
    }
}

inline double u01d(uint64_t u) {
    return (double)u * 0x1p-64 + 0x1p-65;
}

inline double uneg11d(uint64_t u) {
    return (double)(int64_t)u * 0x1p-63 + 0x1p-64;
}

inline void boxmul64(uint64_t u0, uint64_t u1, double *a, double *b) {
    const double pi = 3.141592653589793238462643383;
    double ang = pi * uneg11d(u0);
    double r = std::sqrt(-2.0 * std::log(u01d(u1)));
    *a = std::sin(ang) * r;
    *b = std::cos(ang) * r;
}

// gen: 0 = philox2x64, 1 = philox4x64, 2 = threefry2x64, 3 = threefry4x64
// (same encoding as rbt_cbrng64); returns the block width in words.
inline int cbrng64_width(int gen) { return (gen == 0 || gen == 2) ? 2 : 4; }

inline void cbrng64_block(int gen, const uint64_t *ctr, const uint64_t *key,
                          uint64_t *out) {
    switch (gen) {
        case 0: philox2x64_block(ctr, key, 10, out); break;
        case 1: philox4x64_block(ctr, key, 10, out); break;
        case 2: threefry2x64_block(ctr, key, 20, out); break;
        default: threefry4x64_block(ctr, key, 20, out); break;
    }
}

inline void block_values64(int gen, const uint64_t *ctr, const uint64_t *key,
                           int gaussian, double out[4]) {
    uint64_t rv[4];
    int w = cbrng64_width(gen);
    cbrng64_block(gen, ctr, key, rv);
    if (gaussian) {
        for (int i = 0; i + 1 < w; i += 2)
            boxmul64(rv[i], rv[i + 1], &out[i], &out[i + 1]);
    } else {
        for (int i = 0; i < w; ++i)
            out[i] = uneg11d(rv[i]);
    }
}

// rng: 0 = Philox4x32-10 (key[2]), 1 = Threefry4x32-20 (key[4])
inline void cbrng_block(const Ctr4 &ctr, const uint32_t *key, int rng,
                        uint32_t out[4]) {
    if (rng == 1)
        threefry4x32_block(ctr, key, 20, out);
    else
        philox4x32_block(ctr, key[0], key[1], 10, out);
}

inline float u01f(uint32_t u) {
    return (float)u * 0x1p-32f + 0x1p-33f;
}

inline float uneg11f(uint32_t u) {
    return (float)(int32_t)u * 0x1p-31f + 0x1p-32f;
}

inline void boxmul(uint32_t u0, uint32_t u1, float *a, float *b) {
    const float pi = 3.1415926535897932f;
    float ang = pi * uneg11f(u0);
    float r = std::sqrt(-2.0f * std::log(u01f(u1)));
    *a = std::sin(ang) * r;
    *b = std::cos(ang) * r;
}

inline void block_values(const Ctr4 &ctr, const uint32_t *key, int rng,
                         int gaussian, float out[4]) {
    uint32_t rv[4];
    cbrng_block(ctr, key, rng, rv);
    if (gaussian) {
        boxmul(rv[0], rv[1], &out[0], &out[1]);
        boxmul(rv[2], rv[3], &out[2], &out[3]);
    } else {
        for (int i = 0; i < 4; ++i)
            out[i] = uneg11f(rv[i]);
    }
}

}  // namespace

extern "C" {

// Raw Philox4x32 blocks for n counters laid out as uint32[n][4].
void rbt_philox4x32(const uint32_t *ctrs, const uint32_t *key, int rounds,
                    int64_t n, uint32_t *out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        Ctr4 c;
        std::memcpy(c.v, ctrs + 4 * i, sizeof(c.v));
        philox4x32_block(c, key[0], key[1], rounds, out + 4 * i);
    }
}

// Counter-addressed row-major submatrix fill (float32).
// Mirrors ops/dense_fill.fill_rowmajor: element (r, c) of the submatrix
// reads lane (fbs + c) % 4 of counter base + ctr_mat_start +
// r*stride + (fbs + c)/4. family: 1 = gaussian, 0 = uniform(-1,1)
// (unscaled). rng: 0 = Philox4x32-10, 1 = Threefry4x32-20.
// Parallel over rows; output independent of thread count.
void rbt_fill_rowmajor_g(int64_t n_cols_parent, int64_t n_srows,
                         int64_t n_scols, int64_t ptr, const uint32_t *ctr,
                         const uint32_t *key, int rng, int gaussian,
                         float *out) {
    const int64_t w = 4;
    int64_t pad = (w - (n_cols_parent % w)) % w;
    int64_t ptr_padded = ptr + (ptr / n_cols_parent) * pad;
    int64_t ctr_mat_start = ptr_padded / w;
    int64_t fbs = ptr_padded % w;
    int64_t stride = (n_cols_parent + pad) / w;
    int64_t nblk = (fbs + n_scols - 1) / w + 1;
    Ctr4 seed;
    std::memcpy(seed.v, ctr, sizeof(seed.v));
    Ctr4 base = ctr_add64(seed, (uint64_t)ctr_mat_start);

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_srows; ++r) {
        Ctr4 row_ctr = ctr_add64(base, (uint64_t)r * (uint64_t)stride);
        float vals[4];
        int64_t written = 0;
        for (int64_t b = 0; b < nblk && written < n_scols; ++b) {
            block_values(ctr_add64(row_ctr, (uint64_t)b), key, rng,
                         gaussian, vals);
            int64_t lane0 = (b == 0) ? fbs : 0;
            for (int64_t l = lane0; l < 4 && written < n_scols; ++l)
                out[r * n_scols + written++] = vals[l];
        }
    }
}

void rbt_fill_rowmajor(int64_t n_cols_parent, int64_t n_srows,
                       int64_t n_scols, int64_t ptr, const uint32_t *ctr,
                       const uint32_t *key, int gaussian, float *out) {
    rbt_fill_rowmajor_g(n_cols_parent, n_srows, n_scols, ptr, ctr, key,
                        0, gaussian, out);
}

// Raw 64-bit CBRNG blocks. gen: 0 = philox2x64 (width 2, key 1 word),
// 1 = philox4x64 (width 4, key 2), 2 = threefry2x64 (width 2, key 2),
// 3 = threefry4x64 (width 4, key 4). ctrs: uint64[n][width].
void rbt_cbrng64(int gen, const uint64_t *ctrs, const uint64_t *key,
                 int rounds, int64_t n, uint64_t *out) {
    int width = (gen == 0 || gen == 2) ? 2 : 4;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t *c = ctrs + width * i;
        uint64_t *o = out + width * i;
        switch (gen) {
            case 0: philox2x64_block(c, key, rounds, o); break;
            case 1: philox4x64_block(c, key, rounds, o); break;
            case 2: threefry2x64_block(c, key, rounds, o); break;
            default: threefry4x64_block(c, key, rounds, o); break;
        }
    }
}

// Counter-addressed row-major submatrix fill, NATIVE float64 streams
// (the reference's x64-counter template instantiation,
// random_gen.hh:121-173 + dense_skops.hh:97-170). Same padding math as
// rbt_fill_rowmajor_g with w = the generator's word width; ctr/key are
// uint64 word arrays. gen encoding as rbt_cbrng64. Parallel over rows;
// output independent of thread count.
void rbt_fill_rowmajor64_g(int gen, int64_t n_cols_parent, int64_t n_srows,
                           int64_t n_scols, int64_t ptr, const uint64_t *ctr,
                           const uint64_t *key, int gaussian, double *out) {
    const int64_t w = cbrng64_width(gen);
    int64_t pad = (w - (n_cols_parent % w)) % w;
    int64_t ptr_padded = ptr + (ptr / n_cols_parent) * pad;
    int64_t ctr_mat_start = ptr_padded / w;
    int64_t fbs = ptr_padded % w;
    int64_t stride = (n_cols_parent + pad) / w;
    int64_t nblk = (fbs + n_scols - 1) / w + 1;
    uint64_t base[4] = {0, 0, 0, 0};
    std::memcpy(base, ctr, (size_t)w * sizeof(uint64_t));
    ctr_add_u64(base, (int)w, (uint64_t)ctr_mat_start);

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_srows; ++r) {
        uint64_t row_ctr[4];
        std::memcpy(row_ctr, base, sizeof(row_ctr));
        ctr_add_u64(row_ctr, (int)w, (uint64_t)(r * stride));
        double vals[4];
        int64_t written = 0;
        uint64_t c[4];
        for (int64_t b = 0; b < nblk && written < n_scols; ++b) {
            std::memcpy(c, row_ctr, sizeof(c));
            ctr_add_u64(c, (int)w, (uint64_t)b);
            block_values64(gen, c, key, gaussian, vals);
            int64_t lane0 = (b == 0) ? fbs : 0;
            for (int64_t l = lane0; l < w && written < n_scols; ++l)
                out[r * n_scols + written++] = vals[l];
        }
    }
}

// Raw Threefry4x32 blocks for n counters laid out as uint32[n][4];
// key is uint32[4].
void rbt_threefry4x32(const uint32_t *ctrs, const uint32_t *key,
                      int rounds, int64_t n, uint32_t *out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        Ctr4 c;
        std::memcpy(c.v, ctrs + 4 * i, sizeof(c.v));
        threefry4x32_block(c, key, rounds, out + 4 * i);
    }
}

// Repeated Fisher-Yates without replacement: dim_minor vectors of vec_nnz
// indices from {0..dim_major-1} plus +-1 values. idxs: int64[dim_minor *
// vec_nnz], vals: float[dim_minor * vec_nnz]. Work vector restored between
// vectors (submatrix reproducibility), parallel over vectors.
// rng: 0 = Philox4x32-10, 1 = Threefry4x32-20.
void rbt_fisher_yates_g(const uint32_t *ctr, const uint32_t *key, int rng,
                        int64_t vec_nnz, int64_t dim_major,
                        int64_t dim_minor, int64_t *idxs, float *vals) {
    Ctr4 seed;
    std::memcpy(seed.v, ctr, sizeof(seed.v));

#pragma omp parallel
    {
        // per-thread identity work vector (restored after each vector, so
        // it can be reused across the vectors this thread owns)
        int64_t *work = new int64_t[dim_major];
        for (int64_t j = 0; j < dim_major; ++j)
            work[j] = j;
        int64_t *pivots = new int64_t[vec_nnz];

#pragma omp for schedule(static)
        for (int64_t i = 0; i < dim_minor; ++i) {
            Ctr4 c = ctr_add64(seed, (uint64_t)i * (uint64_t)vec_nnz);
            for (int64_t j = 0; j < vec_nnz; ++j) {
                uint32_t rv[4];
                cbrng_block(c, key, rng, rv);
                int64_t ell = j + (int64_t)(rv[0] % (uint32_t)(dim_major - j));
                pivots[j] = ell;
                int64_t swap = work[ell];
                work[ell] = work[j];
                work[j] = swap;
                idxs[i * vec_nnz + j] = swap;
                vals[i * vec_nnz + j] = (rv[1] % 2 == 0) ? 1.0f : -1.0f;
                c = ctr_add64(c, 1);
            }
            // restore
            for (int64_t j = vec_nnz; j > 0; --j) {
                int64_t jj = j - 1;
                int64_t swap = idxs[i * vec_nnz + jj];
                int64_t ell = pivots[jj];
                work[jj] = work[ell];
                work[ell] = swap;
            }
        }
        delete[] work;
        delete[] pivots;
    }
}

void rbt_fisher_yates(const uint32_t *ctr, const uint32_t *key,
                      int64_t vec_nnz, int64_t dim_major,
                      int64_t dim_minor, int64_t *idxs, float *vals) {
    rbt_fisher_yates_g(ctr, key, 0, vec_nnz, dim_major, dim_minor, idxs,
                       vals);
}

}  // extern "C"
