// Native host runtime for riptide_tpu_torch.
//
// The device compute path lives in the CUDA kernels (csrc/); this
// library provides the native host-side pieces that surround it,
// mirroring the roles the reference implements in C++
// (riptide/cpp/*.hpp) without sharing its structure:
//   - bulk data loading / 8-bit decoding (the data-loader),
//   - FFA level-table construction (the plan/graph builder used by
//     riptide_tpu_torch.ops.plan),
//   - exact CPU kernels: downsample backs the host-side
//     riptide_tpu_torch.libffa.downsample API; running median, prefix sum,
//     boxcar S/N and the iterative FFA transform serve as independent
//     cross-checks of the numpy oracles in the test suite and power the
//     rn_benchmark_ffa CPU micro-benchmark.
//
// All entry points are extern "C" with plain pointers, bound from
// Python via ctypes (no pybind11 in this environment).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <vector>
#include <thread>
#include <atomic>
#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Data loading / decoding
// ---------------------------------------------------------------------------

// Read `count` float32 samples starting at byte `offset`. Returns the
// number of samples actually read (0 on open failure).
int64_t rn_read_f32(const char* path, int64_t offset, int64_t count, float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 0;
    if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
        std::fclose(f);
        return 0;
    }
    int64_t got = static_cast<int64_t>(std::fread(out, sizeof(float), count, f));
    std::fclose(f);
    return got;
}

// Decode n 8-bit samples (signed or unsigned) to float32.
void rn_decode8(const void* in, int64_t n, int is_signed, float* out) {
    if (is_signed) {
        const int8_t* p = static_cast<const int8_t*>(in);
        for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(p[i]);
    } else {
        const uint8_t* p = static_cast<const uint8_t*>(in);
        for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(p[i]);
    }
}

// ---------------------------------------------------------------------------
// FFA level tables (the plan builder)
// ---------------------------------------------------------------------------
//
// Semantics contract (shared with riptide_tpu_torch/ops/plan.py): an m-row
// transform runs as L = ceil(log2(m)) levels over an (m + 1)-row buffer
// whose last row Z is held at zero. A node of mn rows occupying buffer
// rows [r0, r0+mn) merges at 1-based level `lvl`; its children merge one
// level earlier. Rows not being merged at a level carry through via the
// identity entry out[i] = buf[i] + roll(buf[Z], 0). The merge row
// mapping rounds kh*s + 0.5 in float32 to bit-match the float arithmetic
// the search numerics were validated against.

static void fill_node(int64_t r0, int64_t mn, int64_t lvl, int64_t m, int64_t L,
                      int32_t* h, int32_t* t, int32_t* shift) {
    if (mn == 1) return;
    const int64_t R = m + 1;
    const int64_t mh = mn / 2;
    const int64_t mt = mn - mh;
    fill_node(r0, mh, lvl - 1, m, L, h, t, shift);
    fill_node(r0 + mh, mt, lvl - 1, m, L, h, t, shift);
    const float kh = static_cast<float>(mh - 1) / static_cast<float>(mn - 1);
    const float kt = static_cast<float>(mt - 1) / static_cast<float>(mn - 1);
    int32_t* hl = h + (lvl - 1) * R;
    int32_t* tl = t + (lvl - 1) * R;
    int32_t* sl = shift + (lvl - 1) * R;
    for (int64_t s = 0; s < mn; ++s) {
        const int32_t hs = static_cast<int32_t>(kh * static_cast<float>(s) + 0.5f);
        const int32_t ts = static_cast<int32_t>(kt * static_cast<float>(s) + 0.5f);
        hl[r0 + s] = static_cast<int32_t>(r0) + hs;
        tl[r0 + s] = static_cast<int32_t>(r0 + mh) + ts;
        sl[r0 + s] = static_cast<int32_t>(s) - ts;
    }
}

// Fill (L, m + 1) int32 tables h/t/shift for an m-row transform.
// L must be >= ceil(log2(m)); extra levels stay identity.
void rn_ffa_tables(int64_t m, int64_t L, int32_t* h, int32_t* t, int32_t* shift) {
    const int64_t R = m + 1;
    const int32_t Z = static_cast<int32_t>(m);
    for (int64_t l = 0; l < L; ++l) {
        int32_t* hl = h + l * R;
        int32_t* tl = t + l * R;
        int32_t* sl = shift + l * R;
        for (int64_t i = 0; i < R; ++i) {
            hl[i] = static_cast<int32_t>(i);
            tl[i] = Z;
            sl[i] = 0;
        }
        hl[Z] = Z;
    }
    int64_t levels = 0;
    while ((int64_t(1) << levels) < m) ++levels;
    if (levels > 0) fill_node(0, m, levels, m, L, h, t, shift);
}

// ---------------------------------------------------------------------------
// Iterative FFA transform (CPU fallback / benchmark)
// ---------------------------------------------------------------------------

// out[s] = sum over input rows with phase drift s; (m, p) -> (m, p).
void rn_ffa_transform(const float* in, int64_t m, int64_t p, float* out) {
    if (m == 1) {
        std::memcpy(out, in, sizeof(float) * p);
        return;
    }
    int64_t L = 0;
    while ((int64_t(1) << L) < m) ++L;
    const int64_t R = m + 1;
    std::vector<int32_t> h(L * R), t(L * R), shift(L * R);
    rn_ffa_tables(m, L, h.data(), t.data(), shift.data());

    std::vector<float> a(R * p, 0.0f), b(R * p, 0.0f);
    std::memcpy(a.data(), in, sizeof(float) * m * p);
    float* cur = a.data();
    float* nxt = b.data();
    for (int64_t l = 0; l < L; ++l) {
        const int32_t* hl = h.data() + l * R;
        const int32_t* tl = t.data() + l * R;
        const int32_t* sl = shift.data() + l * R;
        for (int64_t i = 0; i < R; ++i) {
            const float* hr = cur + int64_t(hl[i]) * p;
            const float* tr = cur + int64_t(tl[i]) * p;
            float* o = nxt + i * p;
            const int64_t sh = sl[i] % p;
            // o = hr + roll(tr, -sh): two contiguous spans
            for (int64_t j = 0; j < p - sh; ++j) o[j] = hr[j] + tr[j + sh];
            for (int64_t j = p - sh; j < p; ++j) o[j] = hr[j] + tr[j + sh - p];
        }
        std::swap(cur, nxt);
    }
    std::memcpy(out, cur, sizeof(float) * m * p);
}

// Elementary kernels, exposed purely for testing (like the reference's
// libcpp.rollback / fused_rollback_add, python_bindings.cpp:32-55):
// out = roll(x, -shift) as two contiguous spans, and z = x + that.

void rn_rollback(const float* x, int64_t n, int64_t shift, float* out) {
    const int64_t s = ((shift % n) + n) % n;
    std::memcpy(out, x + s, sizeof(float) * (n - s));
    std::memcpy(out + (n - s), x, sizeof(float) * s);
}

void rn_fused_rollback_add(const float* x, const float* y, int64_t n,
                           int64_t shift, float* out) {
    const int64_t s = ((shift % n) + n) % n;
    for (int64_t j = 0; j < n - s; ++j) out[j] = x[j] + y[j + s];
    for (int64_t j = n - s; j < n; ++j) out[j] = x[j] + y[j + s - n];
}

// Seconds per transform of an (rows, cols) random array, best timing
// over `loops` runs (the benchmark_ffa2 analog).
double rn_benchmark_ffa(int64_t rows, int64_t cols, int64_t loops) {
    std::vector<float> in(rows * cols), out(rows * cols);
    for (size_t i = 0; i < in.size(); ++i)
        in[i] = static_cast<float>((i * 2654435761u & 0xffff) / 65536.0 - 0.5);
    double best = 1e30;
    for (int64_t l = 0; l < loops; ++l) {
        auto t0 = std::chrono::steady_clock::now();
        rn_ffa_transform(in.data(), rows, cols, out.data());
        auto t1 = std::chrono::steady_clock::now();
        best = std::min(best, std::chrono::duration<double>(t1 - t0).count());
    }
    return best;
}

// ---------------------------------------------------------------------------
// Exact running median (edge-padded), O(n log w)
// ---------------------------------------------------------------------------

void rn_running_median(const float* x, int64_t n, int64_t w, float* out) {
    const int64_t half = w / 2;
    // Ordered multiset holding the current window, with an iterator
    // pinned at rank `half` (the median of the w-element window). On
    // each slide the incoming element is inserted, the iterator rank is
    // rebalanced, and one instance of the outgoing element is erased.
    std::multiset<float> win;
    auto clip = [&](int64_t j) { return j < 0 ? int64_t(0) : (j >= n ? n - 1 : j); };
    for (int64_t j = -half; j <= half; ++j) win.insert(x[clip(j)]);
    auto med = std::next(win.begin(), half);
    out[0] = *med;
    for (int64_t i = 1; i < n; ++i) {
        const float incoming = x[clip(i + half)];
        const float outgoing = x[clip(i - half - 1)];
        win.insert(incoming);
        if (incoming < *med) --med;   // insertion below the median: rank shifts
        if (outgoing <= *med) ++med;  // removal at/below the median: shift back
        win.erase(win.lower_bound(outgoing));
        out[i] = *med;
    }
}

// ---------------------------------------------------------------------------
// Real-factor downsampling (double accumulator)
// ---------------------------------------------------------------------------

void rn_downsample(const float* x, int64_t n, double f, float* out) {
    const int64_t nout = static_cast<int64_t>(std::floor(n / f));
    for (int64_t k = 0; k < nout; ++k) {
        const double start = k * f;
        const double end = start + f;
        const int64_t imin = static_cast<int64_t>(std::floor(start));
        int64_t imax = static_cast<int64_t>(std::floor(end));
        if (imax > n - 1) imax = n - 1;
        const double wmin = imin + 1.0 - start;
        const double wmax = end - imax;
        double acc = wmin * x[imin] + wmax * x[imax];
        for (int64_t j = imin + 1; j < imax; ++j) acc += x[j];
        out[k] = static_cast<float>(acc);
    }
}

// ---------------------------------------------------------------------------
// Circular prefix sum + boxcar S/N (double accumulators)
// ---------------------------------------------------------------------------

void rn_circular_prefix_sum(const float* x, int64_t n, int64_t nsum, double* out) {
    double acc = 0.0;
    for (int64_t j = 0; j < (nsum < n ? nsum : n); ++j) {
        acc += x[j];
        out[j] = acc;
    }
    if (nsum <= n) return;
    const double total = acc;
    for (int64_t j = n; j < nsum; ++j) out[j] = out[j - n] + total;
}

// S/N of each row of a (rows, bins) array for each trial width.
// out is (rows, nw) float32.
void rn_boxcar_snr(const float* x, int64_t rows, int64_t bins,
                   const int64_t* widths, int64_t nw, float stdnoise,
                   float* out) {
    int64_t wmax = 0;
    for (int64_t i = 0; i < nw; ++i) wmax = std::max(wmax, widths[i]);
    std::vector<double> cpf(bins + wmax);
    for (int64_t r = 0; r < rows; ++r) {
        const float* row = x + r * bins;
        rn_circular_prefix_sum(row, bins, bins + wmax, cpf.data());
        const double total = cpf[bins - 1];
        for (int64_t i = 0; i < nw; ++i) {
            const int64_t w = widths[i];
            const double h = std::sqrt(double(bins - w) / (double(bins) * w));
            const double b = double(w) / double(bins - w) * h;
            // max over all circular phases of the w-bin window sum,
            // expressed as cpf[j + w] - cpf[j] like the oracle
            double dmax = -1e300;
            for (int64_t j = 0; j < bins; ++j)
                dmax = std::max(dmax, cpf[j + w] - cpf[j]);
            out[r * nw + i] = static_cast<float>(((h + b) * dmax - b * total) / stdnoise);
        }
    }
}


// ---------------------------------------------------------------------------
// Threaded all-stages batch downsampling (the host side of the search
// engine's cascade; see riptide_tpu_torch/search/engine.py).
//
// For each trial d: one float64 inclusive prefix sum of x[d] (leading 0),
// then for every stage s and output sample k:
//   out[s,d,k] = wmin[s,k] * x[d, imin[s,k]]
//              + wint[s,k] * (cs[imax[s,k]] - cs[imin[s,k] + 1])
//              + wmax[s,k] * x[d, imax[s,k]]
// matching engine._stage_downsample / the reference's double accumulator
// (riptide/cpp/downsample.hpp:44-82). Output is float32 or IEEE float16
// (round-to-nearest-even, software conversion for ISA portability).
// Work is spread over threads by (stage, trial) pairs; prefix sums are
// computed per trial by the first pair that needs them.

static uint16_t f32_to_f16_rne(float value) {
    uint32_t x;
    std::memcpy(&x, &value, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    x &= 0x7fffffffu;
    if (x >= 0x47800000u) {                 // overflow -> inf; keep nan
        const uint16_t mant = (x > 0x7f800000u) ? 0x200u : 0u;
        return static_cast<uint16_t>(sign | 0x7c00u | mant);
    }
    if (x < 0x38800000u) {                  // f16 subnormal or zero
        if (x < 0x33000000u) return static_cast<uint16_t>(sign);
        const int shift = 126 - static_cast<int>(x >> 23);  // in [14, 24]
        const uint32_t mant = (x & 0x7fffffu) | 0x800000u;
        uint32_t v = mant >> shift;
        const uint32_t rem = mant & ((1u << shift) - 1u);
        const uint32_t half = 1u << (shift - 1);
        if (rem > half || (rem == half && (v & 1u))) v++;
        return static_cast<uint16_t>(sign | v);
    }
    // normal: rebias exponent (127 -> 15), round mantissa to 10 bits RNE;
    // a mantissa carry correctly bumps the exponent (and 65520+ -> inf).
    const uint32_t exp16 = (x >> 23) - 112u;
    const uint32_t mant = x & 0x7fffffu;
    uint32_t v = (exp16 << 10) | (mant >> 13);
    const uint32_t rem = mant & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (v & 1u))) v++;
    return static_cast<uint16_t>(sign | v);
}


#if defined(__x86_64__)
// Hardware float->half for the wire format; only called after a runtime
// cpuid check, so the .so stays loadable on pre-F16C machines.
__attribute__((target("f16c,avx")))
static void f32_to_f16_vec_hw(const float* in, uint16_t* out, int64_t n) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        __m256 v = _mm256_loadu_ps(in + i);
        __m128i h = _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT);
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i), h);
    }
    for (; i < n; ++i) out[i] = f32_to_f16_rne(in[i]);
}
static bool f16c_supported() {
    // GCC < 11 rejects "f16c" as a __builtin_cpu_supports feature name
    // (a hard COMPILE error, which silently cost every pre-11 host the
    // whole native runtime): read CPUID leaf 1 ECX bit 29 directly.
    static const bool ok = []() {
        unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
        if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
        return (ecx & (1u << 29)) != 0 && __builtin_cpu_supports("avx");
    }();
    return ok;
}
#else
static bool f16c_supported() { return false; }
static void f32_to_f16_vec_hw(const float*, uint16_t*, int64_t) {}
#endif

static void f32_to_f16_vec(const float* in, uint16_t* out, int64_t n) {
    if (f16c_supported()) { f32_to_f16_vec_hw(in, out, n); return; }
    for (int64_t i = 0; i < n; ++i) out[i] = f32_to_f16_rne(in[i]);
}

// Anchored-float32 prefix storage parameters (see prefix_scan4 below).
static const int64_t ANCHOR_LOG = 12;
static const int64_t ANCHOR_BLK = int64_t(1) << ANCHOR_LOG;  // 4096

// Reconstruct the float64 prefix at index j from float32 residuals +
// per-block float64 anchors (see prefix_scan4).
static inline double cs_at(const float* c, const double* anchors,
                           int64_t j) {
    const int64_t g = (j > 0 ? j - 1 : 0) >> ANCHOR_LOG;
    return anchors[g] + double(c[j]);
}

// One stage's downsampled values (the real-factor window sums) plus the
// running max|v|. The float64 operation order matches the scalar path
// exactly: (w0*x[a] + wi*(cs(b)-cs(a+1))) + w1*x[b] with cs(j) =
// anchors[g(j)] + double(c32[j]), no FMA contraction, so
// scalar/AVX2/numpy-fallback all produce identical bytes.
static void stage_values_scalar(const float* x, const float* c,
                                const double* anchors,
                                const int32_t* a, const int32_t* b,
                                const float* w0, const float* w1,
                                const float* wi, float* out, int64_t n,
                                float* vmax_io) {
    float vm = *vmax_io;
    for (int64_t k = 0; k < n; ++k) {
        const double v = double(w0[k]) * x[a[k]]
            + double(wi[k]) * (cs_at(c, anchors, b[k])
                               - cs_at(c, anchors, a[k] + 1))
            + double(w1[k]) * x[b[k]];
        const float vf = static_cast<float>(v);
        out[k] = vf;
        const float av = std::fabs(vf);
        if (av > vm) vm = av;
    }
    *vmax_io = vm;
}

#if defined(__x86_64__)
__attribute__((target("avx2")))
static void stage_values_avx2(const float* x, const float* c,
                              const double* anchors,
                              const int32_t* a, const int32_t* b,
                              const float* w0, const float* w1,
                              const float* wi, float* out, int64_t n,
                              float* vmax_io) {
    const __m256 abs_mask =
        _mm256_castsi256_ps(_mm256_set1_epi32(0x7FFFFFFF));
    const __m256i one = _mm256_set1_epi32(1);
    const __m256i izero = _mm256_setzero_si256();
    __m256 vmax8 = _mm256_setzero_ps();
    int64_t k = 0;
    for (; k + 8 <= n; k += 8) {
        const __m256i ai =
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(a + k));
        const __m256i bi =
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(b + k));
        const __m256 xa = _mm256_i32gather_ps(x, ai, 4);
        const __m256 xb = _mm256_i32gather_ps(x, bi, 4);
        // f32 residual gathers: c[a+1] (base c+1, index a) and c[b].
        const __m256 ra = _mm256_i32gather_ps(c + 1, ai, 4);
        const __m256 rb = _mm256_i32gather_ps(c, bi, 4);
        // anchor indices: g(a+1) = a >> LOG, g(b) = max(b-1, 0) >> LOG
        const __m256i ga = _mm256_srli_epi32(ai, ANCHOR_LOG);
        const __m256i gb = _mm256_srli_epi32(
            _mm256_max_epi32(_mm256_sub_epi32(bi, one), izero), ANCHOR_LOG);
        const __m256d aa_lo =
            _mm256_i32gather_pd(anchors, _mm256_castsi256_si128(ga), 8);
        const __m256d aa_hi =
            _mm256_i32gather_pd(anchors, _mm256_extracti128_si256(ga, 1), 8);
        const __m256d ab_lo =
            _mm256_i32gather_pd(anchors, _mm256_castsi256_si128(gb), 8);
        const __m256d ab_hi =
            _mm256_i32gather_pd(anchors, _mm256_extracti128_si256(gb, 1), 8);
        // cs(a+1) = anchor + double(residual); likewise cs(b).
        const __m256d ca_lo = _mm256_add_pd(
            aa_lo, _mm256_cvtps_pd(_mm256_castps256_ps128(ra)));
        const __m256d ca_hi = _mm256_add_pd(
            aa_hi, _mm256_cvtps_pd(_mm256_extractf128_ps(ra, 1)));
        const __m256d cb_lo = _mm256_add_pd(
            ab_lo, _mm256_cvtps_pd(_mm256_castps256_ps128(rb)));
        const __m256d cb_hi = _mm256_add_pd(
            ab_hi, _mm256_cvtps_pd(_mm256_extractf128_ps(rb, 1)));
        const __m256 w0v = _mm256_loadu_ps(w0 + k);
        const __m256 w1v = _mm256_loadu_ps(w1 + k);
        const __m256 wiv = _mm256_loadu_ps(wi + k);
        const __m256d e0_lo =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_castps256_ps128(w0v)),
                          _mm256_cvtps_pd(_mm256_castps256_ps128(xa)));
        const __m256d e0_hi =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_extractf128_ps(w0v, 1)),
                          _mm256_cvtps_pd(_mm256_extractf128_ps(xa, 1)));
        const __m256d mid_lo =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_castps256_ps128(wiv)),
                          _mm256_sub_pd(cb_lo, ca_lo));
        const __m256d mid_hi =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_extractf128_ps(wiv, 1)),
                          _mm256_sub_pd(cb_hi, ca_hi));
        const __m256d e1_lo =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_castps256_ps128(w1v)),
                          _mm256_cvtps_pd(_mm256_castps256_ps128(xb)));
        const __m256d e1_hi =
            _mm256_mul_pd(_mm256_cvtps_pd(_mm256_extractf128_ps(w1v, 1)),
                          _mm256_cvtps_pd(_mm256_extractf128_ps(xb, 1)));
        const __m256d v_lo =
            _mm256_add_pd(_mm256_add_pd(e0_lo, mid_lo), e1_lo);
        const __m256d v_hi =
            _mm256_add_pd(_mm256_add_pd(e0_hi, mid_hi), e1_hi);
        const __m256 v = _mm256_insertf128_ps(
            _mm256_castps128_ps256(_mm256_cvtpd_ps(v_lo)),
            _mm256_cvtpd_ps(v_hi), 1);
        _mm256_storeu_ps(out + k, v);
        vmax8 = _mm256_max_ps(vmax8, _mm256_and_ps(v, abs_mask));
    }
    float tmp[8];
    _mm256_storeu_ps(tmp, vmax8);
    float vm = *vmax_io;
    for (int i = 0; i < 8; ++i) vm = tmp[i] > vm ? tmp[i] : vm;
    for (; k < n; ++k) {
        const double v = double(w0[k]) * x[a[k]]
            + double(wi[k]) * (cs_at(c, anchors, b[k])
                               - cs_at(c, anchors, a[k] + 1))
            + double(w1[k]) * x[b[k]];
        const float vf = static_cast<float>(v);
        out[k] = vf;
        if (std::fabs(vf) > vm) vm = std::fabs(vf);
    }
    *vmax_io = vm;
}
static bool avx2_supported() {
    static const bool ok = __builtin_cpu_supports("avx2");
    return ok;
}
#else
static bool avx2_supported() { return false; }
static void stage_values_avx2(const float*, const float*, const double*,
                              const int32_t*, const int32_t*, const float*,
                              const float*, const float*, float*, int64_t,
                              float*) {}
#endif

static void stage_values(const float* x, const float* c,
                         const double* anchors, const int32_t* a,
                         const int32_t* b, const float* w0, const float* w1,
                         const float* wi, float* out, int64_t n,
                         float* vmax_io) {
    if (avx2_supported()) {
        stage_values_avx2(x, c, anchors, a, b, w0, w1, wi, out, n, vmax_io);
        return;
    }
    stage_values_scalar(x, c, anchors, a, b, w0, w1, wi, out, n, vmax_io);
}

// One trial's prefix sum in the 4-lane vector-scan order shared
// bit-for-bit with the numpy fallback (search/engine.py `_prefix64` /
// `_prefix_anchored`): elements are processed in groups of 4 with lane
// sums
//   l = [x0, x1+x0, (x2+x1)+x0, (x3+x2)+(x1+x0)]
// then cs[4v+1..4v+4] = carry + l and carry = cs[4v+4]; the <4-element
// tail continues serially from carry. A strictly serial accumulator is
// latency-bound (one dependent f64 add per element); this order's
// serial chain is one add per FOUR elements, the rest is lane-parallel
// (and AVX2-vectorized below), for ~4x on the survey's host hot path.
//
// STORAGE is the anchored-float32 form: the exact float64 running sum
// is never materialised — every prefix value is stored as the float32
// RESIDUAL against its block's float64 anchor, with one anchor per
// ANCHOR_BLK samples (anchors[g] = exact cs at sample g * ANCHOR_BLK).
// Consumers reconstruct cs64(j) = anchors[(j-1) >> ANCHOR_LOG] +
// double(c[j]) (j = 0 -> 0). Residuals stay below ~ANCHOR_BLK * |x|,
// so the f32 representation error is <= ~1e-5 absolute — far below the
// wire quantisation — while the prefix pass writes HALF the bytes of a
// float64 array (this pass is memory-bound and was the largest single
// host cost of a survey chunk). The f64 carry chain itself is
// unchanged, and the numpy fallback rounds the identical f64 values
// the same way, so native/numpy wire bytes stay bit-identical.
// (ANCHOR_LOG/ANCHOR_BLK and cs_at are defined above stage_values.)
#if defined(__x86_64__)
// One <=ANCHOR_BLK block's groups-of-4: writes float32 residuals
// against `anchor`, returns the f64 carry after the block.
__attribute__((target("avx2")))
static double block_scan4_avx2(const float* x, int64_t nv, float* c1,
                               double anchor, double carry) {
    const __m256d zero = _mm256_setzero_pd();
    const __m256d anc = _mm256_set1_pd(anchor);
    __m256d vcarry = _mm256_set1_pd(carry);
    for (int64_t v = 0; v < nv; ++v) {
        const int64_t i = 4 * v;
        __m256d xv = _mm256_cvtps_pd(_mm_loadu_ps(x + i));
        // s1 = xv + [0, x0, x1, x2]
        __m256d sh1 = _mm256_permute4x64_pd(xv, _MM_SHUFFLE(2, 1, 0, 0));
        sh1 = _mm256_blend_pd(sh1, zero, 0x1);
        __m256d s1 = _mm256_add_pd(xv, sh1);
        // s2 = s1 + [0, 0, s1_0, s1_1]
        __m256d sh2 = _mm256_permute4x64_pd(s1, _MM_SHUFFLE(1, 0, 0, 0));
        sh2 = _mm256_blend_pd(sh2, zero, 0x3);
        __m256d s2 = _mm256_add_pd(s1, sh2);
        __m256d out = _mm256_add_pd(s2, vcarry);
        _mm_storeu_ps(c1 + i, _mm256_cvtpd_ps(_mm256_sub_pd(out, anc)));
        // carry = out lane 3, broadcast
        vcarry = _mm256_permute4x64_pd(out, _MM_SHUFFLE(3, 3, 3, 3));
    }
    return _mm256_cvtsd_f64(vcarry);
}
#endif

static void prefix_scan4(const float* x, int64_t N, float* c,
                         double* anchors) {
    c[0] = 0.0f;
    double carry = 0.0;
    int64_t i = 0;
    int64_t g = 0;
    while (i < N) {
        const double anchor = carry;
        anchors[g++] = anchor;
        const int64_t end = std::min(N, i + ANCHOR_BLK);
        const int64_t nv = (end - i) / 4;  // block length % 4 only at N
#if defined(__x86_64__)
        if (avx2_supported() && nv) {
            carry = block_scan4_avx2(x + i, nv, c + i + 1, anchor, carry);
        } else
#endif
        {
            for (int64_t v = 0; v < nv; ++v) {
                const int64_t j = i + 4 * v;
                const double x0 = x[j], x1 = x[j + 1], x2 = x[j + 2],
                             x3 = x[j + 3];
                const double l1 = x1 + x0;
                const double l2 = (x2 + x1) + x0;
                const double l3 = (x3 + x2) + l1;
                c[j + 1] = static_cast<float>((carry + x0) - anchor);
                c[j + 2] = static_cast<float>((carry + l1) - anchor);
                c[j + 3] = static_cast<float>((carry + l2) - anchor);
                carry = carry + l3;
                c[j + 4] = static_cast<float>(carry - anchor);
            }
        }
        for (int64_t j = i + 4 * nv; j < end; ++j) {
            carry += x[j];
            c[j + 1] = static_cast<float>(carry - anchor);
        }
        i = end;
    }
}

// Per-trial anchored prefix sums of a (D, N) batch, threaded over
// trials (shared by the wire-preparation entry points). anchors holds
// G = ceil(N / ANCHOR_BLK) doubles per trial.
static void batch_prefix_sums(const float* batch, int64_t D, int64_t N,
                              float* cs, double* anchors, int64_t G,
                              int64_t nthreads) {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next_d(0);
    for (int64_t t = 0; t < std::min<int64_t>(nthreads, D); ++t) {
        pool.emplace_back([&]() {
            int64_t d;
            while ((d = next_d.fetch_add(1)) < D) {
                prefix_scan4(batch + d * N, N, cs + d * (N + 1),
                             anchors + d * G);
            }
        });
    }
    for (auto& th : pool) th.join();
}

void rn_downsample_stages(const float* batch, int64_t D, int64_t N,
                          const int32_t* imin, const int32_t* imax,
                          const float* wmin, const float* wmax,
                          const float* wint, int64_t S, int64_t nout,
                          int64_t nthreads, int as_f16, void* out) {
    const int64_t G = (N + ANCHOR_BLK - 1) / ANCHOR_BLK;
    std::vector<float> cs((N + 1) * D);
    std::vector<double> anchors(G * D);
    std::vector<std::thread> pool;
    if (nthreads <= 0) nthreads = 1;
    batch_prefix_sums(batch, D, N, cs.data(), anchors.data(), G, nthreads);
    // phase 2: stages x trials
    std::atomic<int64_t> next_job(0);
    const int64_t njobs = S * D;
    for (int64_t t = 0; t < std::min<int64_t>(nthreads, njobs); ++t) {
        pool.emplace_back([&]() {
            std::vector<float> scratch;
            int64_t job;
            while ((job = next_job.fetch_add(1)) < njobs) {
                const int64_t s = job / D, d = job % D;
                const float* x = batch + d * N;
                const float* c = cs.data() + d * (N + 1);
                const double* anc = anchors.data() + d * G;
                const int32_t* a = imin + s * nout;
                const int32_t* b = imax + s * nout;
                const float* w0 = wmin + s * nout;
                const float* w1 = wmax + s * nout;
                const float* wi = wint + s * nout;
                const int64_t base = (s * D + d) * nout;
                if (as_f16) {
                    uint16_t* o = static_cast<uint16_t*>(out) + base;
                    scratch.resize(nout);
                    for (int64_t k = 0; k < nout; ++k) {
                        const double v = double(w0[k]) * x[a[k]]
                            + double(wi[k]) * (cs_at(c, anc, b[k])
                               - cs_at(c, anc, a[k] + 1))
                            + double(w1[k]) * x[b[k]];
                        scratch[k] = static_cast<float>(v);
                    }
                    f32_to_f16_vec(scratch.data(), o, nout);
                } else {
                    float* o = static_cast<float*>(out) + base;
                    for (int64_t k = 0; k < nout; ++k) {
                        const double v = double(w0[k]) * x[a[k]]
                            + double(wi[k]) * (cs_at(c, anc, b[k])
                               - cs_at(c, anc, a[k] + 1))
                            + double(w1[k]) * x[b[k]];
                        o[k] = static_cast<float>(v);
                    }
                }
            }
        });
    }
    for (auto& th : pool) th.join();
}

// Quantised wire preparation in the kernel-decodable BYTE-PLANE VIEW
// (see riptide_tpu_torch/search/engine.py:_view_layout): every cascade
// stage's real-factor downsampling of a (D, N) batch, laid out per
// stage as a (R0, PW) row view (R0 = ceil(n / PW), zero padded) with
// one float32 scale per view row (scale = rowmax / qmax, bias-coded
// samples q = rne(v / scale) + bias). `group` consecutive view rows
// pack into one row of `planes` byte planes:
//   mode  6: group 4, words q0 | q1<<6 | q2<<12 | q3<<18, 3 planes
//   mode  8: group 1, one byte per sample, 1 plane
//   mode 12: group 2, words q0 | q1<<12, 3 planes
// Stage s occupies wire rows [roffs[s], roffs[s] + planes * pr) of the
// (D, tot_rows, PW) output and scale rows [soffs[s], soffs[s] + R0) of
// the (D, stot) scales; the caller pre-fills the wire with zeros and
// the scales with 1.0 so the slack regions the fused kernel's
// static-shape DMAs may over-read stay finite. Round-half-even via the
// 1.5*2^23 magic constant, float32 reciprocal: bit-identical to the
// numpy fallback (engine._prepare_uint).
void rn_prepare_wire_view(const float* batch, int64_t D, int64_t N,
                          const int32_t* imin, const int32_t* imax,
                          const float* wmin, const float* wmax,
                          const float* wint, int64_t S, int64_t nout_pad,
                          const int32_t* nouts, const int64_t* roffs,
                          int64_t tot_rows, const int64_t* soffs,
                          int64_t stot, int64_t PW, int64_t mode,
                          int64_t nthreads, float* scales, uint8_t* out) {
    const int64_t G = (N + ANCHOR_BLK - 1) / ANCHOR_BLK;
    std::vector<float> cs((N + 1) * D);
    std::vector<double> anchors(G * D);
    std::vector<std::thread> pool;
    if (nthreads <= 0) nthreads = 1;
    batch_prefix_sums(batch, D, N, cs.data(), anchors.data(), G, nthreads);
    const int64_t group = mode == 8 ? 1 : (mode == 12 ? 2 : 4);
    const float qmaxf = mode == 8 ? 127.0f : (mode == 12 ? 2047.0f : 31.0f);
    const int32_t bias = mode == 8 ? 128 : (mode == 12 ? 2048 : 32);
    const int32_t qmask = 2 * bias - 1;
    std::atomic<int64_t> next_job(0);
    const int64_t njobs = S * D;
    for (int64_t t = 0; t < std::min<int64_t>(nthreads, njobs); ++t) {
        pool.emplace_back([&]() {
            std::vector<float> scratch;
            std::vector<int32_t> q(group * PW);
            int64_t job;
            while ((job = next_job.fetch_add(1)) < njobs) {
                const int64_t s = job / D, d = job % D;
                const float* x = batch + d * N;
                const float* c = cs.data() + d * (N + 1);
                const double* anc = anchors.data() + d * G;
                const int32_t* a = imin + s * nout_pad;
                const int32_t* b = imax + s * nout_pad;
                const float* w0 = wmin + s * nout_pad;
                const float* w1 = wmax + s * nout_pad;
                const float* wi = wint + s * nout_pad;
                const int64_t n = nouts[s];
                const int64_t r0 = (n + PW - 1) / PW;
                const int64_t pr = (r0 + group - 1) / group;
                scratch.assign(group * pr * PW, 0.0f);
                float vmax_unused = 0.0f;
                stage_values(x, c, anc, a, b, w0, w1, wi, scratch.data(), n,
                             &vmax_unused);
                float* sc = scales + d * stot + soffs[s];
                uint8_t* ob = out + (d * tot_rows + roffs[s]) * PW;
                const float magic = 12582912.0f;  // 1.5 * 2^23, RNE
                for (int64_t k = 0; k < pr; ++k) {
                    for (int64_t g = 0; g < group; ++g) {
                        const int64_t r = k * group + g;
                        const float* v = scratch.data() + r * PW;
                        int32_t* qr = q.data() + g * PW;
                        if (r >= r0) {
                            for (int64_t j = 0; j < PW; ++j) qr[j] = bias;
                            continue;
                        }
                        float rmax = 0.0f;
                        for (int64_t j = 0; j < PW; ++j) {
                            const float av = std::fabs(v[j]);
                            if (av > rmax) rmax = av;
                        }
                        const float scale = rmax > 0.0f ? rmax / qmaxf : 1.0f;
                        sc[r] = scale;
                        const float inv = 1.0f / scale;
                        for (int64_t j = 0; j < PW; ++j) {
                            union { float f; int32_t i; } u;
                            u.f = v[j] * inv + magic;
                            qr[j] = ((u.i & 0x7FFFFF) - 4194304 + bias)
                                    & qmask;
                        }
                    }
                    if (mode == 8) {
                        uint8_t* p0 = ob + k * PW;
                        for (int64_t j = 0; j < PW; ++j)
                            p0[j] = static_cast<uint8_t>(q[j] & 255);
                        continue;
                    }
                    uint8_t* p0 = ob + k * PW;
                    uint8_t* p1 = ob + (pr + k) * PW;
                    uint8_t* p2 = ob + (2 * pr + k) * PW;
                    for (int64_t j = 0; j < PW; ++j) {
                        const uint32_t word = mode == 12
                            ? static_cast<uint32_t>(q[j])
                              | (static_cast<uint32_t>(q[PW + j]) << 12)
                            : static_cast<uint32_t>(q[j])
                              | (static_cast<uint32_t>(q[PW + j]) << 6)
                              | (static_cast<uint32_t>(q[2 * PW + j]) << 12)
                              | (static_cast<uint32_t>(q[3 * PW + j]) << 18);
                        p0[j] = static_cast<uint8_t>(word & 255);
                        p1[j] = static_cast<uint8_t>((word >> 8) & 255);
                        p2[j] = static_cast<uint8_t>((word >> 16) & 255);
                    }
                }
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
