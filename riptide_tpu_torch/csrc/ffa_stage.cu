// Hopper (sm_90a) kernels of one periodogram cascade stage.
//
// What they replace. The JAX package runs each cascade stage (one per
// lane bucket) as one Pallas TPU program:
//   K1  riptide_tpu/ops/ffa_kernel.py:_fused_kernel  (wire decode +
//       dequantise + (m, p) pack + FFA merge tree + boxcar S/N),
//   K2  riptide_tpu/ops/ffa_kernel.py:_kernel        (FFA merge tree +
//       boxcar S/N on an already packed float container), and
//   K3  riptide_tpu/ops/ffa_kernel.py:_fused_kernel_paired (K1 for a
//       host trial plus a same-p guest trial of a later stage riding
//       the host container's dead rows from its base row up),
// all ending in _cascade_body, which keeps the whole (rows, P) container
// in VMEM for every level. Here the same work is three kernels:
//   segment_cascade_kernel  one block per (DM trial, row tile): fills a
//                           shared-memory tile straight from the stage's
//                           wire slice (K1; K3 takes the guest rows from
//                           the guest stage's slice) or from the packed
//                           float container (K2), runs the leading Lloc
//                           FFA levels in shared memory and writes the
//                           tile to the container once;
//   ffa_level_kernel        one FFA level over the whole container,
//                           launched once for each of the levels
//                           Lloc+1..L;
//   boxcar_snr_kernel       the S/N epilogue of all three; rows at or
//                           above a trial's guest base take the guest's
//                           coefficients.
// Every phase width the JAX package takes runs here. Where no row pair
// of two float32 buffers fits a block's shared memory (p > 29,056), the
// segment plan has no tile-local level: the segment kernel writes each
// row straight to the container and every level is a level launch. The
// S/N kernel keeps as many rows' prefix sums in shared memory as fit
// (4 up to P = 14,528, 1 up to 58,112) and, above that, in a scratch row
// of device memory per evaluated row.
//
// Design. A GPU reads by index, so both level kernels execute the
// (h, t, shift) tables of ops/plan.py directly, as the plain PyTorch
// _level_step does:
//   out[d,b,r,c] = c < p_b ? in[d,b,h[r],c] + in[d,b,t[r],(c+shift[r]) % p_b] : 0
// One float add per element, in the same tree, with the zero row Z read
// as a literal +0.0f, so every container is bit identical to the plain
// levels'. K3 needs no level code of its own: the guest's tables are its
// own tree shifted up by its base row (ops/plan.py).
//
// A node merges at its own level from rows inside the node
// (FFAPlan.fill; the JAX package cuts the row axis across chips the same
// way, parallel/seqffa.py). ops/plan.py::segment_plan finds Lloc, the
// number of leading levels whose nodes all fit a tile of two float32
// buffers of rows x p in a block's 227 KB of opt-in shared memory, and
// cuts each plane's live rows into tiles of whole nodes (dead rows go to
// zero tiles). A tile's levels then never read outside it: the segment
// kernel ping-pongs its two shared buffers, one __syncthreads a level,
// and the unmerged container is never written to device memory. A
// tile's rows sit at stride p (its samples are one contiguous run of the
// stage), the wire is decoded a view row per warp (no division per
// sample), and each warp walks a row with its lanes on consecutive
// phases, so shared accesses are conflict free without padding.
//
// Bound. Each kernel is bound by device-memory bytes, not operations
// (one add per element a level). Before this design every level read
// two containers' worth of rows and wrote one; now the segment kernel
// reads the wire (3/4 byte a sample for uint6) and writes the container
// once, each of the L - Lloc global levels reads the rows its tables
// name (the second read of a row mostly from the 50 MB L2, since blocks
// walk each plane's rows in order) and writes the container, and
// boxcar_snr reads the evaluated rows once. At the headline plan Lloc is
// 6-7 of 8-11 levels. What bounds them in practice: a segment block
// needs up to 227 KB, so one block runs per SM and its fill, levels and
// write follow each other rather than overlap (at one DM trial, a
// launch of a later stage also fills only a third of the SMs); the
// global levels' traffic; and the S/N kernel, unchanged, whose read of
// the last level's output a later design fuses away.
//
// Numerics. Built with --fmad=false, and the decode/S/N arithmetic is
// spelled with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn, so no product is
// contracted into an FMA: the decoded tile is bit identical to the
// plain _udecode_view + _pack, every container to the plain levels',
// and the S/N differs from the plain snr_batched only through the
// summation order of the prefix sum. That
// order depends on the trial's p alone (chunks of ceil(p / 32) phases per
// lane), never on the container's P or R, so a trial's S/N is the same
// bits in any lane bucket, container height or pairing.
//
// Interface. Plain extern "C" launchers (loaded with ctypes), each
// launching on the caller's stream and returning cudaGetLastError();
// rt_init sets the kernels' shared-memory limit once, when the library
// loads. Nothing here allocates or synchronises; the Python wrapper
// allocates every output with torch.empty.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSegThreads = 1024;  // threads per segment_cascade block
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kLevelWarps = 8;    // rows (one warp each) per ffa_level block
constexpr int kSnrWarps = 4;      // rows (one warp each) per boxcar_snr block
constexpr unsigned kFull = 0xffffffffu;
// The largest dynamic shared memory an H100 block may opt into.
constexpr int kMaxDynamicSmem = 232448;

// Wire modes: the value is the mode's name suffix (uint6/uint8; any other
// value is uint12).
constexpr int kModeU6 = 6;
constexpr int kModeU8 = 8;

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Where one stage's samples sit in the wire: byte-plane row offset, rows
// per plane, scale row offset.
struct StageSlice {
  int64_t roff, pr, soff;
};

// Decode a stage's samples [k_lo, k_hi) into buf[e0 + k - k_lo]. The
// stage's byte planes start at wire row `at.roff` (`at.pr` rows a plane)
// and its per-view-row scales at sd. Warps walk the stage's (r0, PW)
// view rows, lanes their phases: no division per sample, each scale read
// once a row, each byte-plane row read coalesced.
__device__ __forceinline__ void fill_from_wire(
    float* __restrict__ buf, int32_t e0, int64_t k_lo, int64_t k_hi,
    const uint8_t* __restrict__ wd, const float* __restrict__ sd,
    int32_t PW, StageSlice at, int32_t mode, int warp, int lane) {
  if (k_hi <= k_lo) return;
  const bool u6 = mode == kModeU6;
  for (int64_t r = k_lo / PW + warp; r * PW < k_hi; r += kSegWarps) {
    const float scale = sd[r];
    const int64_t base = r * PW;
    const int32_t c_lo = (int32_t)(k_lo > base ? k_lo - base : 0);
    const int32_t c_hi = (int32_t)(k_hi - base < PW ? k_hi - base : PW);
    const int32_t off = e0 + (int32_t)(base - k_lo);  // buf index of c = 0
    if (mode == kModeU8) {
      const uint8_t* q0 = wd + (at.roff + r) * PW;
      for (int32_t c = c_lo + lane; c < c_hi; c += 32)
        buf[off + c] = __fmul_rn(__fsub_rn((float)q0[c], 128.0f), scale);
      continue;
    }
    // `group` (4 for uint6, 2 for uint12) consecutive view rows share one
    // byte-plane row; the three planes of the stage sit pr rows apart.
    const int64_t row = u6 ? r >> 2 : r >> 1;
    const int32_t sub = (int32_t)(u6 ? r & 3 : r & 1);
    const uint8_t* q0 = wd + (at.roff + row) * PW;
    const uint8_t* q1 = q0 + at.pr * PW;
    const uint8_t* q2 = q1 + at.pr * PW;
#pragma unroll 4
    for (int32_t c = c_lo + lane; c < c_hi; c += 32) {
      const int32_t b0 = q0[c], b1 = q1[c], b2 = q2[c];
      float xq;
      if (u6) {
        const int32_t word = b0 | (b1 << 8) | (b2 << 16);
        xq = __fsub_rn((float)((word >> (6 * sub)) & 63), 32.0f);
      } else {
        const int32_t q = sub == 0 ? (b0 | ((b1 & 15) << 8))
                                   : ((b1 >> 4) | (b2 << 4));
        xq = __fsub_rn((float)q, 2048.0f);
      }
      buf[off + c] = __fmul_rn(xq, scale);
    }
  }
}

// out[c] = in_h[c] + in_t[(c + s) % p] for c < p over one row, a warp's
// lanes on consecutive phases; a null row is the zero row (+0.0f).
__device__ __forceinline__ void merge_row(
    const float* __restrict__ hp, const float* __restrict__ tp, int32_t s,
    int32_t p, float* __restrict__ o, int lane) {
  if (tp == nullptr) {
    for (int32_t c = lane; c < p; c += 32)
      o[c] = hp == nullptr ? 0.0f : __fadd_rn(hp[c], 0.0f);
    return;
  }
  int32_t c2 = lane + s;
  if (c2 >= p) c2 -= p;
#pragma unroll 4
  for (int32_t c = lane; c < p; c += 32) {
    o[c] = __fadd_rn(hp == nullptr ? 0.0f : hp[c], tp[c2]);
    c2 += 32;
    if (c2 >= p) c2 -= p;
  }
}

// One block per (d, tile); blockIdx.x = d * ntiles + tile. A tile is
// (plane b, first row r0, rows n, live). A dead tile (live = 0) writes
// its n rows zero. A live tile fills shared buffer A with its n rows at
// stride p: from the packed container `src` (K2), or decoded from the
// wire (K1: host rows [0, m_b) from the host slice; K3 also guest rows
// [gbase_b, gbase_b + gm_b) from the guest slice), then runs levels
// 0..Lloc-1 ping-ponging A and B with the level tables rebased to the
// tile (Z -> literal zero), then writes its rows, zero from p to P.
// kDirect serves the plan of phase widths whose row pair does not fit a
// tile (no tile-local level, one-row tiles, no shared memory): a tile is
// filled straight into its container row. It is a template parameter so
// that each form knows its buffers' address space (a pointer that may be
// shared or global memory makes every access a generic one).
template <bool kFromWire, bool kDirect>
__global__ void __launch_bounds__(kSegThreads) segment_cascade_kernel(
    const float* __restrict__ src, const uint8_t* __restrict__ wire,
    const float* __restrict__ scales, const int32_t* __restrict__ tiles,
    int32_t ntiles, const int32_t* __restrict__ h,
    const int32_t* __restrict__ t, const int32_t* __restrict__ shift,
    const int32_t* __restrict__ ms, const int32_t* __restrict__ ps,
    const int32_t* __restrict__ gms, const int32_t* __restrict__ gbase,
    float* __restrict__ out, int32_t B, int32_t R, int32_t P, int32_t Lloc,
    int64_t wrows, int32_t PW, int64_t stot, StageSlice host,
    StageSlice guest, int32_t mode) {
  extern __shared__ float smem[];
  const int64_t d = blockIdx.x / ntiles;
  const int32_t* tile = tiles + 4 * (blockIdx.x - d * ntiles);
  const int32_t b = tile[0], r0 = tile[1], n = tile[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t plane = d * B + b;
  float* dst = out + (plane * R + r0) * (int64_t)P;
  if (tile[3] == 0) {
    const int64_t cnt = (int64_t)n * P;
    for (int64_t e = threadIdx.x; e < cnt; e += blockDim.x) dst[e] = 0.0f;
    return;
  }
  const int32_t p = ps[b];
  // kDirect: the tile's one row is its own buffer (its stride P does not
  // matter for one row).
  float* buf = kDirect ? dst : smem;
  float* nxt = smem + n * p;
  if constexpr (kFromWire) {
    // Host rows [0, m) from the host slice, guest rows [gb, gb + gm) from
    // the guest slice; any other row of the tile is zero.
    const uint8_t* wd = wire + d * wrows * PW;
    const float* sd = scales + d * stot;
    const int32_t hn = max(0, min(n, ms[b] - r0));
    fill_from_wire(buf, 0, (int64_t)r0 * p, (int64_t)(r0 + hn) * p, wd,
                   sd + host.soff, PW, host, mode, warp, lane);
    int32_t g0 = 0, g1 = 0;  // tile rows holding guest samples
    if (gbase != nullptr && gbase[b] >= 0) {
      const int32_t gb = gbase[b];
      g0 = max(r0, gb) - r0;
      g1 = max(g0, min(r0 + n, gb + gms[b]) - r0);
      fill_from_wire(buf, g0 * p, (int64_t)(r0 + g0 - gb) * p,
                     (int64_t)(r0 + g1 - gb) * p, wd, sd + guest.soff, PW,
                     guest, mode, warp, lane);
    }
    for (int32_t i = warp; i < n; i += kSegWarps)
      if (i >= hn && (i < g0 || i >= g1))
        for (int32_t c = lane; c < p; c += 32) buf[i * p + c] = 0.0f;
  } else {
    const float* s = src + (plane * R + r0) * (int64_t)P;
    for (int32_t i = warp; i < n; i += kSegWarps)
      for (int32_t c = lane; c < p; c += 32)
        buf[i * p + c] = s[(int64_t)i * P + c];
  }
  if constexpr (kDirect) {
    for (int32_t c = p + (int32_t)threadIdx.x; c < P; c += blockDim.x)
      dst[c] = 0.0f;
    return;
  }
  __syncthreads();
  const int32_t Z = R - 1;
  for (int32_t l = 0; l < Lloc; ++l) {
    const int64_t row0 = ((int64_t)l * B + b) * R + r0;
    for (int32_t i = warp; i < n; i += kSegWarps) {
      const int32_t hh = h[row0 + i];
      const int32_t tt = t[row0 + i];
      merge_row(hh == Z ? nullptr : buf + (hh - r0) * p,
                tt == Z ? nullptr : buf + (tt - r0) * p, shift[row0 + i] % p,
                p, nxt + i * p, lane);
    }
    __syncthreads();
    float* x = buf;
    buf = nxt;
    nxt = x;
  }
  for (int32_t i = warp; i < n; i += kSegWarps) {
    float* o = dst + (int64_t)i * P;
    for (int32_t c = lane; c < P; c += 32)
      o[c] = c < p ? buf[i * p + c] : 0.0f;
  }
}

// One FFA level over the whole (D, B, R, P) container: one warp per row,
// kLevelWarps rows per block; blockIdx.x = plane * chunks + chunk, so
// the blocks in flight walk each plane's rows in order and the second
// read of a source row finds it in L2.
__global__ void __launch_bounds__(kLevelWarps * 32) ffa_level_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ h, const int32_t* __restrict__ t,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ ps,
    int32_t B, int32_t R, int32_t P, int32_t chunks) {
  const int64_t plane = blockIdx.x / chunks;
  const int32_t r = (int32_t)(blockIdx.x - plane * chunks) * kLevelWarps +
                    (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const int32_t b = (int32_t)(plane % B);
  const int32_t p = ps[b];
  const int32_t Z = R - 1;
  const int64_t e = (int64_t)b * R + r;
  const int32_t hh = h[e];
  const int32_t tt = t[e];
  const float* src = in + plane * R * (int64_t)P;
  float* o = out + (plane * R + r) * (int64_t)P;
  merge_row(hh == Z ? nullptr : src + (int64_t)hh * P,
            tt == Z ? nullptr : src + (int64_t)tt * P, shift[e] % p, p, o,
            lane);
  for (int32_t c = p + lane; c < P; c += 32) o[c] = 0.0f;
}

// One warp per evaluated row (d, b, r < RE), blockDim.x / 32 rows a
// block. The row's inclusive prefix sum lives in shared memory (P floats
// per warp) or, with kScratch (rows too wide for shared memory), in the
// row's own P floats of `scratch`: each lane scans a contiguous chunk, a
// shuffle scan adds the chunk offsets. Then for
// each width the warp takes the maximum over the p phases of the
// circular window sum cs[(j + w) mod p] (+ total on wrap) - cs[j], and
// lane 0 writes ((h + b) * dmax - b * total) / std (ops/snr.py). With
// gbase (row-packed containers; null otherwise), rows r >= gbase[b] >= 0
// take the guest trial's gh/gb/gstd instead.
template <bool kScratch>
__global__ void boxcar_snr_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ ps, const int32_t* __restrict__ widths,
    const float* __restrict__ hcoef, const float* __restrict__ bcoef,
    const float* __restrict__ stdnoise, const int32_t* __restrict__ gbase,
    const float* __restrict__ ghcoef, const float* __restrict__ gbcoef,
    const float* __restrict__ gstdnoise, float* __restrict__ scratch,
    int64_t nrows, int32_t B, int32_t R, int32_t P, int32_t RE, int32_t NW) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= nrows) return;  // whole warps leave together
  const int64_t q = row / RE;
  const int32_t r = (int32_t)(row - q * RE);
  const int32_t b = (int32_t)(q % B);
  const int32_t p = ps[b];
  const float* x = in + (q * R + r) * P;
  float* cs = kScratch ? scratch + row * P : smem + warp * P;
  const bool guest = gbase != nullptr && gbase[b] >= 0 && r >= gbase[b];
  const float* hc = guest ? ghcoef : hcoef;
  const float* bc = guest ? gbcoef : bcoef;
  const float sn = guest ? gstdnoise[b] : stdnoise[b];

  const int32_t chunk = (p + 31) / 32;
  const int32_t c0 = min(lane * chunk, p);
  const int32_t c1 = min(c0 + chunk, p);
  float run = 0.0f;
  for (int32_t c = c0; c < c1; ++c) {
    run = __fadd_rn(run, x[c]);
    cs[c] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane > 0) {
    for (int32_t c = c0; c < c1; ++c) cs[c] = __fadd_rn(excl, cs[c]);
  }
  __syncwarp();
  const float total = cs[p - 1];

  float* o = out + row * NW;
  for (int32_t iw = 0; iw < NW; ++iw) {
    const int32_t w = widths[iw];
    float best = -INFINITY;
    for (int32_t j = lane; j < p; j += 32) {
      int32_t idx = j + w;  // boxcar covering phases [j+1, j+w]
      const bool wrap = idx >= p;
      if (wrap) idx -= p;
      const float dv =
          __fsub_rn(__fadd_rn(cs[idx], wrap ? total : 0.0f), cs[j]);
      best = fmaxf(best, dv);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) {
      const float hh = hc[(int64_t)b * NW + iw];
      const float bb = bc[(int64_t)b * NW + iw];
      const float num = __fsub_rn(__fmul_rn(__fadd_rn(hh, bb), best),
                                  __fmul_rn(bb, total));
      o[iw] = __fdiv_rn(num, sn);
    }
  }
}

}  // namespace

extern "C" {

int rt_snr_warps() { return kSnrWarps; }

int rt_max_dynamic_smem() { return kMaxDynamicSmem; }

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Once per process, when the library loads: let the kernels that take
// more than 48 KB of dynamic shared memory opt into the H100's 227 KB.
int rt_init() {
  const void* fns[] = {(const void*)boxcar_snr_kernel<false>,
                       (const void*)segment_cascade_kernel<true, false>,
                       (const void*)segment_cascade_kernel<false, false>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The segment kernel over D x ntiles blocks with `smem` bytes each.
// src (D, B, R, P) f32 for K2, else null and the wire (D, wrows, PW) u8
// + scales (D, stot) f32 with the host slice (roff, pr, soff) and, for
// K3, gms/gbase (B,) i32 and the guest slice (else null / ignored).
// tiles (ntiles, 4) i32; h/t/shift (L, B, R) i32 (levels 0..Lloc-1 are
// read); ms/ps (B,) i32; out (D, B, R, P) f32, not aliasing src.
// smem 0 selects the direct form: Lloc must be 0 and every tile one
// row (ops/plan.py::segment_plan).
int rt_segment_cascade(const void* src, const void* wire, const void* scales,
                       const void* tiles, int ntiles, const void* h,
                       const void* t, const void* shift, const void* ms,
                       const void* ps, const void* gms, const void* gbase,
                       void* out, long long D, int B, int R, int P, int Lloc,
                       int smem, long long wrows, int PW, long long stot,
                       long long roff, long long pr, long long soff,
                       long long groff, long long gpr, long long gsoff,
                       int mode, void* stream) {
  const int64_t blocks = D * ntiles;
  if (blocks == 0) return 0;
  const bool direct = smem == 0;
  if (direct && Lloc != 0) return (int)cudaErrorInvalidValue;
  const StageSlice host{roff, pr, soff};
  const StageSlice guest{groff, gpr, gsoff};
  const auto kernel =
      src == nullptr ? (direct ? segment_cascade_kernel<true, true>
                               : segment_cascade_kernel<true, false>)
                     : (direct ? segment_cascade_kernel<false, true>
                               : segment_cascade_kernel<false, false>);
  kernel<<<(unsigned)blocks, kSegThreads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const uint8_t*)wire, (const float*)scales,
      (const int32_t*)tiles, ntiles, (const int32_t*)h, (const int32_t*)t,
      (const int32_t*)shift, (const int32_t*)ms, (const int32_t*)ps,
      (const int32_t*)gms, (const int32_t*)gbase, (float*)out, B, R, P, Lloc,
      wrows, PW, stot, host, guest, mode);
  return (int)cudaGetLastError();
}

// Levels first..last-1 ping-ponging a -> b -> a ...; the result lies in a
// when last - first is even, else in b. Tables h/t/shift are (L, B, R)
// i32.
int rt_ffa_levels(void* a, void* b, const void* h, const void* t,
                  const void* shift, const void* ps, int first, int last,
                  long long D, int B, int R, int P, void* stream) {
  if (D * B == 0) return 0;
  const int32_t chunks = (int32_t)ceil_div(R, kLevelWarps);
  const int64_t blocks = D * B * chunks;
  const int64_t lvl = (int64_t)B * R;
  for (int l = first; l < last; ++l) {
    const bool even = (l - first) % 2 == 0;
    ffa_level_kernel<<<(unsigned)blocks, kLevelWarps * 32, 0,
                       (cudaStream_t)stream>>>(
        (const float*)(even ? a : b), (float*)(even ? b : a),
        (const int32_t*)h + l * lvl, (const int32_t*)t + l * lvl,
        (const int32_t*)shift + l * lvl, (const int32_t*)ps, B, R, P, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// in (D, B, R, P) f32, out (D, B, RE, NW) f32; widths (NW,) i32,
// hcoef/bcoef (B, NW) f32, stdnoise (B,) f32. gbase (B,) i32 and the
// guest's ghcoef/gbcoef/gstdnoise for a row-packed container, else null.
// `rows` rows (warps) a block with their prefix sums in rows * P floats
// of shared memory; or, with `scratch` (D * B * RE * P f32), kSnrWarps
// rows a block with their prefix sums there.
int rt_boxcar_snr(const void* in, void* out, const void* ps,
                  const void* widths, const void* hcoef, const void* bcoef,
                  const void* stdnoise, const void* gbase, const void* ghcoef,
                  const void* gbcoef, const void* gstdnoise, void* scratch,
                  int rows, long long D, int B, int R, int P, int RE, int NW,
                  void* stream) {
  const int64_t nrows = D * B * (int64_t)RE;
  if (nrows == 0) return 0;
  if (scratch != nullptr) rows = kSnrWarps;
  if (rows < 1 || rows > kSnrWarps) return (int)cudaErrorInvalidValue;
  const size_t smem =
      scratch == nullptr ? (size_t)rows * P * sizeof(float) : 0;
  const auto kernel = scratch == nullptr ? boxcar_snr_kernel<false>
                                          : boxcar_snr_kernel<true>;
  kernel<<<(unsigned)ceil_div(nrows, rows), rows * 32, smem,
           (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const int32_t*)ps,
      (const int32_t*)widths, (const float*)hcoef, (const float*)bcoef,
      (const float*)stdnoise, (const int32_t*)gbase, (const float*)ghcoef,
      (const float*)gbcoef, (const float*)gstdnoise, (float*)scratch, nrows,
      B, R, P, RE, NW);
  return (int)cudaGetLastError();
}

}  // extern "C"
