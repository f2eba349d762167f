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
// Each has a wide form (below, "Wide phases"). Where no row pair of two
// float32 buffers fits a block's shared memory (p > 14,528), the segment
// plan has no tile-local level and one-row tiles: segment_direct_kernel
// writes each row straight to the container and every level is a level
// launch. Containers wider than kNarrowP = 14,528 phases, the widest
// whose four rows of prefix sums fit a block's shared memory, take
// ffa_level_cols_kernel and snr_row_kernel: the container's width P
// alone picks the form. Every phase width up to 464,896 runs here.
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
// launch of a later stage also fills only a third of the SMs); and the
// global levels' traffic. The narrow S/N kernel keeps the sums' order
// in few shared-memory passes a row: the row is read coalesced into
// shared memory, each lane's in-order chunk scan runs skewed so that no
// two lanes touch one bank, and each lane keeps its phases' prefix sums
// in registers through the width loop (a form per bound on ceil(P / 32),
// 4 to 64 phases a lane, chosen from P at launch; past 2,048 phases they
// stay in shared memory). Its width loop then reads one shared float a
// window, and it is paced by that loop's instruction count and by its
// shared-memory reads.
//
// Wide phases. Past kNarrowP a plan's container holds few rows (a few
// hundred a stage) of tens of thousands of phases, so a warp a row
// leaves most of the card idle. segment_direct_kernel and
// ffa_level_cols_kernel cut each row into kColSpan-column blocks,
// kColPhases consecutive phases a thread (the head row and the output as
// float4 where P is a multiple of 4; the shifted tail row read scalar, at
// any alignment), thousands of blocks a launch; the arithmetic is
// fill_from_wire's and merge_row's. snr_row_kernel gives each
// evaluated row a block of kRowThreads threads, or a thread-block
// cluster of 2, 4 or 8 blocks where the row's prefix sums do not fit one
// block's shared memory (P > 58,112), each block holding a run of the
// row's 32 chunks and reading the others' through distributed shared
// memory. It keeps the narrow kernel's summation order: warp 0 scans
// each chunk in order, one lane a chunk, in place; the lanes start
// skewed by (lane * (chunk - 1)) mod 32 steps, so that at every step the
// 32 lanes touch 32 different banks whatever the chunk's length; every
// warp then reads the 32 chunk totals and runs the same shuffle scan, and
// all threads add the offsets. The window maximum is spread over all the
// threads of the block or cluster for every width; each warp's maximum
// goes into the row's output slot with an atomic max on an order-
// preserving integer key (fmaxf and max are exact in any order; at P =
// 58,112 the row alone fills a block's shared memory, so the partial
// maxima go through the output), and block 0 turns the maxima into S/N.
// No device scratch is allocated. What bounds them: the levels and the
// direct segment kernel stream bytes; the S/N's scan is 32 chains of
// ceil(p / 32) dependent adds a row, which the summation order fixes, so
// the adds' latency, not the bytes, paces it.
//
// Numerics. Built with --fmad=false, and the decode/S/N arithmetic is
// spelled with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn, so no product is
// contracted into an FMA: the decoded tile is bit identical to the
// plain _udecode_view + _pack, every container to the plain levels',
// and the S/N differs from the plain snr_batched only through the
// summation order of the prefix sum. That
// order depends on the trial's p alone (chunks of ceil(p / 32) phases per
// lane), never on the container's P or R, nor on the S/N kernel's form,
// so a trial's S/N is the same bits in any lane bucket, container
// height, pairing or register form.
//
// Interface. Plain extern "C" launchers (loaded with ctypes), each
// launching on the caller's stream and returning cudaGetLastError();
// rt_init sets the kernels' shared-memory limit once, when the library
// loads. Nothing here allocates or synchronises; the Python wrapper
// allocates every output with torch.empty.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSegThreads = 1024;  // threads per segment_cascade block
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kLevelWarps = 8;    // rows (one warp each) per ffa_level block
constexpr int kSnrWarps = 4;      // rows (one warp each) per boxcar_snr block
constexpr unsigned kFull = 0xffffffffu;
// The largest dynamic shared memory an H100 block may opt into.
constexpr int kMaxDynamicSmem = 232448;
// The widest container of the narrow forms: kSnrWarps rows of prefix
// sums fill a block's shared memory (14,528 phases).
constexpr int kNarrowP = kMaxDynamicSmem / (4 * kSnrWarps);
constexpr int kColThreads = 256;  // threads per ffa_level_cols block
constexpr int kColPhases = 4;     // consecutive phases per thread
constexpr int kColSpan = kColThreads * kColPhases;  // columns per block
constexpr int kRowThreads = 1024;  // threads per snr_row block
constexpr int kScanBatch = 16;     // phases a snr_row scan lane loads ahead
constexpr int kMaxCluster = 8;     // blocks per snr_row cluster at most

// Wire modes: the value is the mode's name suffix (uint6/uint8; any other
// value is uint12).
constexpr int kModeU6 = 6;
constexpr int kModeU8 = 8;

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Blocks of the wide S/N kernel a row of a P-phase container takes: the
// fewest of 1, 2, 4, 8 such that each block's share of the row's 32
// chunks of ceil(P / 32) phases fits its shared memory; 0 past that
// (P > 464,896).
inline int snr_blocks(int64_t P) {
  const int64_t chunk = ceil_div(P, 32);
  for (int n = 1; n <= kMaxCluster; n *= 2) {
    const int64_t held = 32 / n * chunk < P ? 32 / n * chunk : P;
    if (held * 4 <= kMaxDynamicSmem) return n;
  }
  return 0;
}

// Dynamic shared memory of one wide S/N block: its share of the row.
inline int snr_smem(int64_t P, int n) {
  const int64_t held = 32 / n * ceil_div(P, 32);
  return (int)(4 * (held < P ? held : P));
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
// Plans whose row pair does not fit a tile take segment_direct_kernel
// (below) instead.
template <bool kFromWire>
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
  float* buf = smem;
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

// Sample k of a stage (its view row k / PW, column k % PW) decoded from
// the wire, as fill_from_wire decodes it.
__device__ __forceinline__ float decode_sample(
    const uint8_t* __restrict__ wd, const float* __restrict__ sd,
    int32_t PW, StageSlice at, int32_t mode, int64_t vr, int32_t c) {
  const float scale = sd[vr];
  if (mode == kModeU8)
    return __fmul_rn(__fsub_rn((float)wd[(at.roff + vr) * PW + c], 128.0f),
                     scale);
  const bool u6 = mode == kModeU6;
  const int64_t row = u6 ? vr >> 2 : vr >> 1;
  const int32_t sub = (int32_t)(u6 ? vr & 3 : vr & 1);
  const uint8_t* q0 = wd + (at.roff + row) * PW + c;
  const int32_t b0 = q0[0], b1 = q0[at.pr * PW], b2 = q0[2 * at.pr * PW];
  float xq;
  if (u6) {
    const int32_t word = b0 | (b1 << 8) | (b2 << 16);
    xq = __fsub_rn((float)((word >> (6 * sub)) & 63), 32.0f);
  } else {
    const int32_t q = sub == 0 ? (b0 | ((b1 & 15) << 8))
                               : ((b1 >> 4) | (b2 << 4));
    xq = __fsub_rn((float)q, 2048.0f);
  }
  return __fmul_rn(xq, scale);
}

// The segment kernel's direct form, for plans whose row pair does not fit
// a tile (no tile-local level, one-row tiles, no shared memory): each
// tile's row is filled straight into its container row, over (tile) x
// column blocks as ffa_level_cols_kernel cuts a level; blockIdx.x = (d *
// ntiles + tile) * cols + column block, kColPhases consecutive phases a
// thread (float4 stores with kVec). A live row holds its host samples
// (rows below m_b, from the host slice), its guest samples (K3's rows
// [gbase_b, gbase_b + gm_b), from the guest slice) or zeros; from the
// packed container (K2) it is copied. Zero from p to P; a dead tile's row
// is zero.
template <bool kFromWire, bool kVec>
__global__ void __launch_bounds__(kColThreads) segment_direct_kernel(
    const float* __restrict__ src, const uint8_t* __restrict__ wire,
    const float* __restrict__ scales, const int32_t* __restrict__ tiles,
    int32_t ntiles, const int32_t* __restrict__ ms,
    const int32_t* __restrict__ ps, const int32_t* __restrict__ gms,
    const int32_t* __restrict__ gbase, float* __restrict__ out, int32_t B,
    int32_t R, int32_t P, int32_t cols, int64_t wrows, int32_t PW,
    int64_t stot, StageSlice host, StageSlice guest, int32_t mode) {
  const int64_t blk = blockIdx.x / cols;
  const int32_t c0 = (int32_t)(blockIdx.x - blk * cols) * kColSpan +
                     (int32_t)threadIdx.x * kColPhases;
  if (c0 >= P) return;
  const int64_t d = blk / ntiles;
  const int32_t* tile = tiles + 4 * (blk - d * ntiles);
  const int32_t b = tile[0], r = tile[1];
  const int64_t plane = d * B + b;
  float* o = out + (plane * R + r) * (int64_t)P;
  const int32_t p = ps[b];
  float v[kColPhases] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (tile[3] != 0) {
    if constexpr (kFromWire) {
      // Guest row r - gb (the guest's rows win, as segment_cascade_kernel
      // fills them last), or host row r; any other row is zero.
      const StageSlice* at = nullptr;
      int32_t k_row = 0;
      if (gbase != nullptr && gbase[b] >= 0 && r >= gbase[b] &&
          r < gbase[b] + gms[b]) {
        at = &guest, k_row = r - gbase[b];
      } else if (r < ms[b]) {
        at = &host, k_row = r;
      }
      if (at != nullptr) {
        const uint8_t* wd = wire + d * wrows * PW;
        const float* sd = scales + d * stot + at->soff;
        const int64_t k = (int64_t)k_row * p + c0;
        int64_t vr = k / PW;
        int32_t c = (int32_t)(k - vr * PW);
#pragma unroll
        for (int j = 0; j < kColPhases; ++j) {
          if (c0 + j < p) v[j] = decode_sample(wd, sd, PW, *at, mode, vr, c);
          if (++c == PW) c = 0, ++vr;
        }
      }
    } else {
      const float* s = src + (plane * R + r) * (int64_t)P;
      if constexpr (kVec) {
        const float4 q = *reinterpret_cast<const float4*>(s + c0);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < kColPhases; ++j)
          if (c0 + j < p) v[j] = s[c0 + j];
      }
#pragma unroll
      for (int j = 0; j < kColPhases; ++j)
        if (c0 + j >= p) v[j] = 0.0f;
    }
  }
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(o + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kColPhases; ++j)
      if (c0 + j < P) o[c0 + j] = v[j];
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

// The wide form of one FFA level (P > kNarrowP): merge_row's arithmetic
// over (plane, row) x column blocks; blockIdx.x = (plane * R + r) * cols
// + column block, so the blocks in flight walk each plane's rows in
// order. A thread takes kColPhases consecutive phases; with kVec (P a
// multiple of 4, both buffers 16-byte aligned) it reads the head row and
// writes the output as one float4 each.
template <bool kVec>
__global__ void __launch_bounds__(kColThreads) ffa_level_cols_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ h, const int32_t* __restrict__ t,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ ps,
    int32_t B, int32_t R, int32_t P, int32_t cols) {
  const int64_t row = blockIdx.x / cols;
  const int32_t c0 = (int32_t)(blockIdx.x - row * cols) * kColSpan +
                     (int32_t)threadIdx.x * kColPhases;
  if (c0 >= P) return;
  const int64_t plane = row / R;
  const int32_t r = (int32_t)(row - plane * R);
  const int32_t b = (int32_t)(plane % B);
  const int32_t p = ps[b];
  const int32_t Z = R - 1;
  const int64_t e = (int64_t)b * R + r;
  const int32_t hh = h[e];
  const int32_t tt = t[e];
  const float* src = in + plane * R * (int64_t)P;
  const float* hp = hh == Z ? nullptr : src + (int64_t)hh * P;
  const float* tp = tt == Z ? nullptr : src + (int64_t)tt * P;
  float* o = out + row * (int64_t)P;
  const int32_t s = shift[e] % p;
  float hv[kColPhases] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (hp != nullptr) {
    if constexpr (kVec) {
      const float4 q = *reinterpret_cast<const float4*>(hp + c0);
      hv[0] = q.x, hv[1] = q.y, hv[2] = q.z, hv[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kColPhases; ++j)
        if (c0 + j < p) hv[j] = hp[c0 + j];
    }
  }
  float v[kColPhases];
#pragma unroll
  for (int j = 0; j < kColPhases; ++j) {
    const int32_t c = c0 + j;
    v[j] = 0.0f;
    if (c >= p) continue;
    if (tp == nullptr) {
      if (hp != nullptr) v[j] = __fadd_rn(hv[j], 0.0f);
    } else {
      int32_t c2 = c + s;
      if (c2 >= p) c2 -= p;
      v[j] = __fadd_rn(hv[j], tp[c2]);
    }
  }
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(o + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kColPhases; ++j)
      if (c0 + j < P) o[c0 + j] = v[j];
  }
}

// An order-preserving map of floats onto unsigned integers (a < b as
// floats iff key(a) < key(b), -0 just below +0), and its inverse.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// n / d for 0 <= n < 2^31: (n * m) >> sh with sh = 31 + ceil(log2 d) and
// m = ceil(2^sh / d) < 2^32 (Granlund and Montgomery, 1994, theorem 4.2),
// built on the host once a launch.
struct RowDiv {
  uint32_t m, sh;
};

inline RowDiv row_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint32_t sh = 31 + l;
  return {(uint32_t)(((1ull << sh) + d - 1) / d), sh};
}

__device__ __forceinline__ uint32_t div_row(uint32_t n, RowDiv d) {
  return (uint32_t)(((uint64_t)n * d.m) >> d.sh);
}

// The narrow S/N's register form at container width P <= kNarrowP: the
// phases a lane keeps in registers, ceil(P / 32) rounded up to a multiple
// of kSnrRegsStep, or 0 past kSnrRegsMax (P > 2,048: the form that keeps
// them in shared memory alone).
constexpr int kSnrRegsStep = 4;
constexpr int kSnrRegsMax = 64;

__host__ __device__ constexpr int snr_regs(int64_t P) {
  return (P + 31) / 32 > kSnrRegsMax
             ? 0
             : (int)(((P + 31) / 32 + kSnrRegsStep - 1) / kSnrRegsStep *
                     kSnrRegsStep);
}

// One warp per evaluated row (d, b, r < RE), kSnrWarps rows a block (P
// <= kNarrowP), the row's inclusive prefix sums cs in the warp's P floats
// of shared memory. Steps, each closed by __syncwarp:
//   1. the row into shared memory, consecutive lanes on consecutive
//      phases (float4 where `vec`: P % 4 == 0 and an aligned container);
//   2. lane i scans chunk i, phases [i * chunk, (i + 1) * chunk) with
//      chunk = ceil(p / 32), in place and in order from a zero run.
//      Chunk i starts on bank i * chunk mod 32, which g lanes share (g =
//      the largest power of two dividing chunk, at most 32); lane i starts
//      (i * g) >> 5 steps late, so that at every step the 32 lanes touch
//      32 different banks, and the scan takes chunk + g - 1 steps. The
//      chunk totals go through the shuffle scan; chunk k > 0 then takes
//      the exclusive offset of the chunks before it;
//   3. each lane adds the offsets to phases j = lane + 32 k (consecutive
//      lanes on consecutive phases) and, in the register forms (kRegs >
//      0, kRegs >= ceil(P / 32)), keeps cs[j] in reg[k];
//   4. for each width w, the maximum over the p circular windows of
//      phases [j + 1, j + w]: (cs[j + w] - cs[j]) for the starts j < p - w
//      (lane's registers and one shared read a window), and (cs[e] + total)
//      - cs[e + p - w] for the windows that wrap, by their end e < w. The
//      warp's maximum (redux.sync on an order-preserving key) goes to lane
//      w mod 32, and lane by lane the widths' S/N ((h + b) * dmax - b *
//      total) / std (ops/snr.py) are written together.
// Bits: the chain of adds of each chunk, the shuffle scan and the offset
// adds are snr_row_kernel's, so every prefix sum has the wide form's
// bits (tests/test_torch_kernels_cuda.py). A window's value is the same
// __fsub_rn((cs[e] + (wrap ? total : +0)), cs[j]); the +0 of a window that
// does not wrap is left out, which changes no bit since no prefix sum is
// -0 (every one is a round-to-nearest sum that starts from +0) and the
// sum of a NaN is NaN either way. fmaxf and the integer maximum of the
// keys are exact in any order (no window difference is -0, no lane's
// maximum NaN). Widths are 1 <= w <= p, as ops/snr.py takes them. With
// gbase (row-packed containers; null otherwise), rows r >= gbase[b] >= 0
// take the guest trial's gh/gb/gstd instead.
template <int kRegs>
__global__ void __launch_bounds__(kSnrWarps * 32) boxcar_snr_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ ps, const int32_t* __restrict__ widths,
    const float* __restrict__ hcoef, const float* __restrict__ bcoef,
    const float* __restrict__ stdnoise, const int32_t* __restrict__ gbase,
    const float* __restrict__ ghcoef, const float* __restrict__ gbcoef,
    const float* __restrict__ gstdnoise, int64_t nrows, int32_t B,
    int32_t R, int32_t P, int32_t RE, int32_t NW, int32_t vec, RowDiv dre,
    RowDiv db) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kSnrWarps + warp;
  if (row >= nrows) return;  // whole warps leave together
  int64_t q;
  int32_t r, b;
  if (nrows <= INT32_MAX) {
    const uint32_t q32 = div_row((uint32_t)row, dre);
    r = (int32_t)((uint32_t)row - q32 * (uint32_t)RE);
    b = (int32_t)(q32 - div_row(q32, db) * (uint32_t)B);
    q = q32;
  } else {
    q = row / RE;
    r = (int32_t)(row - q * RE);
    b = (int32_t)(q % B);
  }
  const int32_t p = ps[b];
  const float* x = in + (q * R + r) * P;
  float* cs = smem + warp * P;
  const bool guest = gbase != nullptr && gbase[b] >= 0 && r >= gbase[b];
  const float* hc = (guest ? ghcoef : hcoef) + (int64_t)b * NW;
  const float* bc = (guest ? gbcoef : bcoef) + (int64_t)b * NW;
  const float sn = guest ? gstdnoise[b] : stdnoise[b];

  // 1. (A float4 load may read phases past p, never past P.)
  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(x);
    float4* cv = reinterpret_cast<float4*>(cs);
#pragma unroll 4
    for (int32_t i = lane; i < (p + 3) >> 2; i += 32) cv[i] = xv[i];
  } else {
#pragma unroll 4
    for (int32_t i = lane; i < p; i += 32) cs[i] = x[i];
  }
  __syncwarp();
  // 2. kScanBatch loads go ahead of their adds; a step outside the
  // lane's chunk adds +0.0f, which leaves the run as it is, and stores
  // nothing.
  const int32_t chunk = (p + 31) >> 5;
  const int32_t c0 = min(lane * chunk, p);
  const int32_t cn = min(c0 + chunk, p) - c0;
  const int32_t g = min(chunk & -chunk, 32);
  const int32_t late = (lane * g) >> 5;
  float run = 0.0f;
  for (int32_t t0 = -late; t0 < chunk + g - 1 - late; t0 += kScanBatch) {
    float v[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int32_t k = t0 + j;
      v[j] = (uint32_t)k < (uint32_t)cn ? cs[c0 + k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int32_t k = t0 + j;
      run = __fadd_rn(run, v[j]);
      if ((uint32_t)k < (uint32_t)cn) cs[c0 + k] = run;
    }
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  __syncwarp();
  // 3. Phase j lies in chunk j / chunk = umulhi(j, ceil(2^32 / chunk))
  // (exact for j < 2^16); a chunk of one phase is its own index.
  const uint32_t inv = 0xffffffffu / (uint32_t)chunk + 1u;
  const auto chunk_of = [&](uint32_t j) {
    return chunk == 1 ? j : __umulhi(j, inv);
  };
  float reg[kRegs > 0 ? kRegs : 1];
  if constexpr (kRegs > 0) {
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const uint32_t j = lane + 32 * k;
      const uint32_t ci = chunk_of(j);
      const float e = __shfl_sync(kFull, excl, ci);
      float v = 0.0f;
      if (j < (uint32_t)p) v = cs[j];
      if (ci > 0) v = __fadd_rn(e, v);
      if (j < (uint32_t)p) cs[j] = v;
      reg[k] = v;
    }
  } else {
#pragma unroll 4
    for (int32_t k = 0; k < chunk; ++k) {
      const uint32_t j = lane + 32 * k;
      const uint32_t ci = chunk_of(j);
      const float e = __shfl_sync(kFull, excl, ci);
      if (j < (uint32_t)p && ci > 0) cs[j] = __fadd_rn(e, cs[j]);
    }
  }
  __syncwarp();
  const float total = cs[p - 1];

  // 4.
  float* o = out + row * NW;
  for (int32_t i0 = 0; i0 < NW; i0 += 32) {
    const int32_t nw = min(NW - i0, 32);
    const bool mine = lane < nw;  // this lane writes width i0 + lane
    const int32_t wl = mine ? widths[i0 + lane] : 0;
    const float hh = mine ? hc[i0 + lane] : 0.0f;
    const float bb = mine ? bc[i0 + lane] : 0.0f;
    unsigned key = 0;
    for (int32_t i = 0; i < nw; ++i) {
      const int32_t w = __shfl_sync(kFull, wl, i);
      const float* hi = cs + lane + w;      // hi[32 k] = cs[j + w]
      const float* lo = cs + lane + p - w;  // lo[32 m] = cs[e + p - w]
      float best = -INFINITY;
      if constexpr (kRegs > 0) {
        const int32_t room = p - w - lane;  // j + w < p: 32 k < room
#pragma unroll
        for (int k = 0; k < kRegs; ++k)
          if (32 * k < room)
            best = fmaxf(best, __fsub_rn(hi[32 * k], reg[k]));
        const int32_t ends = w - lane;  // e < w: 32 m < ends
#pragma unroll
        for (int m = 0; m < kRegs; ++m) {
          if (32 * m >= w) break;
          if (32 * m < ends)
            best = fmaxf(best,
                         __fsub_rn(__fadd_rn(reg[m], total), lo[32 * m]));
        }
      } else {
#pragma unroll 4
        for (int32_t j = lane; j < p - w; j += 32)
          best = fmaxf(best, __fsub_rn(cs[j + w], cs[j]));
#pragma unroll 4
        for (int32_t e = lane; e < w; e += 32)
          best = fmaxf(best,
                       __fsub_rn(__fadd_rn(cs[e], total), cs[e + p - w]));
      }
      const unsigned top = __reduce_max_sync(kFull, order_key(best));
      if (lane == i) key = top;
    }
    if (mine) {
      const float num =
          __fsub_rn(__fmul_rn(__fadd_rn(hh, bb), key_value(key)),
                    __fmul_rn(bb, total));
      o[i0 + lane] = __fdiv_rn(num, sn);
    }
  }
}

// The wide S/N (P > kNarrowP): one evaluated row (d, b, r < RE) per
// block or, with kCluster, per cluster of n blocks (blockIdx.x = row * n
// + rank). The row's 32 chunks of ceil(p / 32) phases (the narrow
// kernel's) are split in order over the n blocks, 32 / n each; a block
// keeps its phases [lo, hi) of the prefix sums in shared memory. Steps,
// each closed by a barrier over the block or the cluster:
//   1. the block's phases of the row into shared memory (float4 where
//      aligned); block 0 sets the row's NW output slots to key(-inf);
//   2. warp 0 scans the block's chunks in place, lane i chunk i, each in
//      order from a zero run, the lanes skewed (header: conflict free);
//   3. every warp reads the 32 chunk totals (the scanned value at each
//      chunk's last phase, from the block holding it; 0 for an empty
//      chunk), runs the narrow kernel's shuffle scan on them and derives
//      the total, cs[p - 1], as the narrow kernel forms it;
//   4. all threads add chunk k's offset to its phases (k > 0);
//   5. for each width, every thread takes the block's phases strided,
//      reads cs[(j + w) mod p] locally or from the block holding it, and
//      each warp's maximum goes into the output slot by atomicMax on its
//      key;
//   6. block 0 turns each slot's maximum into the S/N, as the narrow
//      kernel does.
// `vec`: the container's rows start 16-byte aligned (P % 4 == 0).
template <bool kCluster>
__global__ void __launch_bounds__(kRowThreads) snr_row_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ ps, const int32_t* __restrict__ widths,
    const float* __restrict__ hcoef, const float* __restrict__ bcoef,
    const float* __restrict__ stdnoise, const int32_t* __restrict__ gbase,
    const float* __restrict__ ghcoef, const float* __restrict__ gbcoef,
    const float* __restrict__ gstdnoise, int32_t B, int32_t R, int32_t P,
    int32_t RE, int32_t NW, int32_t vec) {
  extern __shared__ float cs[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int32_t n = kCluster ? (int32_t)cluster.num_blocks() : 1;
  const int32_t rank = kCluster ? (int32_t)cluster.block_rank() : 0;
  const auto sync = [&]() {
    if constexpr (kCluster) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x / n;
  const int64_t q = row / RE;
  const int32_t r = (int32_t)(row - q * RE);
  const int32_t b = (int32_t)(q % B);
  const int32_t p = ps[b];
  const float* x = in + (q * R + r) * P;
  const int32_t chunk = (p + 31) / 32;
  const int32_t span = 32 / n * chunk;  // phases a block holds
  const int32_t lo = min(rank * span, p);
  const int32_t len = min(lo + span, p) - lo;
  unsigned* keys = reinterpret_cast<unsigned*>(out + row * NW);
  // Phase c of the row's prefix sums, from the block that holds it.
  const auto at = [&](int32_t c) -> float {
    if constexpr (kCluster) {
      if ((uint32_t)(c - lo) >= (uint32_t)len) {
        const int32_t owner = c / span;
        return cluster.map_shared_rank(cs, owner)[c - owner * span];
      }
    }
    return cs[c - lo];
  };

  // 1.
  int32_t i0 = 0;
  if (vec && (lo & 3) == 0) {
    const float4* xv = reinterpret_cast<const float4*>(x + lo);
    float4* cv = reinterpret_cast<float4*>(cs);
    i0 = len / 4 * 4;
    for (int32_t i = threadIdx.x; i < len / 4; i += blockDim.x) cv[i] = xv[i];
  }
  for (int32_t i = i0 + threadIdx.x; i < len; i += blockDim.x)
    cs[i] = x[lo + i];
  if (rank == 0)
    for (int32_t iw = threadIdx.x; iw < NW; iw += blockDim.x)
      atomicExch(keys + iw, order_key(-INFINITY));
  __syncthreads();
  // 2. kScanBatch loads are issued before their adds, so that the chain
  // of adds, not the loads' latency, paces the scan. A lane outside its
  // chunk adds +0.0f, which leaves its run as it is (a run that starts at
  // +0.0f is never -0.0f), and stores nothing.
  if (warp == 0) {
    const int32_t c0 = min((rank * (32 / n) + lane) * chunk, p);
    const int32_t cn = lane < 32 / n ? min(c0 + chunk, p) - c0 : 0;
    float* my = cs + (c0 - lo);
    const int32_t skew = (lane * (chunk - 1)) & 31;
    float run = 0.0f;
    for (int32_t it0 = -skew; it0 < chunk + 31 - skew; it0 += kScanBatch) {
      float v[kScanBatch];
#pragma unroll
      for (int j = 0; j < kScanBatch; ++j) {
        const int32_t k = it0 + j;
        v[j] = (uint32_t)k < (uint32_t)cn ? my[k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kScanBatch; ++j) {
        const int32_t k = it0 + j;
        run = __fadd_rn(run, v[j]);
        if ((uint32_t)k < (uint32_t)cn) my[k] = run;
      }
    }
  }
  sync();
  // 3.
  const int32_t g0 = min(lane * chunk, p);
  const int32_t g1 = min(g0 + chunk, p);
  const float tot = g1 > g0 ? at(g1 - 1) : 0.0f;
  float incl = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  const int32_t jl = (p - 1) / chunk;  // the chunk of phase p - 1
  const float tl = __shfl_sync(kFull, tot, jl);
  const float el = __shfl_sync(kFull, excl, jl);
  const float total = jl == 0 ? tl : __fadd_rn(el, tl);
  sync();  // every block has its totals before the offsets change them
  // 4. Chunk by chunk, so that a thread needs no division.
  for (int32_t g = rank * (32 / n); g < (rank + 1) * (32 / n); ++g) {
    const float e = __shfl_sync(kFull, excl, g);
    const int32_t c0 = min(g * chunk, p);
    const int32_t c1 = min(c0 + chunk, p);
    if (g == 0) continue;
    for (int32_t c = c0 + threadIdx.x; c < c1; c += blockDim.x)
      cs[c - lo] = __fadd_rn(e, cs[c - lo]);
  }
  sync();
  // 5. Phases whose window ends in this block's phases before p first
  // (two shared loads each), then the rest (the wrap, and windows ending
  // in another block).
  for (int32_t iw = 0; iw < NW; ++iw) {
    const int32_t w = widths[iw];
    const int32_t near = max(0, min(len, p - lo) - w);
    float best = -INFINITY;
#pragma unroll 4
    for (int32_t i = threadIdx.x; i < near; i += blockDim.x)
      best = fmaxf(best, __fsub_rn(__fadd_rn(cs[i + w], 0.0f), cs[i]));
    for (int32_t i = near + threadIdx.x; i < len; i += blockDim.x) {
      int32_t idx = lo + i + w;  // boxcar covering phases [j+1, j+w]
      const bool wrap = idx >= p;
      if (wrap) idx -= p;
      const float dv =
          __fsub_rn(__fadd_rn(at(idx), wrap ? total : 0.0f), cs[i]);
      best = fmaxf(best, dv);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) atomicMax(keys + iw, order_key(best));
  }
  sync();  // every maximum is in; no block reads another's memory after
  // 6.
  if (rank != 0) return;
  const bool guest = gbase != nullptr && gbase[b] >= 0 && r >= gbase[b];
  const float* hc = guest ? ghcoef : hcoef;
  const float* bc = guest ? gbcoef : bcoef;
  const float sn = guest ? gstdnoise[b] : stdnoise[b];
  for (int32_t iw = threadIdx.x; iw < NW; iw += blockDim.x) {
    const float best = key_value(atomicOr(keys + iw, 0u));
    const float hh = hc[(int64_t)b * NW + iw];
    const float bb = bc[(int64_t)b * NW + iw];
    const float num = __fsub_rn(__fmul_rn(__fadd_rn(hh, bb), best),
                                __fmul_rn(bb, total));
    out[row * NW + iw] = __fdiv_rn(num, sn);
  }
}

}  // namespace

extern "C" {

int rt_snr_warps() { return kSnrWarps; }

int rt_max_dynamic_smem() { return kMaxDynamicSmem; }

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of one level launch over a (D, B, R, P) container: kLevelWarps
// rows a block up to kNarrowP, else (rows) x ceil(P / kColSpan) column
// blocks.
long long rt_level_blocks(long long D, int B, int R, int P) {
  if (P <= kNarrowP) return D * B * ceil_div(R, kLevelWarps);
  return D * B * (int64_t)R * ceil_div(P, kColSpan);
}

// Blocks a cluster of the S/N kernel takes at width P (1: no cluster;
// 0: too wide), and the shared memory of each block. The narrow form (P
// <= kNarrowP) takes kSnrWarps rows a block, the wide form one row a
// block or cluster.
int rt_snr_blocks(long long P) { return P <= kNarrowP ? 1 : snr_blocks(P); }

// The narrow S/N's register form at width P (snr_regs; -1 past
// kNarrowP, where the wide kernel runs).
int rt_snr_regs(long long P) { return P <= kNarrowP ? snr_regs(P) : -1; }

int rt_snr_smem(long long P) {
  if (P <= kNarrowP) return kSnrWarps * (int)P * 4;
  const int n = snr_blocks(P);
  return n == 0 ? 0 : snr_smem(P, n);
}

// Once per process, when the library loads: let the kernels that take
// more than 48 KB of dynamic shared memory opt into the H100's 227 KB.
int rt_init() {
  const void* fns[] = {(const void*)boxcar_snr_kernel<0>,
                       (const void*)snr_row_kernel<false>,
                       (const void*)snr_row_kernel<true>,
                       (const void*)segment_cascade_kernel<true>,
                       (const void*)segment_cascade_kernel<false>};
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
// smem 0 selects the direct form, segment_direct_kernel over D x ntiles
// x ceil(P / kColSpan) blocks: Lloc must be 0 and every tile one row
// (ops/plan.py::segment_plan).
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
  const StageSlice host{roff, pr, soff};
  const StageSlice guest{groff, gpr, gsoff};
  if (smem == 0) {
    if (Lloc != 0) return (int)cudaErrorInvalidValue;
    const int32_t cols = (int32_t)ceil_div(P, kColSpan);
    const bool vec = P % 4 == 0 && ((uintptr_t)out & 15) == 0 &&
                     ((uintptr_t)src & 15) == 0;
    const auto kernel =
        src == nullptr ? (vec ? segment_direct_kernel<true, true>
                              : segment_direct_kernel<true, false>)
                       : (vec ? segment_direct_kernel<false, true>
                              : segment_direct_kernel<false, false>);
    kernel<<<(unsigned)(blocks * cols), kColThreads, 0,
             (cudaStream_t)stream>>>(
        (const float*)src, (const uint8_t*)wire, (const float*)scales,
        (const int32_t*)tiles, ntiles, (const int32_t*)ms,
        (const int32_t*)ps, (const int32_t*)gms, (const int32_t*)gbase,
        (float*)out, B, R, P, cols, wrows, PW, stot, host, guest, mode);
    return (int)cudaGetLastError();
  }
  const auto kernel = src == nullptr ? segment_cascade_kernel<true>
                                     : segment_cascade_kernel<false>;
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
// P > kNarrowP takes the wide form, ffa_level_cols_kernel (float4 where
// P % 4 == 0 and both buffers are 16-byte aligned).
int rt_ffa_levels(void* a, void* b, const void* h, const void* t,
                  const void* shift, const void* ps, int first, int last,
                  long long D, int B, int R, int P, void* stream) {
  if (D * B == 0) return 0;
  const int64_t blocks = rt_level_blocks(D, B, R, P);
  const int64_t lvl = (int64_t)B * R;
  const bool wide = P > kNarrowP;
  const int32_t chunks = (int32_t)ceil_div(R, kLevelWarps);
  const int32_t cols = (int32_t)ceil_div(P, kColSpan);
  const bool vec = P % 4 == 0 && ((uintptr_t)a & 15) == 0 &&
                   ((uintptr_t)b & 15) == 0;
  const auto wide_kernel = vec ? ffa_level_cols_kernel<true>
                               : ffa_level_cols_kernel<false>;
  for (int l = first; l < last; ++l) {
    const bool even = (l - first) % 2 == 0;
    const float* src = (const float*)(even ? a : b);
    float* dst = (float*)(even ? b : a);
    const int32_t* hl = (const int32_t*)h + l * lvl;
    const int32_t* tl = (const int32_t*)t + l * lvl;
    const int32_t* sl = (const int32_t*)shift + l * lvl;
    if (wide) {
      wide_kernel<<<(unsigned)blocks, kColThreads, 0, (cudaStream_t)stream>>>(
          src, dst, hl, tl, sl, (const int32_t*)ps, B, R, P, cols);
    } else {
      ffa_level_kernel<<<(unsigned)blocks, kLevelWarps * 32, 0,
                         (cudaStream_t)stream>>>(
          src, dst, hl, tl, sl, (const int32_t*)ps, B, R, P, chunks);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// in (D, B, R, P) f32, out (D, B, RE, NW) f32; widths (NW,) i32,
// hcoef/bcoef (B, NW) f32, stdnoise (B,) f32. gbase (B,) i32 and the
// guest's ghcoef/gbcoef/gstdnoise for a row-packed container, else null.
// P <= kNarrowP: kSnrWarps rows (warps) a block, their prefix sums in
// kSnrWarps * P floats of shared memory. Wider: snr_row_kernel, one row
// a block or a cluster of rt_snr_blocks(P) blocks (refused past 464,896).
int rt_boxcar_snr(const void* in, void* out, const void* ps,
                  const void* widths, const void* hcoef, const void* bcoef,
                  const void* stdnoise, const void* gbase, const void* ghcoef,
                  const void* gbcoef, const void* gstdnoise, long long D,
                  int B, int R, int P, int RE, int NW, void* stream) {
  const int64_t nrows = D * B * (int64_t)RE;
  if (nrows == 0) return 0;
  const size_t smem = (size_t)rt_snr_smem(P);
  const int32_t vec = P % 4 == 0 && ((uintptr_t)in & 15) == 0;
  if (P <= kNarrowP) {
    const unsigned blocks = (unsigned)ceil_div(nrows, kSnrWarps);
    const RowDiv dre = row_div((uint32_t)RE), db = row_div((uint32_t)B);
#define RT_SNR_FORM(K)                                                    \
  case K:                                                                 \
    boxcar_snr_kernel<K><<<blocks, kSnrWarps * 32, smem,                  \
                           (cudaStream_t)stream>>>(                       \
        (const float*)in, (float*)out, (const int32_t*)ps,                \
        (const int32_t*)widths, (const float*)hcoef, (const float*)bcoef, \
        (const float*)stdnoise, (const int32_t*)gbase,                    \
        (const float*)ghcoef, (const float*)gbcoef,                       \
        (const float*)gstdnoise, nrows, B, R, P, RE, NW, vec, dre, db);   \
    break;
    switch (snr_regs(P)) {
      RT_SNR_FORM(0)
      RT_SNR_FORM(4)
      RT_SNR_FORM(8)
      RT_SNR_FORM(12)
      RT_SNR_FORM(16)
      RT_SNR_FORM(20)
      RT_SNR_FORM(24)
      RT_SNR_FORM(28)
      RT_SNR_FORM(32)
      RT_SNR_FORM(36)
      RT_SNR_FORM(40)
      RT_SNR_FORM(44)
      RT_SNR_FORM(48)
      RT_SNR_FORM(52)
      RT_SNR_FORM(56)
      RT_SNR_FORM(60)
      RT_SNR_FORM(64)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef RT_SNR_FORM
    return (int)cudaGetLastError();
  }
  const int n = snr_blocks(P);
  if (n == 0) return (int)cudaErrorInvalidValue;
  if (n == 1) {
    snr_row_kernel<false><<<(unsigned)nrows, kRowThreads, smem,
                            (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, (const int32_t*)ps,
        (const int32_t*)widths, (const float*)hcoef, (const float*)bcoef,
        (const float*)stdnoise, (const int32_t*)gbase, (const float*)ghcoef,
        (const float*)gbcoef, (const float*)gstdnoise, B, R, P, RE, NW, vec);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nrows * n));
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, snr_row_kernel<true>, (const float*)in, (float*)out,
      (const int32_t*)ps, (const int32_t*)widths, (const float*)hcoef,
      (const float*)bcoef, (const float*)stdnoise, (const int32_t*)gbase,
      (const float*)ghcoef, (const float*)gbcoef, (const float*)gstdnoise, B,
      R, P, RE, NW, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
