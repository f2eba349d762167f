// Hopper (sm_90a) kernel of the device peak program's cluster step.
//
// What it replaces. No TPU kernel: the JAX package computes this step in
// plain jnp (riptide_tpu/search/peaks_device.py, PeakPlan._cluster_impl:
// cummax/cummin, a segmented jax.lax.associative_scan of the (S/N, trial)
// lexmax and jax.lax.top_k), and the port carried that over as plain
// PyTorch (riptide_tpu_torch/search/peaks_device.py, PeakPlan._cluster_impl
// over _thr_impl), which stays as the plain form for cubes on the CPU.
//
// Why it was added. On the card the plain form was the largest single
// cost of the peak program: it wrote a (D, NW, n) float32 threshold cube
// and several int64 index cubes, ran an 18-step log scan (three
// torch.cat and about ten elementwise launches a step) and a stable sort
// along every column. In a quickstart chunk (128 DM trials x 10 widths x
// 222,955 trials) it took 279 of the peak program's 306 ms of card time,
// more than all of the stage kernels K1 (247 ms), and 419 of 477 ms in an
// example_long chunk (13 widths x 257,783 trials), with
// elementwise_kernel and CatArrayBatchedCopy the largest device
// operations of the driver's traces.
//
// What it computes, per (DM trial, width) column of the transposed S/N
// cube s (D, NW, n): the f32 threshold thr[j] by Horner in log f (from 0,
// multiply by logf[j] and add each coefficient, two roundings, as the
// plain form's elementwise ops do; --fmad=false and the _rn intrinsics
// keep them unfused), the selected mask s > thr - EPS && s > smin - EPS
// and the sure mask s > thr + EPS && s > smin + EPS (the constants as the
// plain form rounds them to float32), marg = any selected point not sure,
// and the friends-of-friends clusters of the sure points in ascending
// trial order: a sure point j starts a cluster when it is the column's
// first or j > reach[previous sure point]. ncl counts the clusters; the
// first rep_cap clusters' representatives, the lexmax of (S/N, trial
// index) (equal S/N: the larger index), fill rep_idx / rep_val in
// ascending order, -1 / -inf in the empty slots. These are the plain
// form's four outputs bit for bit: the lexmax only selects, so its order
// of combination does not matter.
//
// Bound. Device-memory bytes: the cube is read once (4 bytes a cell)
// and a few words a column are written, 1.14 GB in a quickstart chunk
// (0.34 ms at 3.35 TB/s), 1.72 GB in an example_long one (0.51 ms). The
// threshold costs a handful of float operations a cell; logf (n floats,
// shared by every column) and reach come from the 50 MB L2.
//
// Design. One block per column, walking it in tiles of kTile trials in
// order; the cube is read with streaming loads, kItems independent 4-byte
// loads a thread a tile, neighbouring threads on neighbouring trials, so
// every warp access is one coalesced 128-byte line at any column offset
// (columns start at odd offsets when n is odd). Nothing of the cube is
// written back, and no (D, NW, n) intermediate exists. Sure points are
// sparse (tens to hundreds in a column of 2 x 10^5), so a tile without
// one costs its loads, the threshold and one __syncthreads_or. A tile with
// sure points compacts their indices and values into shared memory in
// trial order (a ballot and popcount a warp and row, and one warp's scan
// of the 64 row-warp counts), and warp 0 then resolves the list 32
// points at a time against the state it carries from the previous tile
// (the last sure index and its reach, the open cluster's running lexmax,
// ncl): each point's predecessor is its neighbour in the list, so heads
// are decided in parallel, a segmented warp scan gives every cluster's
// lexmax, and a head writes the representative of the cluster it
// closes. The open cluster is written after the last tile. A column of
// only sure points costs n / 32 warp steps, not a pathology.
//
// Interface. A plain extern "C" launcher (loaded with ctypes) that
// launches on the caller's stream and returns cudaGetLastError(); the
// Python wrapper (search/peaks_device.py, cluster_columns) checks the
// operands and allocates the outputs. Nothing here allocates or
// synchronises.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // a block: one column
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // trials a thread a tile
constexpr int kTile = kThreads * kItems;  // trials a tile
constexpr int kMaxCoef = 3;               // threshold degree <= 2
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems * kWarps == 64, "the offsets' scan takes two a lane");

// Whether (vb, ib) wins over (va, ia) in the lexmax of (S/N, trial
// index): a larger S/N, or an equal one at a larger index (the plain
// form's combine).
__device__ __forceinline__ bool takes(float vb, int ib, float va, int ia) {
  return vb > va || (vb == va && ib > ia);
}

__global__ void __launch_bounds__(kThreads)
    cluster_columns_kernel(const float* __restrict__ s,
                           const float* __restrict__ coef, int K,
                           const float* __restrict__ logf,
                           const int* __restrict__ reach, int n, float eps,
                           float smin_lo, float smin_hi, int rep_cap,
                           int* __restrict__ ncl_out,
                           unsigned char* __restrict__ marg_out,
                           long long* __restrict__ rep_idx,
                           float* __restrict__ rep_val) {
  __shared__ int s_idx[kTile];
  __shared__ float s_val[kTile];
  __shared__ int s_off[kItems * kWarps];
  __shared__ int s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long col = blockIdx.x;
  const float* x = s + col * (long long)n;
  float c[kMaxCoef];
#pragma unroll
  for (int q = 0; q < kMaxCoef; ++q) c[q] = q < K ? coef[col * K + q] : 0.0f;
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  long long* out_i = rep_idx + col * rep_cap;
  float* out_v = rep_val + col * rep_cap;
  // The column's state, carried from tile to tile by warp 0 (the same in
  // every lane): the last sure trial and its reach, the open cluster's
  // running lexmax (bv, bi), and the clusters started so far.
  int prev = -1, prev_reach = -1, ncl = 0, bi = -1;
  float bv = -INFINITY;
  bool marg = false;
  for (int base = 0; base < n; base += kTile) {
    float v[kItems];
    bool sure[kItems];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = base + k * kThreads + tid;
      v[k] = j < n ? __ldcs(x + j) : NAN;  // NaN: neither selected nor sure
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = base + k * kThreads + tid;
      const float lf = j < n ? __ldg(logf + j) : 0.0f;
      float thr = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCoef; ++q)
        if (q < K) thr = __fadd_rn(__fmul_rn(thr, lf), c[q]);
      const bool sel = v[k] > __fsub_rn(thr, eps) && v[k] > smin_lo;
      sure[k] = v[k] > __fadd_rn(thr, eps) && v[k] > smin_hi;
      marg = marg || (sel && !sure[k]);
      any = any || sure[k];
    }
    if (!__syncthreads_or(any)) continue;

    // Compact the tile's sure trials into s_idx / s_val in trial order:
    // trial base + k * kThreads + tid sits at flat position (k, warp,
    // lane), so a (row k, warp) count's exclusive prefix in (k, warp)
    // order plus the lanes below gives each one's place.
    unsigned m[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) m[k] = __ballot_sync(kFull, sure[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) s_off[k * kWarps + warp] = __popc(m[k]);
    }
    __syncthreads();
    if (warp == 0) {
      const int a = s_off[2 * lane], b = s_off[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      s_off[2 * lane] = incl - a - b;
      s_off[2 * lane + 1] = incl - b;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (sure[k]) {
        const int p = s_off[k * kWarps + warp] + __popc(m[k] & below);
        s_idx[p] = base + k * kThreads + tid;
        s_val[p] = v[k];
      }
    }
    __syncthreads();
    if (warp != 0) continue;  // the next tile's __syncthreads_or waits

    // Warp 0 resolves the list, 32 sure points at a time.
    const int total = s_total;
    for (int c0 = 0; c0 < total; c0 += 32) {
      const bool ok = c0 + lane < total;
      const int j = ok ? s_idx[c0 + lane] : 0;
      const float val = ok ? s_val[c0 + lane] : -INFINITY;
      const int rj = ok ? __ldg(reach + j) : 0;
      int pj = __shfl_up_sync(kFull, j, 1);
      int pr = __shfl_up_sync(kFull, rj, 1);
      if (lane == 0) {
        pj = prev;
        pr = prev_reach;
      }
      const bool head = ok && (pj < 0 || j > pr);
      const unsigned hm = __ballot_sync(kFull, head);
      // Each lane's running lexmax within its cluster; lane 0 continues
      // the open cluster unless it starts one.
      float sv = val;
      int si = ok ? j : -1;
      if (lane == 0 && ok && !head && !takes(val, j, bv, bi)) {
        sv = bv;
        si = bi;
      }
      bool f = head;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float ov = __shfl_up_sync(kFull, sv, o);
        const int oi = __shfl_up_sync(kFull, si, o);
        const bool of = __shfl_up_sync(kFull, (int)f, o) != 0;
        if (lane >= o && !f) {
          if (!takes(sv, si, ov, oi)) {
            sv = ov;
            si = oi;
          }
          f = of;
        }
      }
      // A head closes the cluster before it: its representative is the
      // running lexmax of the point before the head.
      float pv = __shfl_up_sync(kFull, sv, 1);
      int pi = __shfl_up_sync(kFull, si, 1);
      if (lane == 0) {
        pv = bv;
        pi = bi;
      }
      const int closing = ncl + __popc(hm & below) - 1;
      if (head && closing >= 0 && closing < rep_cap) {
        out_i[closing] = pi;
        out_v[closing] = pv;
      }
      ncl += __popc(hm);
      const int last = min(31, total - c0 - 1);
      prev = __shfl_sync(kFull, j, last);
      prev_reach = __shfl_sync(kFull, rj, last);
      bv = __shfl_sync(kFull, sv, last);
      bi = __shfl_sync(kFull, si, last);
    }
  }
  if (warp == 0) {
    if (lane == 0) {
      if (ncl > 0 && ncl - 1 < rep_cap) {
        out_i[ncl - 1] = bi;
        out_v[ncl - 1] = bv;
      }
      ncl_out[col] = ncl;
    }
    for (int q = min(ncl, rep_cap) + lane; q < rep_cap; q += 32) {
      out_i[q] = -1;
      out_v[q] = -INFINITY;
    }
  }
  marg = __syncthreads_or(marg);
  if (tid == 0) marg_out[col] = marg ? 1 : 0;
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Trials a block reads a tile.
int rt_cluster_tile() { return kTile; }

// The cluster step over `cols` columns of n trials: s (cols, n) float32,
// coef (cols, K) float32 with 1 <= K <= kMaxCoef, logf (n) float32, reach
// (n) int32; out ncl (cols) int32, marg (cols) bool, rep_idx (cols,
// rep_cap) int64, rep_val (cols, rep_cap) float32.
int rt_cluster_columns(const float* s, const float* coef, int K,
                       const float* logf, const int* reach, long long cols,
                       int n, float eps, float smin_lo, float smin_hi,
                       int rep_cap, int* ncl, unsigned char* marg,
                       long long* rep_idx, float* rep_val,
                       cudaStream_t stream) {
  if (cols <= 0) return 0;
  if (K < 1 || K > kMaxCoef || n < 1 || rep_cap < 0)
    return (int)cudaErrorInvalidValue;
  cluster_columns_kernel<<<(unsigned)cols, kThreads, 0, stream>>>(
      s, coef, K, logf, reach, n, eps, smin_lo, smin_hi, rep_cap, ncl, marg,
      rep_idx, rep_val);
  return (int)cudaGetLastError();
}

}  // extern "C"
