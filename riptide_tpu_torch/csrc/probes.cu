// Hopper (sm_90a) kernels of the chip probes P1-P3.
//
// What they replace. Three tools of the JAX package time Pallas
// primitives, each inside one TPU program over a VMEM-resident buffer:
//   P1  tools/ptime.py     (build :82, pallas_call :86): REPS = 32
//       repetitions of one pattern over a (2048, 384) float32 buffer (add,
//       lane and row rolls, select, the 9-step barrel shifter, the slot
//       interleave and its pltpu.repeat and parity-select variants, a
//       dynamic row roll, the stride roll, a tile sweep of add and roll)
//       and four (2048, 2048) @ (2048, 384) products;
//   P2  tools/ptime2.py    (build :22, pallas_call :28): NITER = 20000
//       passes of one body (add, roll1, rollrow, dynroll, select,
//       barrelbit) inside one launch;
//   P3  tools/probe1536.py (pallas_call :84, slot_level_kernel :49):
//       NITER = 32 slot-level passes (interleave, delta select, add) at
//       R = 1536, P = 384.
// The fused FFA kernel is built from these patterns; the kernels here do
// the same work on the card, so the probes time the card's primitives.
//
// Design, by how a pattern couples elements:
//   p1_point_kernel    one thread per element: the P1 patterns that read
//                      only x in every repetition (acc = acc + f(x, i))
//                      sum their REPS terms in a register, in the Pallas
//                      order.
//   p2_point_kernel    one thread per element: the P2 bodies with no
//                      coupling (add, select) run NITER passes in a
//                      register.
//   lane_loop_kernel   a tile of whole rows in shared memory, ping-ponged
//                      once a pass: the row-local patterns whose pass
//                      reads the previous pass (P1 barrel; P2 roll1,
//                      dynroll, barrelbit).
//   strip_loop_kernel  a strip of columns of one row group in shared
//                      memory, ping-ponged once a pass: the patterns that
//                      couple rows (P1 interleave, repeat_tpu and parity
//                      select; P2 rollrow, whose group is every row; P3's
//                      slot level). Each of them is column-local, so a
//                      narrow strip of a whole group fits in shared memory
//                      where the group's full width would not (one
//                      1536 x 384 float32 group is 2.25 MiB): every pass
//                      runs in one launch, with no grid-wide sync.
//   sgemm_kernel       a tiled float32 GEMM for P1's matmul: 64 x 64 block
//                      tiles, 16-deep k slices in shared memory, 4 x 4
//                      outputs a thread, SIMT FMAs; one launch a product.
//
// Bound. A P1 pattern reads x once and writes its output once (6.3 MB at
// (2048, 384)) against one or two operations per element and repetition:
// bound by bytes. P2 keeps the tile on chip for NITER passes of one or two
// operations per element: bound by operations. A P3 launch reads x and w
// and writes its output once against two operations per element and pass:
// bound by bytes. The matmul's M * N * K FMAs bound it by operations.
//
// Numerics. Built with --fmad=false, so acc * 1.0001f + x stays two
// roundings, as in PyTorch's separate kernels: every pattern but the
// matmul is bit identical to its plain version. The matmul's FMAs are
// explicit (__fmaf_rn); its epilogue (* alpha, then + beta) rounds twice,
// as the plain (a @ acc) * 0.001 + i does.
//
// Interface. Plain extern "C" launchers (loaded with ctypes), each
// launching on the caller's stream and returning cudaGetLastError(). A
// launcher takes a pattern code (rt_probe_code gives it by name). Nothing
// here allocates or synchronises; the Python wrappers allocate every
// output with torch.empty and choose the tiles.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;      // threads per block, all kernels but lane_loop
constexpr int kLaneThreads = 128;  // threads per lane_loop block (one row at a time)

enum Pattern : int {
  kAdd = 1,      // P1 kern_add / make_tile_add: acc * 1.0001 + x
  kRollLanes,    // P1 kern_roll / make_tile_roll: acc + roll(x, (7i + 1) % P, 1)
  kRollRows,     // P1 kern_roll_rows: acc + roll(x, (5i + 1) % ROWS, 0)
  kSelect,       // P1 kern_select: where(col < 11i % P, acc + 1, acc * 0.5)
  kDynRoll,      // P1 kern_dynroll: acc + roll(x, shifts[i % 8], 0)
  kStrideRoll,   // P1 kern_stride_roll: row r of x rolled by i % P + r
  kBarrel,       // P1 kern_barrel: step k rolls rows with bit k set by 2^k
  kInterleave,   // P1 kern_interleave: jnp.repeat halves of 8 groups
  kRepeatTpu,    // P1 kern_repeat_tpu: pltpu.repeat (a tile) of the halves
  kParity,       // P1 kern_repeat_flat: odd rows take the row above
  kAdd2,         // P2 body_add: acc * 1.0001 + 0.5
  kSelect2,      // P2 body_select: where(col < i % P, acc * 1.0001, acc)
  kRoll1,        // P2 body_roll: acc + roll(acc, 1, 1) * 1e-6
  kDynRoll2,     // P2 body_dynroll: acc + roll(acc, i % P, 1) * 1e-6
  kBarrelBit,    // P2 body_barrelbit: where(col & 3 == i & 3, roll(acc, 4, 1), acc)
  kRollRow,      // P2 body_rollrow: acc + roll(acc, 1, 0) * 1e-6
  kSlot,         // P3 _one_pass: interleave, delta select, add
};

struct Named {
  const char* name;
  int code;
};

constexpr Named kNames[] = {
    {"p1.add", kAdd},           {"p1.roll_lanes", kRollLanes},
    {"p1.roll_rows", kRollRows}, {"p1.select", kSelect},
    {"p1.dynroll", kDynRoll},   {"p1.stride_roll", kStrideRoll},
    {"p1.barrel", kBarrel},     {"p1.interleave", kInterleave},
    {"p1.repeat_tpu", kRepeatTpu}, {"p1.repeat_flat", kParity},
    {"p2.add", kAdd2},          {"p2.select", kSelect2},
    {"p2.roll1", kRoll1},       {"p2.dynroll", kDynRoll2},
    {"p2.barrelbit", kBarrelBit}, {"p2.rollrow", kRollRow},
    {"p3.slot", kSlot},
};

// a mod n in [0, n), for any int a (n > 0).
__device__ __forceinline__ int wrap(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// np.roll(v, s)[c] == v[(c - s) mod n]: the source index of a roll, for
// c and s in [0, n). No remainder: the patterns' inner loops call it for
// every element.
__device__ __forceinline__ int rolled(int c, int s, int n) {
  const int j = c - s;
  return j < 0 ? j + n : j;
}

template <int PAT>
__global__ void __launch_bounds__(kThreads) p1_point_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ shifts,
    float* __restrict__ out, int rows, int cols, int reps) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * cols) return;
  const int r = e / cols;
  const int c = e - r * cols;
  const int rc = r % cols;
  const float xe = x[e];
  float acc = xe;
  for (int i = 0; i < reps; ++i) {
    if (PAT == kAdd) {
      acc = acc * 1.0001f + xe;
    } else if (PAT == kRollLanes) {
      acc = acc + x[r * cols + rolled(c, (i * 7 + 1) % cols, cols)];
    } else if (PAT == kRollRows) {
      acc = acc + x[rolled(r, (i * 5 + 1) % rows, rows) * cols + c];
    } else if (PAT == kSelect) {
      acc = c < (i * 11) % cols ? acc + 1.0f : acc * 0.5f;
    } else if (PAT == kDynRoll) {
      acc = acc + x[rolled(r, wrap(shifts[i % 8], rows), rows) * cols + c];
    } else {  // kStrideRoll: shift i % cols, plus one per row (stride 1)
      acc = acc + x[r * cols + rolled(c, (i % cols + rc) % cols, cols)];
    }
  }
  out[e] = acc;
}

template <int PAT>
__global__ void __launch_bounds__(kThreads) p2_point_kernel(
    const float* __restrict__ x, float* __restrict__ out, int rows, int cols,
    int niter) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * cols) return;
  const int c = e % cols;
  float v = x[e];
  int m = 0;  // i % cols
#pragma unroll 4
  for (int i = 0; i < niter; ++i) {
    if (PAT == kAdd2) {
      v = v * 1.0001f + 0.5f;
    } else {  // kSelect2
      if (c < m) v = v * 1.0001f;
      if (++m == cols) m = 0;
    }
  }
  out[e] = v;
}

// `tr` whole rows from row blockIdx.x * tr, two buffers of tr * cols
// floats in dynamic shared memory; pass i reads one and writes the other.
template <int PAT>
__global__ void __launch_bounds__(kLaneThreads) lane_loop_kernel(
    const float* __restrict__ x, float* __restrict__ out, int rows, int cols,
    int tr, int passes) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + tr * cols;
  const int r0 = blockIdx.x * tr;
  const int nr = min(tr, rows - r0);
  for (int e = threadIdx.x; e < nr * cols; e += kLaneThreads)
    cur[e] = x[r0 * cols + e];
  __syncthreads();
  for (int i = 0; i < passes; ++i) {
    const int shift = (PAT == kBarrel    ? (1 << i)
                       : PAT == kRoll1   ? 1
                       : PAT == kDynRoll2 ? i
                                         : 4) % cols;  // kBarrelBit
    for (int lr = 0; lr < nr; ++lr) {
      const float* row = cur + lr * cols;
      const bool take = PAT == kBarrel ? ((r0 + lr) >> i) & 1 : true;
      for (int c = threadIdx.x; c < cols; c += kLaneThreads) {
        const float src = row[rolled(c, shift, cols)];
        float v = row[c];
        if (PAT == kBarrel) {
          if (take) v = src;
        } else if (PAT == kBarrelBit) {
          if ((c & 3) == (i & 3)) v = src;
        } else {  // kRoll1, kDynRoll2
          v = v + src * 1e-6f;
        }
        nxt[lr * cols + c] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int e = threadIdx.x; e < nr * cols; e += kLaneThreads)
    out[r0 * cols + e] = cur[e];
}

// Columns [c0, c0 + ct) (ct = 1 << lg) of the group of S rows from row
// g0: two buffers of S * ct floats (row-major, ct wide) in dynamic shared
// memory, plus S * ct int8 deltas for kSlot. Pass i reads one buffer and
// writes the other. Columns past `cols` are carried as zeros and never
// stored; only kParity may have a short last group (rows % S != 0).
template <int PAT>
__global__ void __launch_bounds__(kThreads) strip_loop_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ w,
    float* __restrict__ out, int rows, int cols, int S, int lg, int passes) {
  extern __shared__ float smem[];
  const int ct = 1 << lg;
  float* cur = smem;
  float* nxt = smem + S * ct;
  int8_t* delta = reinterpret_cast<int8_t*>(smem + 2 * S * ct);
  const int c0 = blockIdx.x * ct;
  const int g0 = blockIdx.y * S;
  const int n = min(S, rows - g0) << lg;
  const int half = S >> 1;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = c0 + (e & (ct - 1));
    const int gi = (g0 + (e >> lg)) * cols + c;
    cur[e] = c < cols ? x[gi] : 0.0f;
    if (PAT == kSlot) {
      // da = (w >> 22) & 3 selects the roll -delta with delta = da - 2
      // for da in {0, 1, 3}; da == 2 keeps the unrolled row.
      const int da = c < cols ? (w[gi] >> 22) & 3 : 2;
      delta[e] = (int8_t)(da == 2 ? 0 : da - 2);
    }
  }
  __syncthreads();
  for (int i = 0; i < passes; ++i) {
    const float fi = (float)i;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int s = e >> lg;
      const int cc = e & (ct - 1);
      float v;
      if (PAT == kInterleave) {  // jnp.repeat: row s of each half is s // 2
        v = (cur[((s >> 1) << lg) + cc] + cur[((half + (s >> 1)) << lg) + cc]) +
            fi;
      } else if (PAT == kRepeatTpu) {  // pltpu.repeat tiles: s mod (S / 2)
        const int h = s < half ? s : s - half;
        v = (cur[(h << lg) + cc] + cur[((half + h) << lg) + cc]) + fi;
      } else if (PAT == kParity) {  // even rows keep, odd take the row above
        v = cur[((s & ~1) << lg) + cc] + fi;
      } else if (PAT == kRollRow) {
        v = cur[e] + cur[((s == 0 ? S - 1 : s - 1) << lg) + cc] * 1e-6f;
      } else {  // kSlot: (s + delta) mod S with delta in [-2, 1]
        const int t = s + delta[e];
        const int src = t < 0 ? t + S : (t >= S ? t - S : t);
        v = cur[((src >> 1) << lg) + cc] + cur[((half + (s >> 1)) << lg) + cc];
      }
      nxt[e] = v;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = c0 + (e & (ct - 1));
    if (c < cols) out[(g0 + (e >> lg)) * cols + c] = cur[e];
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 16;

// C (M, N) = (A (M, K) @ B (K, N)) * alpha + beta. Block (bx, by) computes
// C[64 by : 64 by + 64, 64 bx : 64 bx + 64]; thread (tx, ty) of 16 x 16 the
// rows ty + 16 u and columns tx + 16 v (u, v < 4), so that a warp's shared
// memory reads are broadcasts or consecutive words.
__global__ void __launch_bounds__(kThreads) sgemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, float alpha, float beta) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int l = threadIdx.x; l < kBM * kBK; l += kThreads) {
      const int mm = l / kBK, kk = l % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = gm < M && gk < K ? A[(int64_t)gm * K + gk] : 0.0f;
    }
    for (int l = threadIdx.x; l < kBK * kBN; l += kThreads) {
      const int kk = l / kBN, nn = l % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = gk < K && gn < N ? B[(int64_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = As[kk][ty + 16 * j];
        b[j] = Bs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = __fmaf_rn(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gm = m0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gn = n0 + tx + 16 * v;
      if (gm < M && gn < N)
        C[(int64_t)gm * N + gn] = __fadd_rn(__fmul_rn(acc[u][v], alpha), beta);
    }
  }
}

// Opt `kernel` into `smem` bytes of dynamic shared memory above the 48 KB
// default, once per size: later launches of the same or a smaller size
// (and launches being captured into a CUDA graph) make no call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= 48 * 1024 || smem <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

template <int PAT>
int launch_lane(const float* x, float* out, int rows, int cols, int tr,
                int passes, cudaStream_t st) {
  static size_t allowed = 0;
  const size_t smem = 2 * (size_t)tr * cols * sizeof(float);
  const cudaError_t err = allow_smem(lane_loop_kernel<PAT>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  lane_loop_kernel<PAT><<<(rows + tr - 1) / tr, kLaneThreads, smem, st>>>(
      x, out, rows, cols, tr, passes);
  return (int)cudaGetLastError();
}

template <int PAT>
int launch_strip(const float* x, const int32_t* w, float* out, int rows,
                 int cols, int S, int lg, int passes, cudaStream_t st) {
  static size_t allowed = 0;
  const size_t cells = (size_t)S << lg;
  const size_t smem = cells * (2 * sizeof(float) + (PAT == kSlot ? 1 : 0));
  const cudaError_t err = allow_smem(strip_loop_kernel<PAT>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((cols >> lg) + ((cols & ((1 << lg) - 1)) != 0)),
                  (rows + S - 1) / S);
  strip_loop_kernel<PAT><<<grid, kThreads, smem, st>>>(x, w, out, rows, cols, S,
                                                       lg, passes);
  return (int)cudaGetLastError();
}

inline unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The pattern code of `name` ("p1.add", ...), or -1.
int rt_probe_code(const char* name) {
  for (const Named& n : kNames)
    if (strcmp(n.name, name) == 0) return n.code;
  return -1;
}

// x, out (rows, cols) f32; shifts (8,) i32 (kDynRoll only, else unused).
int rt_p1_point(int pat, const void* x, const void* shifts, void* out,
                int rows, int cols, int reps, void* stream) {
  const auto* xs = (const float*)x;
  const auto* sh = (const int32_t*)shifts;
  auto* o = (float*)out;
  const unsigned grid = blocks_for(rows * cols);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pat) {
#define P1_CASE(P)                                                           \
  case P:                                                                    \
    p1_point_kernel<P><<<grid, kThreads, 0, st>>>(xs, sh, o, rows, cols, reps); \
    break;
    P1_CASE(kAdd)
    P1_CASE(kRollLanes)
    P1_CASE(kRollRows)
    P1_CASE(kSelect)
    P1_CASE(kDynRoll)
    P1_CASE(kStrideRoll)
#undef P1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out (rows, cols) f32.
int rt_p2_point(int pat, const void* x, void* out, int rows, int cols,
                int niter, void* stream) {
  const auto* xs = (const float*)x;
  auto* o = (float*)out;
  const unsigned grid = blocks_for(rows * cols);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pat) {
    case kAdd2:
      p2_point_kernel<kAdd2><<<grid, kThreads, 0, st>>>(xs, o, rows, cols, niter);
      break;
    case kSelect2:
      p2_point_kernel<kSelect2><<<grid, kThreads, 0, st>>>(xs, o, rows, cols, niter);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out (rows, cols) f32; `tr` rows a block.
int rt_lane_loop(int pat, const void* x, void* out, int rows, int cols,
                 int tr, int passes, void* stream) {
  const auto* xs = (const float*)x;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pat) {
    case kBarrel: return launch_lane<kBarrel>(xs, o, rows, cols, tr, passes, st);
    case kRoll1: return launch_lane<kRoll1>(xs, o, rows, cols, tr, passes, st);
    case kDynRoll2: return launch_lane<kDynRoll2>(xs, o, rows, cols, tr, passes, st);
    case kBarrelBit: return launch_lane<kBarrelBit>(xs, o, rows, cols, tr, passes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out (rows, cols) f32; w (rows, cols) i32 (kSlot only, else unused);
// groups of S rows, strips of 1 << lg columns.
int rt_strip_loop(int pat, const void* x, const void* w, void* out, int rows,
                  int cols, int S, int lg, int passes, void* stream) {
  const auto* xs = (const float*)x;
  const auto* ws = (const int32_t*)w;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pat) {
    case kInterleave:
      return launch_strip<kInterleave>(xs, ws, o, rows, cols, S, lg, passes, st);
    case kRepeatTpu:
      return launch_strip<kRepeatTpu>(xs, ws, o, rows, cols, S, lg, passes, st);
    case kParity:
      return launch_strip<kParity>(xs, ws, o, rows, cols, S, lg, passes, st);
    case kRollRow:
      return launch_strip<kRollRow>(xs, ws, o, rows, cols, S, lg, passes, st);
    case kSlot:
      return launch_strip<kSlot>(xs, ws, o, rows, cols, S, lg, passes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// c (M, N) = (a (M, K) @ b (K, N)) * alpha + beta, all f32 row-major.
int rt_sgemm(const void* a, const void* b, void* c, int M, int N, int K,
             float alpha, float beta, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  sgemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K, alpha, beta);
  return (int)cudaGetLastError();
}

}  // extern "C"
