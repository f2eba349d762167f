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
// all ending in _cascade_body. Here the same work is four kernels:
//   decode_pack_kernel         the front half of K1 (_decode_planes +
//                              _pack_and_cascade's pack barrels);
//   decode_pack_paired_kernel  the front half of K3: the host rows from
//                              the host stage's wire slice, the guest
//                              rows [base, base + m_g) from the guest
//                              stage's slice of the same wire;
//   ffa_level_kernel           one FFA level, launched L times (the
//                              merge tree of K1, K2 and K3: a paired
//                              container's tables carry both trials);
//   boxcar_snr_kernel          the S/N epilogue of all three; rows at
//                              or above a trial's guest base take the
//                              guest's coefficients.
//
// Design. The Pallas kernels keep a (rows, P) container in VMEM and
// express every gather as dense rolls and selects (ops/slottables.py),
// because Mosaic cannot gather. A GPU reads by index natively, so the
// level kernel executes the (h, t, shift) tables of ops/plan.py directly,
// as the plain PyTorch _level_step does:
//   out[d,b,r,c] = c < p_b ? in[d,b,h[r],c] + in[d,b,t[r],(c+shift[r]) % p_b] : 0
// One float add per element, in the same tree, so the container is bit
// identical to the plain version's. K3 needs no level kernel of its own:
// the guest's tables are its own tree shifted up by its base row, with
// its zero row mapped to the container's zero row (ops/plan.py).
//
// Bound. Each level reads two containers' worth of rows and writes one,
// at one add per element, so the merge tree is bound by device-memory
// bytes, not by operations. This first version ping-pongs two (D, B, R, P)
// float32 buffers in global memory and relies on the 50 MB L2 for the
// re-read rows; tiling the low levels in shared memory
// (parallel/seqffa.py's row tiles), TMA and fusing levels are later work.
// decode_pack writes the container once from 3/4 byte per sample of wire;
// boxcar_snr reads it once and writes NW floats per evaluated row.
//
// Numerics. Built with --fmad=false, and the decode/S/N arithmetic is
// spelled with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn, so no product is
// contracted into an FMA: the decoded container is bit identical to the
// plain _udecode_view + _pack, and the S/N differs from the plain
// snr_batched only through the summation order of the prefix sum. That
// order depends on the trial's p alone (chunks of ceil(p / 32) phases per
// lane), never on the container's P or R, so a trial's S/N is the same
// bits in any lane bucket, container height or pairing.
//
// Interface. Plain extern "C" launchers (loaded with ctypes), each
// launching on the caller's stream and returning cudaGetLastError().
// Nothing here allocates or synchronises; the Python wrapper allocates
// every output with torch.empty.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block of the elementwise kernels
constexpr int kSnrWarps = 4;    // rows (one warp each) per boxcar_snr block
constexpr unsigned kFull = 0xffffffffu;

// Wire modes: the value is the mode's name suffix (uint6/uint8; any other
// value is uint12).
constexpr int kModeU6 = 6;
constexpr int kModeU8 = 8;

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Sample k of a stage whose byte planes start at wire row roff (pr rows
// per plane) and whose per-row scales start at sd: view row r, lane c.
__device__ __forceinline__ float decode_sample(
    const uint8_t* __restrict__ wd, const float* __restrict__ sd, int64_t k,
    int32_t PW, int64_t roff, int64_t pr, int32_t mode) {
  const int64_t r = k / PW;
  const int64_t c = k - r * PW;
  float xq;
  if (mode == kModeU8) {
    xq = __fsub_rn((float)wd[(roff + r) * PW + c], 128.0f);
  } else {
    // `group` consecutive view rows share one byte-plane row; the three
    // planes of the stage sit pr rows apart.
    const int64_t group = mode == kModeU6 ? 4 : 2;
    const int64_t row = r / group;
    const int32_t sub = (int32_t)(r - row * group);
    const int32_t b0 = wd[(roff + row) * PW + c];
    const int32_t b1 = wd[(roff + pr + row) * PW + c];
    const int32_t b2 = wd[(roff + 2 * pr + row) * PW + c];
    if (mode == kModeU6) {
      const int32_t word = b0 | (b1 << 8) | (b2 << 16);
      xq = __fsub_rn((float)((word >> (6 * sub)) & 63), 32.0f);
    } else {
      const int32_t q = sub == 0 ? (b0 | ((b1 & 15) << 8))
                                 : ((b1 >> 4) | (b2 << 4));
      xq = __fsub_rn((float)q, 2048.0f);
    }
  }
  return __fmul_rn(xq, sd[r]);
}

// One (d, b) plane per blockIdx.x; blockIdx.y and the loop stride cover
// the plane's R * P elements. container[i, j] = view_flat[i * p + j].
__global__ void decode_pack_kernel(
    const uint8_t* __restrict__ wire, const float* __restrict__ scales,
    const int32_t* __restrict__ ms, const int32_t* __restrict__ ps,
    float* __restrict__ out, int32_t B, int32_t R, int32_t P, int64_t wrows,
    int32_t PW, int64_t stot, int64_t roff, int64_t pr, int64_t soff,
    int32_t mode) {
  const int64_t plane = blockIdx.x;
  const int64_t d = plane / B;
  const int32_t b = (int32_t)(plane - d * B);
  const int32_t m = ms[b];
  const int32_t p = ps[b];
  const int64_t RP = (int64_t)R * P;
  const uint8_t* wd = wire + d * wrows * PW;
  const float* sd = scales + d * stot + soff;
  float* od = out + plane * RP;
  for (int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; e < RP;
       e += (int64_t)gridDim.y * blockDim.x) {
    const int32_t i = (int32_t)(e / P);
    const int32_t j = (int32_t)(e - (int64_t)i * P);
    float v = 0.0f;
    if (i < m && j < p)
      v = decode_sample(wd, sd, (int64_t)i * p + j, PW, roff, pr, mode);
    od[e] = v;
  }
}

// decode_pack_kernel for a row-packed container: rows [0, m_b) from the
// host stage (roff, pr, soff), rows [gbase_b, gbase_b + gm_b) from the
// guest stage (groff, gpr, gsoff) of the same wire, zero elsewhere
// (gbase_b < 0: no guest on trial b).
__global__ void decode_pack_paired_kernel(
    const uint8_t* __restrict__ wire, const float* __restrict__ scales,
    const int32_t* __restrict__ ms, const int32_t* __restrict__ ps,
    const int32_t* __restrict__ gms, const int32_t* __restrict__ gbase,
    float* __restrict__ out, int32_t B, int32_t R, int32_t P, int64_t wrows,
    int32_t PW, int64_t stot, int64_t roff, int64_t pr, int64_t soff,
    int64_t groff, int64_t gpr, int64_t gsoff, int32_t mode) {
  const int64_t plane = blockIdx.x;
  const int64_t d = plane / B;
  const int32_t b = (int32_t)(plane - d * B);
  const int32_t m = ms[b];
  const int32_t p = ps[b];
  const int32_t gb = gbase[b];
  const int32_t gm = gb < 0 ? 0 : gms[b];
  const int64_t RP = (int64_t)R * P;
  const uint8_t* wd = wire + d * wrows * PW;
  const float* sd = scales + d * stot + soff;
  const float* gsd = scales + d * stot + gsoff;
  float* od = out + plane * RP;
  for (int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; e < RP;
       e += (int64_t)gridDim.y * blockDim.x) {
    const int32_t i = (int32_t)(e / P);
    const int32_t j = (int32_t)(e - (int64_t)i * P);
    float v = 0.0f;
    if (j < p) {
      if (i < m)
        v = decode_sample(wd, sd, (int64_t)i * p + j, PW, roff, pr, mode);
      else if (i >= gb && i - gb < gm)
        v = decode_sample(wd, gsd, (int64_t)(i - gb) * p + j, PW, groff, gpr,
                          mode);
    }
    od[e] = v;
  }
}

__global__ void ffa_level_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ h, const int32_t* __restrict__ t,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ ps,
    int32_t B, int32_t R, int32_t P) {
  const int64_t plane = blockIdx.x;
  const int32_t b = (int32_t)(plane % B);
  const int32_t p = ps[b];
  const int64_t RP = (int64_t)R * P;
  const float* src = in + plane * RP;
  float* dst = out + plane * RP;
  const int32_t* hb = h + (int64_t)b * R;
  const int32_t* tb = t + (int64_t)b * R;
  const int32_t* sb = shift + (int64_t)b * R;
  for (int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; e < RP;
       e += (int64_t)gridDim.y * blockDim.x) {
    const int32_t i = (int32_t)(e / P);
    const int32_t j = (int32_t)(e - (int64_t)i * P);
    float v = 0.0f;
    if (j < p) {
      const int32_t c2 = (j + sb[i]) % p;
      v = __fadd_rn(src[(int64_t)hb[i] * P + j], src[(int64_t)tb[i] * P + c2]);
    }
    dst[e] = v;
  }
}

// One warp per evaluated row (d, b, r < RE). The row's inclusive prefix
// sum lives in shared memory (P floats per warp): each lane scans a
// contiguous chunk, a shuffle scan adds the chunk offsets. Then for
// each width the warp takes the maximum over the p phases of the
// circular window sum cs[(j + w) mod p] (+ total on wrap) - cs[j], and
// lane 0 writes ((h + b) * dmax - b * total) / std (ops/snr.py). With
// gbase (row-packed containers; null otherwise), rows r >= gbase[b] >= 0
// take the guest trial's gh/gb/gstd instead.
__global__ void boxcar_snr_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const int32_t* __restrict__ ps, const int32_t* __restrict__ widths,
    const float* __restrict__ hcoef, const float* __restrict__ bcoef,
    const float* __restrict__ stdnoise, const int32_t* __restrict__ gbase,
    const float* __restrict__ ghcoef, const float* __restrict__ gbcoef,
    const float* __restrict__ gstdnoise, int64_t nrows, int32_t B, int32_t R,
    int32_t P, int32_t RE, int32_t NW) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kSnrWarps + warp;
  if (row >= nrows) return;  // whole warps leave together
  const int64_t q = row / RE;
  const int32_t r = (int32_t)(row - q * RE);
  const int32_t b = (int32_t)(q % B);
  const int32_t p = ps[b];
  const float* x = in + (q * R + r) * P;
  float* cs = smem + warp * P;
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

dim3 plane_grid(int64_t planes, int64_t per_plane) {
  const int64_t y = ceil_div(per_plane, kThreads);
  return dim3((unsigned)planes, (unsigned)(y < 65535 ? y : 65535));
}

}  // namespace

extern "C" {

int rt_snr_warps() { return kSnrWarps; }

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// wire (D, wrows, PW) u8, scales (D, stot) f32, ms/ps (B,) i32,
// out (D, B, R, P) f32.
int rt_decode_pack(const void* wire, const void* scales, const void* ms,
                   const void* ps, void* out, long long D, int B, int R, int P,
                   long long wrows, int PW, long long stot, long long roff,
                   long long pr, long long soff, int mode, void* stream) {
  if (D * B == 0) return 0;
  decode_pack_kernel<<<plane_grid(D * B, (int64_t)R * P), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (const float*)scales, (const int32_t*)ms,
      (const int32_t*)ps, (float*)out, B, R, P, wrows, PW, stot, roff, pr,
      soff, mode);
  return (int)cudaGetLastError();
}

// As rt_decode_pack, plus gms/gbase (B,) i32 and the guest stage's wire
// row offset, plane rows and scale row offset.
int rt_decode_pack_paired(const void* wire, const void* scales, const void* ms,
                          const void* ps, const void* gms, const void* gbase,
                          void* out, long long D, int B, int R, int P,
                          long long wrows, int PW, long long stot,
                          long long roff, long long pr, long long soff,
                          long long groff, long long gpr, long long gsoff,
                          int mode, void* stream) {
  if (D * B == 0) return 0;
  decode_pack_paired_kernel<<<plane_grid(D * B, (int64_t)R * P), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (const float*)scales, (const int32_t*)ms,
      (const int32_t*)ps, (const int32_t*)gms, (const int32_t*)gbase,
      (float*)out, B, R, P, wrows, PW, stot, roff, pr, soff, groff, gpr, gsoff,
      mode);
  return (int)cudaGetLastError();
}

// L levels ping-ponging a -> b -> a ...; the result lies in a when L is
// even, else in b. Tables h/t/shift are (L, B, R) i32.
int rt_ffa_levels(void* a, void* b, const void* h, const void* t,
                  const void* shift, const void* ps, int L, long long D, int B,
                  int R, int P, void* stream) {
  if (D * B == 0) return 0;
  const dim3 grid = plane_grid(D * B, (int64_t)R * P);
  const int64_t lvl = (int64_t)B * R;
  for (int l = 0; l < L; ++l) {
    const float* src = (const float*)(l % 2 == 0 ? a : b);
    float* dst = (float*)(l % 2 == 0 ? b : a);
    ffa_level_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, dst, (const int32_t*)h + l * lvl, (const int32_t*)t + l * lvl,
        (const int32_t*)shift + l * lvl, (const int32_t*)ps, B, R, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// in (D, B, R, P) f32, out (D, B, RE, NW) f32; widths (NW,) i32,
// hcoef/bcoef (B, NW) f32, stdnoise (B,) f32. gbase (B,) i32 and the
// guest's ghcoef/gbcoef/gstdnoise for a row-packed container, else null.
int rt_boxcar_snr(const void* in, void* out, const void* ps,
                  const void* widths, const void* hcoef, const void* bcoef,
                  const void* stdnoise, const void* gbase, const void* ghcoef,
                  const void* gbcoef, const void* gstdnoise, long long D,
                  int B, int R, int P, int RE, int NW, void* stream) {
  const int64_t nrows = D * B * (int64_t)RE;
  if (nrows == 0) return 0;
  const size_t smem = (size_t)kSnrWarps * P * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        boxcar_snr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  boxcar_snr_kernel<<<(unsigned)ceil_div(nrows, kSnrWarps), kSnrWarps * 32,
                      smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const int32_t*)ps,
      (const int32_t*)widths, (const float*)hcoef, (const float*)bcoef,
      (const float*)stdnoise, (const int32_t*)gbase, (const float*)ghcoef,
      (const float*)gbcoef, (const float*)gstdnoise, nrows, B, R, P, RE, NW);
  return (int)cudaGetLastError();
}

}  // extern "C"
