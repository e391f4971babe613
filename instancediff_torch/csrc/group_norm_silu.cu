// GroupNorm (+ SiLU) over NHWC activations, in two launches.
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:group_norm_silu (Pallas
// kernel _gns_kernel). It computes, for each (b, g) with Cg = C / G channels
// per group and n = H * W * Cg,
//
//   mean = sum(x) / n,  var = sum(x^2) / n - mean^2,  rstd = rsqrt(var + eps)
//   y    = ((x - mean) * rstd) * gamma[c] + beta[c],  then y * sigmoid(y) if silu
//
// with fp32 statistics and arithmetic, rounded once to T (bf16 or fp32) on
// store: the numerics of group_norm_silu_reference (E[x^2] - mean^2, not
// Welford).
//
// What bounds it on the H100: bytes. It does a few operations per element
// and must read x once and write y once (4 bytes per element in bf16), so the
// bound is 2 * |x| over the memory rate; this design reads x twice (once per
// launch), so its own floor is 1.5x that.
//
// Design. The Pallas kernel carries the group sums from phase 0 to phase 1 in
// VMEM scratch across a sequential grid; blocks on the H100 run in no order
// and share nothing, so the two phases are two launches:
//   gns_stats: block (chunk, b) reads rows [chunk * rows, ...) of batch b, all
//     C channels of a row contiguously (16-byte loads where C allows), keeps
//     fp32 per-channel sum / sum of squares in registers, reduces them across
//     the block's row groups in shared memory, and writes them to
//     partials[b, chunk, c, 0:2]. Per-channel, not per-group: a 16-byte bf16
//     load spans 8 channels, which straddle groups where Cg = 6 or 22.
//   gns_apply: block (chunk, b) first folds partials[b, :, :, :] into
//     per-channel sums, then into per-group mean / rstd, in shared memory,
//     then streams its rows, normalising, applying the affine and SiLU.
// No atomics: every sum is taken in a fixed order, so results repeat bit for
// bit. The chunk count (chosen by the wrapper) keeps the fold's reads of the
// partials, which come from L2, near an eighth of the rows' bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// VEC consecutive elements of T moved as one load / store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The (column, row group) layout shared by both kernels: V = C / VEC vector
// columns; RG = NT / V row groups when a row fits the block, else 1. Work
// item i in [0, V * RG) is column i % V, row group i / V.
struct Layout {
  int V, RG, rows, r0, r1;
};

__device__ __forceinline__ Layout layout(int HW, int C, int chunks, int vec) {
  Layout L;
  L.V = C / vec;
  L.RG = L.V >= NT ? 1 : NT / L.V;
  L.rows = (HW + chunks - 1) / chunks;
  L.r0 = blockIdx.x * L.rows;
  L.r1 = min(HW, L.r0 + L.rows);
  return L;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT) gns_stats_kernel(const T* __restrict__ x,
                                                       float* __restrict__ partials, int HW,
                                                       int C, int chunks) {
  extern __shared__ float red[];  // [RG][C][2] when RG > 1
  const Layout L = layout(HW, C, chunks, VEC);
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * HW * C;
  float* pout = partials + ((size_t)b * chunks + blockIdx.x) * C * 2;

  for (int i = threadIdx.x; i < L.V * L.RG; i += NT) {
    const int cv = i % L.V, rg = i / L.V;
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    for (int r = L.r0 + rg; r < L.r1; r += L.RG) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + (size_t)r * C + cv * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(p.v[j]);
        s[j] += f;
        q[j] = fmaf(f, f, q[j]);
      }
    }
    float* dst = L.RG > 1 ? red + (size_t)rg * C * 2 : pout;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dst[(cv * VEC + j) * 2] = s[j];
      dst[(cv * VEC + j) * 2 + 1] = q[j];
    }
  }
  if (L.RG == 1) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f, q = 0.f;
    for (int rg = 0; rg < L.RG; ++rg) {
      s += red[((size_t)rg * C + c) * 2];
      q += red[((size_t)rg * C + c) * 2 + 1];
    }
    pout[c * 2] = s;
    pout[c * 2 + 1] = q;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT) gns_apply_kernel(const T* __restrict__ x,
                                                       const float* __restrict__ partials,
                                                       const float* __restrict__ gamma,
                                                       const float* __restrict__ beta,
                                                       T* __restrict__ out, int HW, int C, int G,
                                                       int chunks, float eps, int silu) {
  extern __shared__ float sm[];  // colsum[C], colsq[C], mean[G], rstd[G]
  float* colsum = sm;
  float* colsq = sm + C;
  float* gmean = sm + 2 * C;
  float* grstd = sm + 2 * C + G;
  const Layout L = layout(HW, C, chunks, VEC);
  const int b = blockIdx.y;
  const int Cg = C / G;

  // fold the chunks' partials: per channel, then per group
  const float2* pb = reinterpret_cast<const float2*>(partials) + (size_t)b * chunks * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float2 p = pb[(size_t)k * C + c];
      s += p.x;
      q += p.y;
    }
    colsum[c] = s;
    colsq[c] = q;
  }
  __syncthreads();
  const float n = (float)HW * (float)Cg;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s = 0.f, q = 0.f;
    for (int c = g * Cg; c < (g + 1) * Cg; ++c) {
      s += colsum[c];
      q += colsq[c];
    }
    const float mean = s / n;
    const float var = q / n - mean * mean;
    gmean[g] = mean;
    grstd[g] = rsqrtf(var + eps);
  }
  __syncthreads();

  const T* xb = x + (size_t)b * HW * C;
  T* ob = out + (size_t)b * HW * C;
  for (int i = threadIdx.x; i < L.V * L.RG; i += NT) {
    const int cv = i % L.V, rg = i / L.V;
    float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = cv * VEC + j;
      mu[j] = gmean[c / Cg];
      rs[j] = grstd[c / Cg];
      ga[j] = gamma[c];
      be[j] = beta[c];
    }
    for (int r = L.r0 + rg; r < L.r1; r += L.RG) {
      const size_t off = (size_t)r * C + cv * VEC;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + off);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float y = (to_f(p.v[j]) - mu[j]) * rs[j];
        y = y * ga[j] + be[j];
        if (silu) y = y / (1.f + expf(-y));
        put(&o.v[j], y);
      }
      *reinterpret_cast<Pack<T, VEC>*>(ob + off) = o;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The widest vector (16 bytes, or 1 element) that C and the pointers allow.
template <typename T>
int vec_width(int C, const void* a, const void* b) {
  constexpr int V16 = 16 / sizeof(T);
  return (C % V16 == 0 && aligned16(a) && (b == nullptr || aligned16(b))) ? V16 : 1;
}

size_t stats_smem(int C, int vec) {
  const int V = C / vec;
  const int RG = V >= NT ? 1 : NT / V;
  return RG > 1 ? (size_t)RG * C * 2 * sizeof(float) : 0;
}

// Dynamic shared memory past 48 KB must be allowed per kernel first.
template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int VEC>
int stats_launch(const void* x, void* partials, int B, int HW, int C, int chunks,
                 cudaStream_t s) {
  const size_t smem = stats_smem(C, VEC);
  const cudaError_t e = allow_smem(gns_stats_kernel<T, VEC>, smem);
  if (e != cudaSuccess) return (int)e;
  gns_stats_kernel<T, VEC><<<dim3(chunks, B), NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<float*>(partials), HW, C, chunks);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply_launch(const void* x, const void* partials, const void* gamma, const void* beta,
                 void* out, int B, int HW, int C, int G, int chunks, float eps, int silu,
                 cudaStream_t s) {
  const size_t smem = (size_t)(2 * C + 2 * G) * sizeof(float);
  const cudaError_t e = allow_smem(gns_apply_kernel<T, VEC>, smem);
  if (e != cudaSuccess) return (int)e;
  gns_apply_kernel<T, VEC><<<dim3(chunks, B), NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(partials),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<T*>(out),
      HW, C, G, chunks, eps, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int stats_typed(const void* x, void* partials, int B, int HW, int C, int chunks, cudaStream_t s) {
  if (vec_width<T>(C, x, nullptr) == 1)
    return stats_launch<T, 1>(x, partials, B, HW, C, chunks, s);
  return stats_launch<T, 16 / sizeof(T)>(x, partials, B, HW, C, chunks, s);
}

template <typename T>
int apply_typed(const void* x, const void* partials, const void* gamma, const void* beta,
                void* out, int B, int HW, int C, int G, int chunks, float eps, int silu,
                cudaStream_t s) {
  if (vec_width<T>(C, x, out) == 1)
    return apply_launch<T, 1>(x, partials, gamma, beta, out, B, HW, C, G, chunks, eps, silu, s);
  return apply_launch<T, 16 / sizeof(T)>(x, partials, gamma, beta, out, B, HW, C, G, chunks,
                                         eps, silu, s);
}

bool bad_sizes(int B, int HW, int C, int chunks) {
  return B <= 0 || HW <= 0 || C <= 0 || chunks <= 0 || chunks > HW || B > 65535;
}

}  // namespace

// Per-channel fp32 partial sums of x [B, HW, C] over row chunks:
// partials [B, chunks, C, 2] = (sum, sum of squares). dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError().
extern "C" int gns_stats(const void* x, void* partials, int B, int HW, int C, int chunks,
                         int dtype, void* stream) {
  if (bad_sizes(B, HW, C, chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stats_typed<float>(x, partials, B, HW, C, chunks, s);
  if (dtype == 1) return stats_typed<__nv_bfloat16>(x, partials, B, HW, C, chunks, s);
  return (int)cudaErrorInvalidValue;
}

// out = SiLU?(GroupNorm(x) * gamma + beta) from the partials of gns_stats
// (same chunks). gamma/beta [C] float32. Returns cudaGetLastError().
extern "C" int gns_apply(const void* x, const void* partials, const void* gamma,
                         const void* beta, void* out, int B, int HW, int C, int G, int chunks,
                         float eps, int silu, int dtype, void* stream) {
  if (bad_sizes(B, HW, C, chunks) || G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return apply_typed<float>(x, partials, gamma, beta, out, B, HW, C, G, chunks, eps, silu, s);
  if (dtype == 1)
    return apply_typed<__nv_bfloat16>(x, partials, gamma, beta, out, B, HW, C, G, chunks, eps,
                                      silu, s);
  return (int)cudaErrorInvalidValue;
}
