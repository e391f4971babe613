// Blockwise-softmax attention for the UNet bottleneck: o = softmax(q k^T * scale) v.
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:flash_attention (Pallas
// kernel _flash_kernel). q/k/v/o are [BH, N, D] in T (bf16 or fp32), D = 64;
// scores, the online max/sum and the accumulator are fp32; o is stored in T.
//
// What bounds it on the H100: per head it does 4*N*Nk*D FLOPs on
// 2*(2*N + 2*Nk)*D bytes (bf16), i.e. N/2 FLOP/byte: ~512 at N = 1024, well
// above the ~295 FLOP/byte ridge, so the ideal kernel is bound by the tensor
// cores and never writes the [N, Nk] scores to device memory.
//
// Design (the first, simple version): one block per (batch*head, 64 query
// rows), one thread per query row holding its pre-scaled q row and fp32
// accumulator in registers. The block walks the keys in tiles of 32, staged
// in shared memory as fp32; a tile's scores go to shared memory, then the
// online max/sum rescale the accumulator once per tile. Ragged N is masked
// instead of falling back as the TPU wrapper does: keys past Nk score -inf and
// query rows past N are computed but not stored, so N = 784 (224 px) runs the
// kernel too. Plain FMA with float4 shared-memory reads; no tensor cores yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows (threads) per block
constexpr int BKV = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                   const T* __restrict__ v, T* __restrict__ o,
                                                   int N, int Nk, float scale_log2) {
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ float S[BKV][BQ];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * BQ + tid;
  const bool valid = row < N;
  const size_t qbase = ((size_t)blockIdx.y * N + (valid ? row : 0)) * D;
  const size_t kbase = (size_t)blockIdx.y * Nk * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f(q[qbase + d]) * scale_log2 : 0.f;  // log2-domain scores
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += BKV) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BKV * D; i += BQ) {
      const int jj = i / D, d = i % D;
      const int j = j0 + jj;
      const bool ok = j < Nk;
      Ks[jj][d] = ok ? to_f(k[kbase + (size_t)j * D + d]) : 0.f;
      Vs[jj][d] = ok ? to_f(v[kbase + (size_t)j * D + d]) : 0.f;
    }
    __syncthreads();

    float tmax = -INFINITY;
#pragma unroll 2
    for (int jj = 0; jj < BKV; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[jj][d]);
        s = fmaf(qr[d], kv.x, s);
        s = fmaf(qr[d + 1], kv.y, s);
        s = fmaf(qr[d + 2], kv.z, s);
        s = fmaf(qr[d + 3], kv.w, s);
      }
      if (j0 + jj >= Nk) s = -INFINITY;
      S[jj][tid] = s;
      tmax = fmaxf(tmax, s);
    }
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a valid key
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 2
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = exp2f(S[jj][tid] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[jj][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) put(o + qbase + d, acc[d] * inv);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* o, int BH, int N,
                             int Nk, int D, float scale, int dtype, void* stream) {
  if (D != 64 || BH <= 0 || N <= 0 || Nk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BQ - 1) / BQ, BH);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_kernel<float, 64><<<grid, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), N, Nk, scale_log2);
  } else if (dtype == 1) {
    flash_kernel<__nv_bfloat16, 64><<<grid, BQ, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, Nk, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
