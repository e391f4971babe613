// Blockwise-softmax attention: o = softmax(q k^T * scale) v, unmasked.
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:flash_attention (Pallas
// kernel _flash_kernel). q/k/v/o are [BH, N, D] in T (bf16 or fp32); scores,
// the online max/sum and the accumulator are fp32; o is stored in T. The
// UNet's bottleneck has 4 heads, so D = nf * ch_mult[-1] / 4: 64 at the
// flagship's widths, 4 to 128 at the repo's other configurations; the ViT
// image tower has D = 64. The launch plan (which kernel serves a (D, dtype))
// is ops/flash_attention.py:flash_plan, which mirrors flash_forward below.
//
// What bounds it on the H100: per head it does 4*N*Nk*D FLOPs on
// 2*(2*N + 2*Nk)*D bytes (bf16), i.e. N/2 FLOP/byte: ~512 at N = 1024, above
// the ~295 FLOP/byte ridge, so the ideal kernel is bound by the tensor cores
// and never writes the [N, Nk] scores to device memory. The flagship's
// launch is small (8.6 GFLOP, 256 blocks of 128 query rows at N = 1024), so
// in practice it is bound by latency and occupancy, not by the MMA rate:
// mma.sync serves it as well as wgmma would.
//
// bf16 at D = 64 (flash_tc_kernel, FA2-style): a block of 8 warps owns 128
// query rows of one (batch*head), 16 rows per warp, its Q fragments loaded
// once from device memory into registers. K/V tiles of 64 keys, shared by
// the 8 warps, stream through shared memory with cp.async, double-buffered,
// so the next tile loads while this one is multiplied.
// S = Q K^T on mma.sync m16n8k16 (bf16 -> fp32; exact products of bf16
// inputs), the online max and sum in fp32 on the accumulator fragments with
// exp2f (scores pre-scaled by scale*log2(e)), then P is rounded to bf16 in
// registers and used directly as the A operand of P V (ldmatrix.trans on V),
// with no trip through shared memory. Rounding P to bf16 is the one
// departure from the TPU kernel's all-fp32 arithmetic (the result stays
// within the bf16 tolerance of the plain fp32 version). Ragged N: keys past
// Nk are zero-filled and score -inf, query rows past N are not stored.
//
// Every other (D, dtype) (flash_fma_kernel<D, T>, D in {4, 8, 16, 32, 64,
// 128}): one thread per query row, all in fp32 on the FMA units. q, k and v
// are read in T and upcast to fp32 as they are loaded (as _flash_kernel
// upcasts its blocks), K and V tiles kept in shared memory as fp32, o
// rounded to T once at the store. The first, simple design: at D = 128 the
// row's q and accumulator (256 floats) exceed the register file's share of
// a thread and spill to local memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows (threads) per block
constexpr int BKV = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D, typename T>
__global__ void __launch_bounds__(BQ) flash_fma_kernel(const T* __restrict__ q,
                                                       const T* __restrict__ k,
                                                       const T* __restrict__ v,
                                                       T* __restrict__ o, int N, int Nk,
                                                       float scale_log2) {
  static_assert(D % 4 == 0, "rows are read as float4");
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
    qr[d] = valid ? to_f32(q[qbase + d]) * scale_log2 : 0.f;  // log2-domain scores
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += BKV) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BKV * D; i += BQ) {
      const int jj = i / D, d = i % D;
      const int j = j0 + jj;
      const bool ok = j < Nk;
      Ks[jj][d] = ok ? to_f32(k[kbase + (size_t)j * D + d]) : 0.f;
      Vs[jj][d] = ok ? to_f32(v[kbase + (size_t)j * D + d]) : 0.f;
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
    for (int d = 0; d < D; ++d) o[qbase + d] = from_f32<T>(acc[d] * inv);
  }
}


// ---------------------------------------------------------------- bf16, tensor cores

constexpr int TK = 64;    // keys per shared-memory tile
constexpr int LDH = 72;   // shared row stride in halves (144 B): conflict-free ldmatrix
constexpr int DH = 64;    // head dim
constexpr int kWarps = 8; // warps (16 query rows each) per block; 8 beat 4 on the H100

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [row0, row0 + R) of a [rows, 64] bf16 matrix into an [R][LDH] tile,
// zero past `rows`; NT threads, 16-byte cp.async chunks
template <int R, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < R * (DH / 8); i += NT) {
    const int r = i >> 3, ch = i & 7;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LDH + ch * 8, src + (ok ? (size_t)(row0 + r) * DH + ch * 8 : 0),
               ok ? 16 : 0);
  }
}

// WARPS warps, 16 query rows each, share every K/V tile
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32) flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                                       const __nv_bfloat16* __restrict__ k,
                                                       const __nv_bfloat16* __restrict__ v,
                                                       __nv_bfloat16* __restrict__ o, int N,
                                                       int Nk, float scale_log2) {
  constexpr int TQ = WARPS * 16, NT = WARPS * 32;
  __shared__ __align__(16) __nv_bfloat16 Ks[2][TK * LDH];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][TK * LDH];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const __nv_bfloat16* qg = q + (size_t)blockIdx.y * N * DH;
  const __nv_bfloat16* kg = k + (size_t)blockIdx.y * Nk * DH;
  const __nv_bfloat16* vg = v + (size_t)blockIdx.y * Nk * DH;

  load_tile<TK, NT>(Ks[0], kg, 0, Nk);
  load_tile<TK, NT>(Vs[0], vg, 0, Nk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // ldmatrix x4 lane roles: K (non-trans): key rows lane&7 + 8*bit4, d half
  // bit3; V (trans): key rows lane&7 + 8*bit3, d half lane>>4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) & 1) * 8, k_col = ((lane >> 3) & 1) * 8;

  // this warp's Q rows as mma A fragments, straight from device memory (0 past N)
  uint32_t qf[4][4];
  {
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(qg + (size_t)(r0 < N ? r0 : 0) * DH);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(qg + (size_t)(r1 < N ? r1 : 0) * DH);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int w = kk * 8 + t4;  // 32-bit word of columns kk*16 + 2*t4, +1
      qf[kk][0] = r0 < N ? q0p[w] : 0u;
      qf[kk][1] = r1 < N ? q1p[w] : 0u;
      qf[kk][2] = r0 < N ? q0p[w + 4] : 0u;
      qf[kk][3] = r1 < N ? q1p[w + 4] : 0u;
    }
  }
  float acc[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int tiles = (Nk + TK - 1) / TK;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile<TK, NT>(Ks[buf ^ 1], kg, (j + 1) * TK, Nk);
      load_tile<TK, NT>(Vs[buf ^ 1], vg, (j + 1) * TK, Nk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const __nv_bfloat16* Kt = Ks[buf];
    const __nv_bfloat16* Vt = Vs[buf];

    float s[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cp = 0; cp < 4; ++cp) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (cp * 16 + k_row) * LDH + kk * 16 + k_col);
        mma16816(s[2 * cp], qf[kk], b[0], b[1]);
        mma16816(s[2 * cp + 1], qf[kk], b[2], b[3]);
      }

    // online softmax in the log2 domain; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const bool ragged = (j + 1) * TK > Nk;  // the last tile of a ragged Nk
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] *= scale_log2;
        if (ragged && j * TK + c * 8 + t4 * 2 + (e & 1) >= Nk) s[c][e] = -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, s[c][e]); else mx1 = fmaxf(mx1, s[c][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile has a valid key
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[c][0] *= al0;
      acc[c][1] *= al0;
      acc[c][2] *= al1;
      acc[c][3] *= al1;
      s[c][0] = exp2f(s[c][0] - mn0);
      s[c][1] = exp2f(s[c][1] - mn0);
      s[c][2] = exp2f(s[c][2] - mn1);
      s[c][3] = exp2f(s[c][3] - mn1);
      l0 += s[c][0] + s[c][1];
      l1 += s[c][2] + s[c][3];
    }

    // P (bf16, registers) as the A operand of P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, Vt + (kk * 16 + a_row) * LDH + dp * 16 + a_col);
        mma16816(acc[2 * dp], pa, b[0], b[1]);
        mma16816(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* og = o + (size_t)blockIdx.y * N * DH;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = c * 8 + t4 * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(og + (size_t)r0 * DH + col) = pack2(acc[c][0] * i0, acc[c][1] * i0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(og + (size_t)r1 * DH + col) = pack2(acc[c][2] * i1, acc[c][3] * i1);
  }
}


template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int BH, int N,
                       int Nk, int D, float scale_log2, cudaStream_t s) {
  const dim3 grid((N + BQ - 1) / BQ, BH);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (D) {
    case 4: flash_fma_kernel<4, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2); break;
    case 8: flash_fma_kernel<8, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2); break;
    case 16: flash_fma_kernel<16, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2); break;
    case 32: flash_fma_kernel<32, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2); break;
    case 64: flash_fma_kernel<64, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2); break;
    case 128:
      flash_fma_kernel<128, T><<<grid, BQ, 0, s>>>(qp, kp, vp, op, N, Nk, scale_log2);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; path: 0 = the FMA kernel (any D of
// launch_fma's, either dtype), 1 = the tensor-core kernel (bf16, D = 64),
// as ops/flash_attention.py:flash_plan chooses. Returns cudaGetLastError().
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* o, int BH, int N,
                             int Nk, int D, float scale, int dtype, int path, void* stream) {
  if (BH <= 0 || N <= 0 || Nk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1 || D != DH) return (int)cudaErrorInvalidValue;
    flash_tc_kernel<kWarps><<<dim3((N + kWarps * 16 - 1) / (kWarps * 16), BH), kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, Nk, scale_log2);
    return (int)cudaGetLastError();
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_fma<float>(q, k, v, o, BH, N, Nk, D, scale_log2, s);
  if (dtype == 1) return (int)launch_fma<__nv_bfloat16>(q, k, v, o, BH, N, Nk, D, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}
