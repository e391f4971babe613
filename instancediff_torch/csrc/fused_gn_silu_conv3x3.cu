// Fused GroupNorm-affine + SiLU + 3x3 SAME convolution (+ bias, + residual).
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:fused_gn_silu_conv3x3
// (Pallas kernel _fgc_kernel). It computes
//
//   y[b,h,w,co] = bias[b,co] (+ res[b,h,w,co])
//               + sum_{dy,dx,c} a(x[b, h+dy-1, w+dx-1, c]) * wt[dy,dx,c,co]
//   a(v) = round_to_T(silu(v * scale[b,c] + shift[b,c])), and 0 outside the image
//
// with NHWC x/res/y in T (bf16 or fp32), HWIO wt in T, scale/shift [B,C] and
// bias [B,Cout] in fp32, fp32 accumulation.
//
// What bounds it on the H100: per output pixel it moves about
// (C + Cout [+ Cout]) * sizeof(T) bytes and does 2*9*C*Cout FLOPs. At the
// flagship's widths that is ~290 FLOP/byte in bf16 at C = Cout = 64 (just
// under the card's ~295 FLOP/byte ridge, so bound by bytes) up to ~1550 at
// C = 528 -> 256 (bound by the tensor cores); the Cout=5 output head is
// bound by bytes.
//
// Design (the first, simple version): an implicit GEMM with M = B*H*W pixels,
// N = Cout, K = 9*C, one 128x64 output tile per block of 256 threads. The K
// loop walks the nine taps and 32-channel slices. Each step stages the
// activation tile in shared memory with the normalize + SiLU applied while it
// is loaded, writing 0 for out-of-image taps and for channels past C (so the
// SAME padding is applied after the normalize, as the TPU kernel's mask does,
// and ragged C such as 144/272/528 needs no padding), and stages the weight
// slice transposed to [n][k]. bf16 multiplies on the tensor cores with
// mma.sync m16n8k16 and fp32 accumulators (each warp owns a 32x32 sub-tile);
// fp32 uses plain FMA on an 8x4 micro-tile per thread. The epilogue adds the
// per-(B,Cout) bias and the optional residual in fp32, masks pixels past M and
// channels past Cout, and stores T. There is no double buffering and no
// TMA/wgmma yet, and the TPU's row-strip DMA pipeline is not carried over:
// blocks run in parallel on the 132 SMs and need no carried state.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per K step (within one tap)
constexpr int NTHREADS = 256;

struct Args {
  const void* x;
  const float* scale;
  const float* shift;
  const void* w;
  const float* bias;
  const void* res;
  void* out;
  int B, H, W, C, Cout;
};

// Pixel coordinates of the block's BM output rows; b = -1 past M.
struct RowInfo {
  int b[BM];
  int y[BM];
  int x[BM];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __host__ __device__ constexpr int row_stride() {
  // bf16: 40 halves = 20 words, conflict-free fragment loads; fp32: 33 words
  return std::is_same<T, float>::value ? BK + 1 : BK + 8;
}

// Stage the activation slice [BM x BK] (normalize + SiLU on load) and the
// weight slice transposed to [BN x BK] for tap (dy, dx), channels c0.., and
// output channels n0...
template <typename T>
__device__ __forceinline__ void stage(const Args& a, const RowInfo& ri, int dy, int dx,
                                      int c0, int n0, T* As, T* Bs) {
  constexpr int LDS = row_stride<T>();
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int kk = threadIdx.x & (BK - 1);
  const int c = c0 + kk;
  const bool c_ok = c < a.C;
  // one warp loads one pixel's 32 consecutive channels per iteration
#pragma unroll 4
  for (int r = threadIdx.x / BK; r < BM; r += NTHREADS / BK) {
    float v = 0.f;
    const int b = ri.b[r];
    if (b >= 0 && c_ok) {
      const int yy = ri.y[r] + dy - 1;
      const int xx = ri.x[r] + dx - 1;
      if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
        const size_t idx = (((size_t)b * a.H + yy) * a.W + xx) * a.C + c;
        const float u = to_f(x[idx]) * a.scale[b * a.C + c] + a.shift[b * a.C + c];
        v = u / (1.f + expf(-u));
      }
    }
    As[r * LDS + kk] = from_f<T>(v);
  }
  const int tap = dy * 3 + dx;
  for (int i = threadIdx.x; i < BN * BK; i += NTHREADS) {
    const int n = i % BN;
    const int k = i / BN;
    const int cc = c0 + k;
    const int nn = n0 + n;
    float v = 0.f;
    if (cc < a.C && nn < a.Cout) v = to_f(w[((size_t)tap * a.C + cc) * a.Cout + nn]);
    Bs[n * LDS + k] = from_f<T>(v);
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* af, const uint32_t* bf) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]), "r"(bf[1]));
}

template <typename T>
__device__ __forceinline__ void epilogue_store(const Args& a, const RowInfo& ri, int m0,
                                               int n0, int r, int col, float v) {
  const int b = ri.b[r];
  const int n = n0 + col;
  if (b < 0 || n >= a.Cout) return;
  const size_t o = (size_t)(m0 + r) * a.Cout + n;
  v += a.bias[b * a.Cout + n];
  if (a.res != nullptr) v += to_f(static_cast<const T*>(a.res)[o]);
  static_cast<T*>(a.out)[o] = from_f<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fgc_kernel(Args a) {
  constexpr int LDS = row_stride<T>();
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ RowInfo ri;

  const int HW = a.H * a.W;
  const long long M = (long long)a.B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const long long m = (long long)m0 + r;
    if (m < M) {
      const int b = (int)(m / HW);
      const int rem = (int)(m - (long long)b * HW);
      ri.b[r] = b;
      ri.y[r] = rem / a.W;
      ri.x[r] = rem % a.W;
    } else {
      ri.b[r] = -1;
      ri.y[r] = 0;
      ri.x[r] = 0;
    }
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int tap = 0; tap < 9; ++tap) {
    for (int c0 = 0; c0 < a.C; c0 += BK) {
      __syncthreads();  // previous step's reads done (and ri written)
      stage<T>(a, ri, tap / 3, tap % 3, c0, n0, As, Bs);
      __syncthreads();
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const int g = lane >> 2, t4 = lane & 3;
        const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          uint32_t af[2][4], bfr[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* p = As + (wm + mt * 16 + g) * LDS + ks + t4 * 2;
            af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
            af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
            af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
            af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* p = Bs + (wn + nt * 8 + g) * LDS + ks + t4 * 2;
            bfr[nt][0] = *reinterpret_cast<const uint32_t*>(p);
            bfr[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc + (mt * 4 + nt) * 4, af[mt], bfr[nt]);
        }
      } else {
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
          float av[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) av[i] = As[(ty + 16 * i) * LDS + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDS + k];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
        }
      }
    }
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          epilogue_store<T>(a, ri, m0, n0, wm + mt * 16 + g + (i >= 2 ? 8 : 0),
                            wn + nt * 8 + t4 * 2 + (i & 1), acc[(mt * 4 + nt) * 4 + i]);
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        epilogue_store<T>(a, ri, m0, n0, ty + 16 * i, tx + 16 * j, acc[i * 4 + j]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be NULL. Returns cudaGetLastError().
extern "C" int fgc_forward(const void* x, const void* scale, const void* shift, const void* w,
                           const void* bias, const void* res, void* out, int B, int H, int W,
                           int C, int Cout, int dtype, void* stream) {
  Args a{x, static_cast<const float*>(scale), static_cast<const float*>(shift), w,
         static_cast<const float*>(bias), res, out, B, H, W, C, Cout};
  const long long M = (long long)B * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks_m = (M + BM - 1) / BM;
  if (blocks_m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_m, (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fgc_kernel<float><<<grid, NTHREADS, 0, s>>>(a);
  } else if (dtype == 1) {
    fgc_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
