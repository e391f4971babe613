// Blockwise-softmax attention: o = softmax(q k^T * scale) v, unmasked.
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:flash_attention (Pallas
// kernel _flash_kernel). q/k/v/o are [BH, N, D] in T (bf16, fp16 or fp32); scores,
// the online max/sum and the accumulator are fp32; o is stored in T. The
// UNet's bottleneck has 4 heads, so D = nf * ch_mult[-1] / 4: 64 at the
// flagship's widths, 4 to 128 at the repo's other configurations; the ViT
// image tower has D = 64, and so have the RN50 CLIP tower's attention pool
// ([B, 32, 50, 64]), the dense ViT and the reference context decoder's self-
// attention; CoCa's towers D = 64 and its coca_ViT-L-14 attentional pooler
// (embed 768 over 8 heads) D = 96, with 256 queries over the image tokens
// (Nk = 50 or 257), as its decoder's cross-attention has L queries over 255
// keys. The launch plan (which kernel serves a (D, dtype)) is
// ops/flash_attention.py:flash_plan, which mirrors flash_forward below.
// Every (D, dtype) of HEAD_WIDTHS x {bf16, fp16, fp32} runs on the tensor
// cores.
//
// What bounds it on the H100: per head it does 4*N*Nk*D FLOPs on
// 2*(2*N + 2*Nk)*D*sizeof(T) bytes, i.e. N/2 FLOP/byte in bf16 at D = 64
// (~512 at N = 1024, above the ~295 FLOP/byte ridge), so the ideal kernel is
// bound by the tensor cores and never writes the [N, Nk] scores to device
// memory. The repo's launches are small (8.6 GFLOP at [8,4,1024,64]), so in
// practice they are bound by latency and occupancy, not by the MMA rate:
// mma.sync serves them as well as wgmma would. At D <= 16 neither bytes nor
// FLOPs bound it: each score costs one exp2 on the special-function units
// (N*Nk*BH of them, ~8 us at [8,4,1024,D]) plus the wrapper's host time.
//
// Both kernels share one FA2 structure: a block of warps owns 16 query rows
// per warp of one (batch*head), its Q fragments loaded once from device
// memory into registers; K/V tiles, shared by the warps, stream through
// shared memory (dynamic, sized per D) with cp.async, double-buffered, so
// the next tile loads while this one is multiplied; S = Q K^T and P V on
// mma.sync with fp32 accumulators; the online max and sum in fp32 on the
// accumulator fragments with exp2f (scores scaled by scale*log2(e)); P is
// reused from the S accumulator registers as the A operand of P V, with no
// trip through shared memory. Ragged N: keys past Nk are zero-filled and
// score -inf, query rows past N are not stored. Row strides in shared
// memory are padded so that the fragment reads are free of bank conflicts.
//
// bf16 and fp16 (flash_tc_kernel<T, D>, one template over the 16-bit type
// T): m16n8k16 bf16 or f16 -> fp32 (exact products of 16-bit inputs), B
// fragments by ldmatrix (.trans for V). D < 16 pads the QK^T contraction to
// k = 16 with zero columns (exact) and P V computes one 8-wide n block of
// which D columns are stored; at D = 4 a row is 8 bytes, copied by 8-byte
// cp.async. P is rounded to T in registers before P V, the one departure
// from the TPU kernel's all-fp32 arithmetic (the result stays within the
// 16-bit tolerance of the plain fp32 version; P lies in [0, 1], where fp16's
// 11-bit significand rounds finer than bf16's 8 bits). The fp16 kernel is
// BiomedCLIP's at precision fp16 / pure_fp16.
//
// fp32 (flash_tf32x3_kernel<D>): m16n8k8 tf32 -> fp32 with split-TF32
// products (3xTF32): each fp32 operand a is split as its fragment is read
// into big = rna_tf32(a) and small = rna_tf32(a - big), and each product is
// taken as small*big + big*small + big*big (the small*small term, ~2^-22
// relative, dropped), which keeps the result within fp32 tolerances where
// one TF32 pass (2^-11 relative) does not; the tensor-core rate is then
// 495/3 = 165 TFLOP/s of fp32 work. Q (staged once), K and V stay fp32 in
// shared memory, which keeps Q out of the registers the accumulators need
// at D = 128; Q's and K's fragments come by ldmatrix (a 32-bit word is a
// pair of b16), V's by 32-bit loads. The tensor cores' fp32 accumulation
// does not round to nearest, so P V accumulates each tile apart and fp32
// adds fold it into the running sum (the error falls with the tile's share
// of the sum). P's C fragment (row g, keys 2*t4 and 2*t4+1 of an 8-key
// block) is relabelled as the A fragment's k indices t4 and t4+4, and V's B
// fragment read at keys 2*t4 and 2*t4+1 to match, so P needs no shuffle.
// D = 4 pads to k = 8. At D = 128 the tiles are 32 keys wide, so that the
// accumulators and the scores fit the registers. A block has 8 warps (128
// query rows), which halves the K/V traffic and the splits of K and V per
// query row against 4 warps, or 4 where 64-row blocks pad N to over a tenth
// fewer rows (N = 257: 320 against 384); `python3 chip_smoke.py --sweep
// flash` times both. D = 96 keeps 64-key tiles in both kernels: the 16-bit
// row stride is 104 halves (13 chunks of 16 B, an odd count) and 53,248 B of
// shared memory; the fp32 one 100 floats (4 mod 8), 153,600 B at 8 warps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (16 query rows each) per bf16 block; 8 beat 4 on the H100

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
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
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// d += a * b on m16n8k16 with fp32 accumulators, a and b in T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t* a, uint32_t b0,
                                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a, uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma1688(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to nearest T (bf16 or fp16), packed lo | hi << 16
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// round to nearest, ties away from zero, to TF32 (the low 13 bits zero)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// a = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}
// d += a * b in split TF32: the two cross terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ab, const uint32_t* as,
                                           uint32_t bb0, uint32_t bb1, uint32_t bs0,
                                           uint32_t bs1) {
  mma1688(d, as, bb0, bb1);
  mma1688(d, ab, bs0, bs1);
  mma1688(d, ab, bb0, bb1);
}

// The online softmax of one key tile on the accumulator fragments of 16 query
// rows (g: e = 0, 1; g + 8: e = 2, 3), NC 8-key blocks, in the log2 domain:
// scales the scores, masks keys past Nk, rescales acc (NA blocks) and the
// running sums, and leaves exp2(s - max) in s.
template <int NC, int NA>
__device__ __forceinline__ void online_softmax(float (&s)[NC][4], float (&acc)[NA][4], float& m0,
                                               float& m1, float& l0, float& l1, int key0, int Nk,
                                               int t4, float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  const bool ragged = key0 + NC * 8 > Nk;  // the last tile of a ragged Nk
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[c][e] *= scale_log2;
      if (ragged && key0 + c * 8 + t4 * 2 + (e & 1) >= Nk) s[c][e] = -INFINITY;
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
  for (int c = 0; c < NA; ++c) {
    acc[c][0] *= al0;
    acc[c][1] *= al0;
    acc[c][2] *= al1;
    acc[c][3] *= al1;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    s[c][0] = exp2f(s[c][0] - mn0);
    s[c][1] = exp2f(s[c][1] - mn0);
    s[c][2] = exp2f(s[c][2] - mn1);
    s[c][3] = exp2f(s[c][3] - mn1);
    l0 += s[c][0] + s[c][1];
    l1 += s[c][2] + s[c][3];
  }
}

__device__ __forceinline__ void finish_sums(float& l0, float& l1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
}

// ---------------------------------------------------------------- bf16 and fp16

// the 16-bit kernel's shapes at head width D
template <int D>
struct TcShape {
  static constexpr int TK = 64;                  // keys per tile
  static constexpr int DK = cmax(D, 16);         // QK^T contraction, padded to k = 16
  static constexpr int LDH = DK + 8;             // row stride in halves: an odd count of 16 B
  static constexpr int ND = cmax(D, 8) / 8;      // 8-wide n blocks of P V
  static constexpr int CH = D >= 8 ? 8 : 4;      // halves per cp.async chunk (16 or 8 bytes)
  static constexpr int SMEM = 2 * 2 * TK * LDH * 2;  // K and V, double-buffered
};

// rows [row0, row0 + TK) of a [rows, D] 16-bit matrix into a [TK][LDH]
// tile, zero past `rows`; NT threads
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile_16(T* dst, const T* src, int row0, int rows) {
  using S = TcShape<D>;
  constexpr int PER_ROW = D / S::CH;
  for (int i = threadIdx.x; i < S::TK * PER_ROW; i += NT) {
    const int r = i / PER_ROW, ch = i % PER_ROW;
    const bool ok = row0 + r < rows;
    const T* s = src + (ok ? (size_t)(row0 + r) * D + ch * S::CH : 0);
    if constexpr (S::CH == 8)
      cp_async16(dst + r * S::LDH + ch * 8, s, ok ? 16 : 0);
    else
      cp_async8(dst + r * S::LDH + ch * 4, s, ok ? 8 : 0);
  }
}

// WARPS warps, 16 query rows each, share every K/V tile; T is __nv_bfloat16
// or __half
template <typename T, int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) flash_tc_kernel(const T* __restrict__ q,
                                                       const T* __restrict__ k,
                                                       const T* __restrict__ v,
                                                       T* __restrict__ o, int N, int Nk,
                                                       float scale_log2) {
  using S = TcShape<D>;
  constexpr int TK = S::TK, LDH = S::LDH, KB = S::DK / 16, ND = S::ND;
  constexpr int TQ = WARPS * 16, NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [2][TK][LDH]
  T* Vs = Ks + 2 * TK * LDH;               // [2][TK][LDH]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const T* qg = q + (size_t)blockIdx.y * N * D;
  const T* kg = k + (size_t)blockIdx.y * Nk * D;
  const T* vg = v + (size_t)blockIdx.y * Nk * D;

  if constexpr (D < S::DK) {  // the padded columns, which cp.async never writes, are 0
    for (int i = threadIdx.x; i < 2 * 2 * TK * (S::DK - D); i += NT) {
      const int row = i / (S::DK - D), col = D + i % (S::DK - D);
      Ks[row * LDH + col] = T(0.f);  // rows 0..4*TK-1 span Ks and Vs
    }
  }
  load_tile_16<T, D, NT>(Ks, kg, 0, Nk);
  load_tile_16<T, D, NT>(Vs, vg, 0, Nk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // ldmatrix x4 lane roles: K (non-trans): key rows lane&7 + 8*bit4, d half
  // bit3; V (trans): key rows lane&7 + 8*bit3, d half lane>>4
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) & 1) * 8, k_col = ((lane >> 3) & 1) * 8;

  // this warp's Q rows as mma A fragments, straight from device memory (0
  // past N and past D)
  uint32_t qf[KB][4];
  {
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(qg + (size_t)(r0 < N ? r0 : 0) * D);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(qg + (size_t)(r1 < N ? r1 : 0) * D);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int w = kk * 8 + t4;  // 32-bit word of columns kk*16 + 2*t4, +1
      const bool lo = 2 * w < D, hi = 2 * (w + 4) < D;
      qf[kk][0] = (r0 < N && lo) ? q0p[w] : 0u;
      qf[kk][1] = (r1 < N && lo) ? q1p[w] : 0u;
      qf[kk][2] = (r0 < N && hi) ? q0p[w + 4] : 0u;
      qf[kk][3] = (r1 < N && hi) ? q1p[w + 4] : 0u;
    }
  }
  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int tiles = (Nk + TK - 1) / TK;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile_16<T, D, NT>(Ks + (buf ^ 1) * TK * LDH, kg, (j + 1) * TK, Nk);
      load_tile_16<T, D, NT>(Vs + (buf ^ 1) * TK * LDH, vg, (j + 1) * TK, Nk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const T* Kt = Ks + buf * TK * LDH;
    const T* Vt = Vs + buf * TK * LDH;

    float s[TK / 8][4];
#pragma unroll
    for (int c = 0; c < TK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int cp = 0; cp < TK / 16; ++cp) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (cp * 16 + k_row) * LDH + kk * 16 + k_col);
        mma16816<T>(s[2 * cp], qf[kk], b[0], b[1]);
        mma16816<T>(s[2 * cp + 1], qf[kk], b[2], b[3]);
      }

    online_softmax<TK / 8, ND>(s, acc, m0, m1, l0, l1, j * TK, Nk, t4, scale_log2);

    // P (T, registers) as the A operand of P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if constexpr (ND == 1) {
        uint32_t b[2];
        ldsm_x2_t(b, Vt + (kk * 16 + a_row) * LDH);
        mma16816<T>(acc[0], pa, b[0], b[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, Vt + (kk * 16 + a_row) * LDH + dp * 16 + a_col);
          mma16816<T>(acc[2 * dp], pa, b[0], b[1]);
          mma16816<T>(acc[2 * dp + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

  finish_sums(l0, l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  T* og = o + (size_t)blockIdx.y * N * D;
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const int col = c * 8 + t4 * 2;
    if (col >= D) continue;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(og + (size_t)r0 * D + col) =
          pack2<T>(acc[c][0] * i0, acc[c][1] * i0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(og + (size_t)r1 * D + col) =
          pack2<T>(acc[c][2] * i1, acc[c][3] * i1);
  }
}

// ---------------------------------------------------------------- fp32, split TF32

// the fp32 kernel's shapes at head width D
template <int D, int WARPS>
struct TfShape {
  static constexpr int TK = D >= 128 ? 32 : 64;  // keys per tile: registers at D = 128
  static constexpr int DK = cmax(D, 8);          // contraction and P V width, padded to 8
  static constexpr int LD = DK + 4;              // row stride in floats: 4 mod 8, conflict-free
  static constexpr int KB = DK / 8;
  static constexpr int TQ = WARPS * 16;
  // Q, then K and V double-buffered
  static constexpr int SMEM = (TQ + 2 * 2 * TK) * LD * 4;
};

// rows [row0, row0 + R) of a [rows, D] fp32 matrix into an [R][LD] tile,
// zero past `rows`; NT threads, 16-byte cp.async chunks
template <int D, int R, int LD, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int rows) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < R * PER_ROW; i += NT) {
    const int r = i / PER_ROW, ch = i % PER_ROW;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LD + ch * 4, src + (ok ? (size_t)(row0 + r) * D + ch * 4 : 0),
               ok ? 16 : 0);
  }
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) flash_tf32x3_kernel(const float* __restrict__ q,
                                                           const float* __restrict__ k,
                                                           const float* __restrict__ v,
                                                           float* __restrict__ o, int N, int Nk,
                                                           float scale_log2) {
  using S = TfShape<D, WARPS>;
  constexpr int TK = S::TK, LD = S::LD, KB = S::KB, TQ = S::TQ;
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [TQ][LD]
  float* Ks = Qs + TQ * LD;                        // [2][TK][LD]
  float* Vs = Ks + 2 * TK * LD;                    // [2][TK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const float* qg = q + (size_t)blockIdx.y * N * D;
  const float* kg = k + (size_t)blockIdx.y * Nk * D;
  const float* vg = v + (size_t)blockIdx.y * Nk * D;

  if constexpr (D < S::DK) {  // the padded columns, which cp.async never writes, are 0
    for (int i = threadIdx.x; i < (TQ + 4 * TK) * (S::DK - D); i += NT) {
      const int row = i / (S::DK - D), col = D + i % (S::DK - D);
      Qs[row * LD + col] = 0.f;  // rows 0..TQ+4*TK-1 span Qs, Ks and Vs
    }
  }
  load_tile_f32<D, TQ, LD, NT>(Qs, qg, q0, N);
  load_tile_f32<D, TK, LD, NT>(Ks, kg, 0, Nk);
  load_tile_f32<D, TK, LD, NT>(Vs, vg, 0, Nk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // ldmatrix x4 on fp32 words (a 32-bit word is a pair of b16). Q (A): matrix
  // i holds rows 8*(i&1) + 0..7 at columns 4*(i>>1) + 0..3, giving a0..a3. K
  // (B): matrix i holds keys 8*(i>>1) + 0..7 at columns 4*(i&1) + 0..3, so a
  // lane receives K[key g][t4] (b0) and K[key g][t4 + 4] (b1) of two 8-key
  // blocks.
  const int q_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, q_col = (lane >> 4) * 4;
  const int k_row = (lane & 7) + ((lane >> 4) & 1) * 8, k_col = ((lane >> 3) & 1) * 4;

  float acc[KB][4];
#pragma unroll
  for (int c = 0; c < KB; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int tiles = (Nk + TK - 1) / TK;
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile_f32<D, TK, LD, NT>(Ks + (buf ^ 1) * TK * LD, kg, (j + 1) * TK, Nk);
      load_tile_f32<D, TK, LD, NT>(Vs + (buf ^ 1) * TK * LD, vg, (j + 1) * TK, Nk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float* Kt = Ks + buf * TK * LD;
    const float* Vt = Vs + buf * TK * LD;

    float s[TK / 8][4];
#pragma unroll
    for (int c = 0; c < TK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t a[4], qb[4], qs[4];
      ldsm_x4(a, Qs + q_row * LD + kk * 8 + q_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), qb[e], qs[e]);
#pragma unroll
      for (int cp = 0; cp < TK / 16; ++cp) {
        uint32_t b[4], bb[4], bs[4];
        ldsm_x4(b, Kt + (cp * 16 + k_row) * LD + kk * 8 + k_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), bb[e], bs[e]);
        mma_3xtf32(s[2 * cp], qb, qs, bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32(s[2 * cp + 1], qb, qs, bb[2], bb[3], bs[2], bs[3]);
      }
    }

    online_softmax<TK / 8, KB>(s, acc, m0, m1, l0, l1, j * TK, Nk, t4, scale_log2);

    // P V of this tile into its own accumulator, added to acc with fp32
    // adds: the tensor cores' accumulation then rounds against one tile's
    // sum, not against the running one. P (fp32, registers) is the A
    // operand: the C fragment's keys 2*t4 and 2*t4 + 1 are the A fragment's
    // k = t4 and t4 + 4.
    float part[KB][4];
#pragma unroll
    for (int c = 0; c < KB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < TK / 8; ++kb) {
      uint32_t pb[4], ps[4];
      split_tf32(s[kb][0], pb[0], ps[0]);  // row g,     key 2*t4
      split_tf32(s[kb][2], pb[1], ps[1]);  // row g + 8, key 2*t4
      split_tf32(s[kb][1], pb[2], ps[2]);  // row g,     key 2*t4 + 1
      split_tf32(s[kb][3], pb[3], ps[3]);  // row g + 8, key 2*t4 + 1
      const float* v0 = Vt + (kb * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int db = 0; db < KB; ++db) {
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(v0[db * 8], vb0, vs0);       // V[key 2*t4][d g]
        split_tf32(v0[LD + db * 8], vb1, vs1);  // V[key 2*t4 + 1][d g]
        mma_3xtf32(part[db], pb, ps, vb0, vb1, vs0, vs1);
      }
    }
#pragma unroll
    for (int c = 0; c < KB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
    __syncthreads();  // this buffer is refilled by the next iteration's prefetch
  }

  finish_sums(l0, l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* og = o + (size_t)blockIdx.y * N * D;
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const int col = c * 8 + t4 * 2;
    if (col >= D) continue;
    if (r0 < N)
      *reinterpret_cast<float2*>(og + (size_t)r0 * D + col) =
          make_float2(acc[c][0] * i0, acc[c][1] * i0);
    if (r1 < N)
      *reinterpret_cast<float2*>(og + (size_t)r1 * D + col) =
          make_float2(acc[c][2] * i1, acc[c][3] * i1);
  }
}

// ---------------------------------------------------------------- launch

constexpr int kMaxDevices = 16;

// One kernel's launch. `allowed` is that kernel's own per-device record of
// the dynamic shared memory it was allowed: raised once per device
// (first-call work, before any graph capture), not per launch.
template <typename T, typename Kern>
cudaError_t launch(Kern kern, int* allowed, int smem, int warps, const void* q, const void* k,
                   const void* v, void* o, int BH, int N, int Nk, float scale_log2,
                   cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && allowed[dev] < smem) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return e;
    allowed[dev] = smem;
  }
  const int tq = warps * 16;
  kern<<<dim3((N + tq - 1) / tq, BH), warps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, Nk, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int path, int warps, const void* q, const void* k, const void* v,
                     void* o, int BH, int N, int Nk, float scale_log2, cudaStream_t s) {
  static int allowed_tc[kMaxDevices] = {}, allowed_h[kMaxDevices] = {},
             allowed_f4[kMaxDevices] = {}, allowed_f8[kMaxDevices] = {};
  if (path == 1 && dtype == 1)
    return launch<__nv_bfloat16>(flash_tc_kernel<__nv_bfloat16, D, kWarps>, allowed_tc,
                                 TcShape<D>::SMEM, kWarps, q, k, v, o, BH, N, Nk, scale_log2, s);
  if (path == 1)
    return launch<__half>(flash_tc_kernel<__half, D, kWarps>, allowed_h, TcShape<D>::SMEM,
                          kWarps, q, k, v, o, BH, N, Nk, scale_log2, s);
  if (warps == 8)
    return launch<float>(flash_tf32x3_kernel<D, 8>, allowed_f8, TfShape<D, 8>::SMEM, 8, q, k, v,
                         o, BH, N, Nk, scale_log2, s);
  return launch<float>(flash_tf32x3_kernel<D, 4>, allowed_f4, TfShape<D, 4>::SMEM, 4, q, k, v, o,
                       BH, N, Nk, scale_log2, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; path: 1 = the 16-bit
// tensor-core kernel (bf16 or fp16, 8 warps), 2 = the fp32 split-TF32
// tensor-core kernel with `warps` 4 or 8,
// as ops/flash_attention.py:flash_plan chooses (the path must match the
// dtype); D in {4, 8, 16, 32, 64, 96, 128}. Returns cudaGetLastError().
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* o, int BH, int N,
                             int Nk, int D, float scale, int dtype, int path, int warps,
                             void* stream) {
  if (BH <= 0 || N <= 0 || Nk <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (!((path == 1 && (dtype == 1 || dtype == 2) && warps == kWarps) ||
        (path == 2 && dtype == 0 && (warps == 4 || warps == 8))))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return (int)launch_d<4>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 8: return (int)launch_d<8>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 16: return (int)launch_d<16>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 32: return (int)launch_d<32>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 64: return (int)launch_d<64>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 96: return (int)launch_d<96>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    case 128: return (int)launch_d<128>(dtype, path, warps, q, k, v, o, BH, N, Nk, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
