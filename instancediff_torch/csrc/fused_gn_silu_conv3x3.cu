// Fused GroupNorm-affine + SiLU + 3x3 SAME convolution (+ bias, + residual).
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:fused_gn_silu_conv3x3
// (Pallas kernel _fgc_kernel). It computes
//
//   y[b,h,w,co] = bias[b,co] (+ res[b,h,w,co])
//               + sum_{dy,dx,c} a(x[b, h+dy-1, w+dx-1, c]) * wt[dy,dx,c,co]
//   a(v) = round_to_T(silu(v * scale[b,c] + shift[b,c])), and 0 outside the image
//
// with NHWC x/res/y in T (bf16 or fp32), HWIO wt, scale/shift [B,C] and
// bias [B,Cout] in fp32, fp32 accumulation and one rounding at the store.
//
// What bounds it on the H100: per output pixel it moves about
// (C + Cout [+ Cout]) * sizeof(T) bytes and does 2*9*C*Cout FLOPs: ~290
// FLOP/byte in bf16 at C = Cout = 64 (at the card's ~295 FLOP/byte ridge) up
// to ~1550 at C = 528 -> 256, so every large launch of the flagship forward is
// bound by the tensor cores (989 TFLOP/s bf16; 165 TFLOP/s of fp32 work in
// split TF32, where fp32 bytes halve the FLOP/byte and the ridge falls to
// ~49); the Cout=5 output head is bound by bytes (it reads 64 channels to
// write 5). Both dtypes run on the tensor cores.
//
// bf16 design (fgc_tc_kernel), for those bounds:
//  * Normalise once per tile, as the Pallas kernel does. A block owns a TH x 8
//    pixel tile of one image (TH = 16: two warpgroups; 8: one) and an N block
//    of NB = 8, 64, 128 or 256 output channels sized from Cout (the Cout=5
//    head pays for 8 columns). For each 32-channel slice it loads the
//    raw (TH+2) x 10 halo once (cp.async, 16-byte chunks when C % 8 == 0,
//    else scalar loads) with scale/shift, applies them + SiLU in fp32 once per
//    element, rounds to bf16 and stores the normalised tile in shared memory.
//    Halo pixels outside the image are set to exactly 0 by coordinate (a
//    zero-filled load would become SiLU(shift) != 0), channels past C get
//    scale = shift = 0. Normalisations per output pixel fall from 9 (one per
//    tap) to 180/128 = 1.4 at TH = 16.
//  * The nine taps read shifted windows of that one tile straight from shared
//    memory: the tile is stored [8-channel chunk][halo pixel][8 channels], so
//    eight neighbouring halo pixels are one 128-byte wgmma core matrix and the
//    window of tap (dy, dx) is a plain matrix descriptor whose start moves
//    with (dy, dx) (rows 160 bytes apart). No copy per tap.
//  * Tensor cores: wgmma m64nNk16 bf16 -> fp32, A (activations) and B
//    (weights) from shared memory, fp32 accumulators in registers, one step's
//    wgmmas in flight behind the next step's issue. (A from registers, loaded
//    by ldmatrix, needs the registers kept until the wgmma retires, which the
//    compiler does not guarantee: it gave wrong sums.)
//  * The weights are packed once per parameter by the wrapper into
//    [nblock][slice][tap][NB][32] rows of 64 bytes in the wgmma 64-byte
//    swizzle, zero-padded past C and Cout: one (slice, tap) step is one
//    contiguous run that a single TMA bulk copy (cp.async.bulk, completion on
//    an mbarrier) brings into a ring of `stages` buffers ahead of the MMAs.
//  * Persistent blocks: as many as fit on the card, each walking tiles; the
//    weight ring streams across tile boundaries, the next unit's halo and
//    coefficients are in flight (cp.async) while the current unit is
//    multiplied, and its normalisation runs between wgmma issue and wait.
//  * No split-K and no atomics: a repeated call gives the same bits.
//  * The epilogue adds bias[b,co] and the residual in fp32 and stores bf16.
//  Measured on the H100 this runs at 10-28 % of the tensor-core rate on the
//  large launches; even with the normalise, halo loads and stores switched
//  off the step pipeline (one 32-channel step per block-wide barrier) stays
//  far from the rate (PERF.md, findings of the redesign).
//
// fp32 design (fgc_tf32x3_kernel), served wherever a net computes in fp32
// (every config without models.<name>.dtype, flagship_test.yml among them):
//  * Split TF32 (3xTF32) on mma.sync m16n8k8: each fp32 operand is
//    big = rna_tf32(a) plus small = rna_tf32(a - big), and each product is
//    small*big + big*small + big*big with fp32 accumulation: ~2^-22
//    relative per product, within the fp32 tolerances, where one TF32 pass
//    (2^-11) is not. The tensor-core rate is then 495/3 = 165 TFLOP/s of
//    fp32 work, against 67 on the FMA units. (tf32 wgmma would take A and B
//    K-major only, with 4 channels to a 16-byte core-matrix row and both
//    halves of every tile in shared memory: 4x the bf16 kernel's bytes per
//    slice; mma.sync keeps a simpler pipeline of plain-strided tiles.)
//  * Normalise once per tile element: a block owns an 8 x 16 pixel tile of
//    one image and an N block of NB = 8..128 output channels, the narrowest
//    that covers Cout (8 for the Cout=5 head; 128-wide blocks past 128); per 32-channel slice the raw 10 x 18 halo arrives by
//    cp.async (16-byte chunks when C % 4 == 0, else 4-byte ones) with its
//    scale/shift, is normalised with SiLU in fp32 once and stored as its big
//    and small halves; halo pixels outside the image are exactly 0 by
//    coordinate. The nine taps read shifted windows of those tiles by
//    ldmatrix (a 32-bit word is a pair of b16; each lane addresses its own
//    pixel row, so a shift is a per-lane offset); rows of 144 bytes keep
//    the reads free of bank conflicts.
//  * The weights are packed once per parameter by the wrapper into
//    [nblock][slice][tap][big | small][NB][32] TF32, zero past C and Cout:
//    one (slice, tap) step is one contiguous run, copied by cp.async into a
//    ring of 3 stages two steps ahead of the MMAs; the group of a slice's
//    first tap also brings its raw halo.
//  * The tensor cores' fp32 accumulation does not round to nearest; each
//    step accumulates into its own registers, which fp32 adds fold into
//    the tile's sum, so the error follows one step's 32 channels.
//  * No split-K and no atomics: a repeated call gives the same bits. The
//    epilogue adds bias[b,co] and the residual in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- shared

__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }
// bf16 path: fast exp and reciprocal (a few fp32 ulps; the result is rounded to bf16)
__device__ __forceinline__ float silu_fast(float u) { return __fdividef(u, 1.f + __expf(-u)); }

// ---------------------------------------------------------------- bf16 kernel

constexpr int BKC = 32;           // channels per K slice
constexpr int TW = 8;             // tile width: one 8-pixel row is one wgmma core matrix

struct TcArgs {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  const __nv_bfloat16* wpk;      // packed weights, see the header
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  int B, H, W, C, Cout;
  int slices, tiles_x, tiles_y, stages, vec;
};

__host__ __device__ constexpr int halo_pixels(int th) { return (th + 2) * (TW + 2); }

// dynamic shared memory of one block: the weight ring, two normalised tiles,
// two raw halos, two sets of scale/shift, one mbarrier per stage
__host__ __device__ constexpr int tc_smem_bytes(int th, int nb, int stages) {
  return stages * BKC * nb * 2 + 4 * halo_pixels(th) * BKC * 2 + 4 * BKC * 4 + stages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the barrier's phase `parity` completes; traps (a launch error
// instead of a hung card) if a copy never lands.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    if (spins > (1LL << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// TMA bulk copy global -> shared, completion reported to bar
__device__ __forceinline__ void tma_bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy shared-memory stores made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major shared-memory matrix descriptors.
// No swizzle: core matrices of 8 rows x 16 bytes stored as 128 contiguous
// bytes; lbo = byte stride between core matrices along K, sbo = along M/N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// 64-byte swizzle: rows of 64 bytes (32 bf16 of K), 8-row atoms of 512 bytes
// in which the 16-byte chunk c of row n sits at c ^ ((n >> 1) & 3); sbo =
// 512 between atoms along N. The address advances by 32 bytes per k16 step.
__device__ __forceinline__ uint64_t make_desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// wgmma m64nNk16, f32 += bf16 * bf16, A and B from shared memory by descriptor
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<256> {
  __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One persistent block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of TH x 8 pixels (one image each) for the N block blockIdx.y of NB output
// channels. Warpgroup w owns the 8 x 8 pixels of tile rows
// 8w .. 8w+7, one wgmma m64 tile whose row m is pixel (8w + m/8, m%8). The
// block's work is a flat sequence of units (tile, 32-channel slice), each of
// nine steps (taps):
//  * the weight ring streams step after step, tile after tile, `stages` ahead;
//  * unit u multiplies the normalised tile anorm[u&1]; its steps 1.. also
//    normalise unit u+1's raw halo into anorm[(u+1)&1] (the SiLU work
//    overlaps the asynchronous wgmmas, one step of which stays in flight),
//    and unit u+2's raw halo and scale/shift are in flight (cp.async);
//  * the last unit of a tile stores it and clears the accumulators.
// The normalised tile is [4][halo pixel][8 channels]: eight neighbouring halo
// pixels of one row at one 8-channel chunk are one 128-byte core matrix, so
// the tap (dy, dx) window of a warpgroup's 8 x 8 pixels is a plain matrix
// descriptor (rows 160 bytes apart, chunks HP*16 bytes apart) whose start
// moves with (dy, dx).
template <int TH, int NB>
__global__ void __launch_bounds__(TH * TW * 2, 1) fgc_tc_kernel(const TcArgs a) {
  constexpr int NT = TH * TW * 2;
  constexpr int HW2 = TW + 2;
  constexpr int HP = halo_pixels(TH);
  constexpr int ITEMS = HP * (BKC / 8);           // (pixel, 8-channel chunk) items per unit
  constexpr int PARTS = (ITEMS + NT - 1) / NT;    // normalise items per thread per unit
  static_assert(PARTS <= 8, "normalise work must fit in steps 1..8");
  constexpr int NACC = NB / 2;
  constexpr uint32_t STAGE_BYTES = BKC * NB * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ns = a.stages;
  unsigned char* ring = smem;
  __nv_bfloat16* anorm = reinterpret_cast<__nv_bfloat16*>(smem + ns * STAGE_BYTES);  // [2][4][HP][8]
  __nv_bfloat16* raw = anorm + 2 * HP * BKC;                                          // [2][HP][BKC]
  float* coef = reinterpret_cast<float*>(raw + 2 * HP * BKC);                         // [2][scale 32 | shift 32]
  uint64_t* full = reinterpret_cast<uint64_t*>(coef + 4 * BKC);  // [ns] weights landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.slices;
  const int steps_per_tile = 9 * S;
  const int tiles_img = a.tiles_x * a.tiles_y;
  const int my_tiles = (a.B * tiles_img - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int units = my_tiles * S;
  const int total_steps = units * 9;
  const int n0 = blockIdx.y * NB;
  const __nv_bfloat16* wblk = a.wpk + (size_t)blockIdx.y * steps_per_tile * (BKC * NB);

  struct Tile { int b, oy, ox; };
  auto tile_of = [&](int u) {
    const int t = (int)blockIdx.x + (u / S) * (int)gridDim.x;
    const int b = t / tiles_img, r = t - b * tiles_img;
    return Tile{b, (r / a.tiles_x) * TH, (r % a.tiles_x) * TW};
  };

  auto issue_weights = [&](int g) {  // global step g into stage g % ns
    const int st = g % ns;
    mbar_expect_tx(&full[st], STAGE_BYTES);
    tma_bulk_g2s(ring + st * STAGE_BYTES, wblk + (size_t)(g % steps_per_tile) * (BKC * NB),
                 STAGE_BYTES, &full[st]);
  };

  // unit u's raw halo ((TH+2) x (TW+2) pixels x 32 channels, 0 where the pixel
  // or channel does not exist) and its scale/shift (0 past C) into buffer u&1
  auto load_unit = [&](int u) {
    const Tile tl = tile_of(u);
    const int c0 = (u % S) * BKC;
    __nv_bfloat16* dst0 = raw + (u & 1) * HP * BKC;
    for (int i = tid; i < ITEMS; i += NT) {
      const int p = i >> 2, q = i & 3;
      const int gy = tl.oy - 1 + p / HW2, gx = tl.ox - 1 + p % HW2;
      const int c = c0 + q * 8;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.C;
      const size_t off = ok ? (((size_t)tl.b * a.H + gy) * a.W + gx) * a.C + c : 0;
      __nv_bfloat16* dst = dst0 + p * BKC + q * 8;
      if (a.vec) {
        cp_async16(dst, a.x + off, ok ? 16 : 0);
      } else {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(a.x) + off;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = (ok && c + 2 * e < a.C) ? xs[2 * e] : 0u;
          const uint32_t hi = (ok && c + 2 * e + 1 < a.C) ? xs[2 * e + 1] : 0u;
          v[e] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (tid < 2 * BKC) {
      const int c = c0 + (tid & (BKC - 1));
      const float* src = (tid < BKC ? a.scale : a.shift) + (size_t)tl.b * a.C;
      cp_async4(coef + (u & 1) * 2 * BKC + tid, src + (c < a.C ? c : 0), c < a.C ? 4 : 0);
    }
    cp_async_commit();
  };

  // normalise this thread's item `part` of unit u: round(SiLU(x*scale+shift))
  // into anorm[u&1], exactly 0 outside the image (channels past C have
  // scale = shift = 0, so SiLU gives 0 there); then make the stores visible
  // to the wgmmas (async proxy)
  auto normalize_part = [&](int u, const Tile& tl, int part) {
    const int i = tid + part * NT;
    if (i >= ITEMS) return;
    const int q = i / HP, p = i - q * HP;
    const int gy = tl.oy - 1 + p / HW2, gx = tl.ox - 1 + p % HW2;
    const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const float* cf = coef + (u & 1) * 2 * BKC + q * 8;
    const float4 s0 = *reinterpret_cast<const float4*>(cf);
    const float4 s1 = *reinterpret_cast<const float4*>(cf + 4);
    const float4 h0 = *reinterpret_cast<const float4*>(cf + BKC);
    const float4 h1 = *reinterpret_cast<const float4*>(cf + BKC + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const uint4 rv = *reinterpret_cast<const uint4*>(raw + (u & 1) * HP * BKC + p * BKC + q * 8);
    const uint32_t w4[4] = {rv.x, rv.y, rv.z, rv.w};
    uint32_t o4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = silu_fast(bf16_lo(w4[e]) * sc[2 * e] + sh[2 * e]);
      const float hi = silu_fast(bf16_hi(w4[e]) * sc[2 * e + 1] + sh[2 * e + 1]);
      o4[e] = in ? pack_bf16x2(lo, hi) : 0u;
    }
    *reinterpret_cast<uint4*>(anorm + (u & 1) * HP * BKC + (q * HP + p) * 8) =
        make_uint4(o4[0], o4[1], o4[2], o4[3]);
    fence_proxy_async();
  };

  if (tid == 0) {
    if (smem_u32(ring) & 511) __trap();  // the 64-byte swizzle needs 512-byte atoms
    for (int i = 0; i < ns; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < ns && g < total_steps; ++g) issue_weights(g);
  load_unit(0);
  if (units > 1) {
    load_unit(1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    cp_async_wait_all();
  }
  __syncthreads();
  {
    const Tile t0 = tile_of(0);
#pragma unroll
    for (int part = 0; part < PARTS; ++part) normalize_part(0, t0, part);
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // this warpgroup's 8 x 8 pixels start at halo pixel (8w, 0)
  const uint32_t a_wg = smem_u32(anorm) + (warp / 4) * (8 * HW2) * 16;

  for (int u = 0; u < units; ++u) {
    cp_async_wait_all();  // unit u+1's halo and coefficients have landed
    __syncthreads();      // ... and unit u's normalised tile is complete
    if (u + 2 < units) load_unit(u + 2);
    const bool has_next = u + 1 < units;
    const Tile next = tile_of(u + 1);
    const uint32_t a_unit = a_wg + (u & 1) * HP * BKC * 2;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int g = u * 9 + t;
      const int st = g % ns;
      mbar_wait(&full[st], (uint32_t)((g / ns) & 1));
      const uint32_t a_tap = a_unit + ((t / 3) * HW2 + t % 3) * 16;
      const uint32_t b_st = smem_u32(ring + st * STAGE_BYTES);
      fence_acc<NACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Wgmma<NB>::run(acc, make_desc(a_tap + 2 * j * HP * 16, HP * 16, HW2 * 16),
                       make_desc_sw64(b_st + j * 32));
      wgmma_commit();
      fence_acc<NACC>(acc);
      // steps 1.. normalise the next unit while the wgmmas run; step 0's
      // barrier below has retired unit u-1, the last reader of that buffer
      if (t >= 1 && t <= PARTS && has_next) normalize_part(u + 1, next, t - 1);
      wgmma_wait<1>();  // step g-1 retired in this warpgroup
      fence_acc<NACC>(acc);
      // every warpgroup has retired step g-1: refill its stage. (Per-stage
      // "empty" mbarriers instead of this barrier, letting the warpgroups
      // drift apart, ran slower on the H100.)
      __syncthreads();
      if (tid == 0 && g >= 1 && g - 1 + ns < total_steps) issue_weights(g - 1 + ns);
    }
    if (u % S != S - 1) continue;

    // the tile is done: + bias[b,co] (+ residual) in fp32, one rounding, masked store
    wgmma_wait<0>();
    fence_acc<NACC>(acc);
    const Tile tl = tile_of(u);
    const int g8 = lane >> 2, t4 = lane & 3;
    const float* bias = a.bias + (size_t)tl.b * a.Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = warp * 16 + g8 + 8 * h;
      const int gy = tl.oy + pp / TW, gx = tl.ox + pp % TW;
      if (gy >= a.H || gx >= a.W) continue;
      const size_t obase = (((size_t)tl.b * a.H + gy) * a.W + gx) * a.Cout;
#pragma unroll
      for (int c = 0; c < NB / 8; ++c) {
        const int co = n0 + c * 8 + t4 * 2;
        float v0 = acc[c * 4 + 2 * h], v1 = acc[c * 4 + 2 * h + 1];
        if (co + 1 < a.Cout && !(a.Cout & 1)) {
          v0 += bias[co];
          v1 += bias[co + 1];
          if (a.res != nullptr) {
            const uint32_t rw = *reinterpret_cast<const uint32_t*>(a.res + obase + co);
            v0 += bf16_lo(rw);
            v1 += bf16_hi(rw);
          }
          *reinterpret_cast<uint32_t*>(a.out + obase + co) = pack_bf16x2(v0, v1);
        } else {
          if (co < a.Cout) {
            v0 += bias[co] + (a.res != nullptr ? __bfloat162float(a.res[obase + co]) : 0.f);
            a.out[obase + co] = __float2bfloat16(v0);
          }
          if (co + 1 < a.Cout) {
            v1 += bias[co + 1] + (a.res != nullptr ? __bfloat162float(a.res[obase + co + 1]) : 0.f);
            a.out[obase + co + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  }
}

// ---------------------------------------------------------------- fp32 kernel

constexpr int FTH = 8;            // tile rows
constexpr int FTW = 16;           // tile columns: one row is one m16 tile
constexpr int FHW = FTW + 2;      // halo row
constexpr int FHP = (FTH + 2) * FHW;  // halo pixels
constexpr int FBK = 32;           // channels per K slice
constexpr int FPS = FBK + 4;      // shared row stride in floats (144 B: conflict-free ldmatrix)
constexpr int FNT = 256;          // 8 warps
constexpr int FST = 3;            // weight stages (one per tap step)

struct TfArgs {
  const float* x;
  const float* scale;
  const float* shift;
  const float* wpk;  // packed weights: [nblock][slice][tap][big | small][NB][32], TF32
  const float* bias;
  const float* res;
  float* out;
  int B, H, W, C, Cout;
  int slices, tiles_x, tiles_y, vec;
};

// dynamic shared memory of one fp32 block: the raw halo of one slice, its
// scale/shift, the normalised halo's big and small halves, the weight ring
__host__ __device__ constexpr int tf_smem_bytes(int nb) {
  return (FHP * FBK + 2 * FBK + 2 * FHP * FPS + FST * 2 * nb * FPS) * 4;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void mma1688(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// round to nearest, ties away from zero, to TF32 (the low 13 bits zero)
__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// One block: the FTH x FTW pixel tile blockIdx.x of one image, the N block
// blockIdx.y of NB output channels. 8 warps as WM (pixels) x WN (channels);
// warp (wm, wn) owns tile rows wm*MT .. +MT-1 (one m16 tile per 16-pixel
// row) and NB/WN channels. The block walks steps (slice, tap), a ring of FST
// weight stages FST-1 steps ahead (cp.async, one commit group per step);
// the group of a slice's first step also carries the slice's raw halo and
// scale/shift, which that step normalises (fp32 SiLU, split into TF32 big
// and small halves, 0 outside the image by coordinate) into the halo tiles
// every tap then reads as shifted windows. Each product is split TF32:
// small*big + big*small + big*big on mma.sync m16n8k8, into a per-step
// accumulator that fp32 adds fold into the tile's sum (the tensor cores'
// fp32 accumulation does not round to nearest: its error then scales with
// one step's sum, not with the running one).
template <int NB>
__global__ void __launch_bounds__(FNT, 1) fgc_tf32x3_kernel(const TfArgs a) {
  constexpr int WN = NB >= 16 ? 2 : 1, WM = 8 / WN;
  constexpr int MT = FTH / WM;       // m16 tiles (tile rows) per warp
  constexpr int NTL = NB / WN / 8;   // n8 tiles per warp
  constexpr int STAGE = 2 * NB * FPS;  // floats per weight stage: [big | small][NB][FPS]
  static_assert(MT * WM == FTH && NTL >= 1, "warp layout");
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);  // [FHP][FBK]
  float* coef = raw + FHP * FBK;                // [scale 32 | shift 32]
  float* ab = coef + 2 * FBK;                   // [FHP][FPS] big
  float* as = ab + FHP * FPS;                   // [FHP][FPS] small
  float* ring = as + FHP * FPS;                 // [FST][2][NB][FPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles_img = a.tiles_x * a.tiles_y;
  const int b = blockIdx.x / tiles_img, r = blockIdx.x % tiles_img;
  const int oy = (r / a.tiles_x) * FTH, ox = (r % a.tiles_x) * FTW;
  const int n0 = blockIdx.y * NB;
  const int S = a.slices, steps = 9 * S;
  const float* wblk = a.wpk + (size_t)blockIdx.y * steps * (2 * NB * FBK);

  // one commit group per step g: its weights into stage g % FST, and at a
  // slice's first tap the slice's raw halo and scale/shift
  auto issue = [&](int g) {
    if (g < steps) {
      const float* src = wblk + (size_t)g * (2 * NB * FBK);
      float* dst = ring + (g % FST) * STAGE;
      for (int i = tid; i < 2 * NB * (FBK / 4); i += FNT) {
        const int row = i >> 3, ch = i & 7;  // row: half * NB + n
        cp_async16(dst + row * FPS + ch * 4, src + row * FBK + ch * 4, 16);
      }
      if (g % 9 == 0) {
        const int c0 = (g / 9) * FBK;
        if (a.vec) {
          for (int i = tid; i < FHP * (FBK / 4); i += FNT) {
            const int p = i >> 3, q = i & 7;
            const int gy = oy - 1 + p / FHW, gx = ox - 1 + p % FHW, c = c0 + q * 4;
            const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.C;
            const size_t off = ok ? (((size_t)b * a.H + gy) * a.W + gx) * a.C + c : 0;
            cp_async16(raw + p * FBK + q * 4, a.x + off, ok ? 16 : 0);
          }
        } else {
          for (int i = tid; i < FHP * FBK; i += FNT) {
            const int p = i / FBK, cc = i % FBK;
            const int gy = oy - 1 + p / FHW, gx = ox - 1 + p % FHW, c = c0 + cc;
            const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.C;
            const size_t off = ok ? (((size_t)b * a.H + gy) * a.W + gx) * a.C + c : 0;
            cp_async4(raw + i, a.x + off, ok ? 4 : 0);
          }
        }
        if (tid < 2 * FBK) {
          const int c = c0 + (tid & (FBK - 1));
          const float* src_c = (tid < FBK ? a.scale : a.shift) + (size_t)b * a.C;
          cp_async4(coef + tid, src_c + (c < a.C ? c : 0), c < a.C ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // the landed raw halo of one slice -> SiLU(x*scale + shift) in fp32, split
  // into TF32 halves; exactly 0 outside the image (channels past C have
  // scale = shift = 0, so SiLU gives 0 there)
  auto normalize = [&]() {
    for (int i = tid; i < FHP * (FBK / 4); i += FNT) {
      const int p = i >> 3, q = i & 7;
      const int gy = oy - 1 + p / FHW, gx = ox - 1 + p % FHW;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const float4 xv = *reinterpret_cast<const float4*>(raw + p * FBK + q * 4);
      const float4 sc = *reinterpret_cast<const float4*>(coef + q * 4);
      const float4 sh = *reinterpret_cast<const float4*>(coef + FBK + q * 4);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ss[4] = {sc.x, sc.y, sc.z, sc.w},
                  hs[4] = {sh.x, sh.y, sh.z, sh.w};
      float big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = in ? silu(xs[e] * ss[e] + hs[e]) : 0.f;
        big[e] = rna_tf32(v);
        small[e] = rna_tf32(v - big[e]);
      }
      *reinterpret_cast<float4*>(ab + p * FPS + q * 4) = make_float4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<float4*>(as + p * FPS + q * 4) =
          make_float4(small[0], small[1], small[2], small[3]);
    }
  };

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix lane roles on fp32 words. A: matrix i holds pixels 8*(i&1) +
  // 0..7 of an m16 row at channels 4*(i>>1) + 0..3, giving a0..a3. B (rows
  // n, k contiguous): matrix i holds channels n 8*(i>>1) + 0..7 at k
  // 4*(i&1) + 0..3, giving b0, b1 of two n8 tiles.
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 4;
  const int b_n = (lane & 7) + ((lane >> 4) & 1) * 8, b_k = ((lane >> 3) & 1) * 4;
  const uint32_t ab_s = smem_u32(ab), as_s = smem_u32(as), ring_s = smem_u32(ring);

#pragma unroll 1
  for (int g = 0; g < FST - 1; ++g) issue(g);
#pragma unroll 1
  for (int g = 0; g < steps; ++g) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FST - 2) : "memory");
    __syncthreads();  // step g's copies landed everywhere; step g-1's reads done
    if (g % 9 == 0) {
      normalize();
      __syncthreads();
    }
    issue(g + FST - 1);
    const int tap = g % 9, dy = tap / 3, dx = tap % 3;
    const uint32_t wst = ring_s + (g % FST) * STAGE * 4;
    float part[MT][NTL][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FBK / 8; ++kk) {
      uint32_t fab[MT][4], fas[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int hp = (wm * MT + mt + dy) * FHW + a_px + dx;
        const uint32_t off = (hp * FPS + kk * 8 + a_k) * 4;
        ldsm_x4(fab[mt], ab_s + off);
        ldsm_x4(fas[mt], as_s + off);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; nt += 2) {
        const int n = wn * (NB / WN) + nt * 8 + b_n;
        const uint32_t off_b = (n * FPS + kk * 8 + b_k) * 4;
        const uint32_t off_s = ((NB + n) * FPS + kk * 8 + b_k) * 4;
        uint32_t bb[4], bs[4];
        if constexpr (NTL == 1) {
          ldsm_x2(bb, wst + off_b);
          ldsm_x2(bs, wst + off_s);
        } else {
          ldsm_x4(bb, wst + off_b);
          ldsm_x4(bs, wst + off_s);
        }
#pragma unroll
        for (int h = 0; h < (NTL == 1 ? 1 : 2); ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float* d = part[mt][nt + h];
            mma1688(d, fas[mt], bb[2 * h], bb[2 * h + 1]);
            mma1688(d, fab[mt], bs[2 * h], bs[2 * h + 1]);
            mma1688(d, fab[mt], bb[2 * h], bb[2 * h + 1]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // + bias[b,co] (+ residual) in fp32, masked store
  const float* bias = a.bias + (size_t)b * a.Cout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gy = oy + wm * MT + mt;
    if (gy >= a.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = ox + g8 + 8 * h;
      if (gx >= a.W) continue;
      const size_t obase = (((size_t)b * a.H + gy) * a.W + gx) * a.Cout;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int co = n0 + wn * (NB / WN) + nt * 8 + t4 * 2;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (co + 1 < a.Cout && !(a.Cout & 1)) {
          v0 += bias[co];
          v1 += bias[co + 1];
          if (a.res != nullptr) {
            const float2 rv = *reinterpret_cast<const float2*>(a.res + obase + co);
            v0 += rv.x;
            v1 += rv.y;
          }
          *reinterpret_cast<float2*>(a.out + obase + co) = make_float2(v0, v1);
        } else {
          if (co < a.Cout)
            a.out[obase + co] = v0 + bias[co] + (a.res != nullptr ? a.res[obase + co] : 0.f);
          if (co + 1 < a.Cout)
            a.out[obase + co + 1] =
                v1 + bias[co + 1] + (a.res != nullptr ? a.res[obase + co + 1] : 0.f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// Per instantiation and device: the shared memory the kernel was allowed so
// far and the blocks per SM at the last stage count. Queried once, not per
// launch: the CUDA runtime queries cost more host time than a small launch takes.
struct LaunchCache {
  int smem_allowed = 0, occ_smem = -1, per_sm = 0, sms = 0;
};
constexpr int kMaxDevices = 16;

template <int TH, int NB>
cudaError_t launch_tc(const TcArgs& a, int n_blocks, cudaStream_t s) {
  static LaunchCache cache[kMaxDevices];
  const int smem = tc_smem_bytes(TH, NB, a.stages);
  auto kern = fgc_tc_kernel<TH, NB>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  LaunchCache& c = cache[dev];
  if (c.sms == 0 &&
      (e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if (smem > c.smem_allowed) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return e;
    c.smem_allowed = smem;
  }
  // persistent: as many blocks as fit on the card at once, at most one per tile
  if (smem != c.occ_smem) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kern, TH * TW * 2, smem)) !=
        cudaSuccess)
      return e;
    c.occ_smem = smem;
  }
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)a.B * a.tiles_x * a.tiles_y;
  const long long resident = ((long long)c.per_sm * c.sms + n_blocks - 1) / n_blocks;
  const dim3 grid((unsigned)(tiles < resident ? tiles : resident), (unsigned)n_blocks);
  kern<<<grid, TH * TW * 2, smem, s>>>(a);
  return cudaGetLastError();
}

template <int TH>
cudaError_t launch_nb(const TcArgs& a, int nb, int n_blocks, cudaStream_t s) {
  switch (nb) {
    case 8: return launch_tc<TH, 8>(a, n_blocks, s);
    case 64: return launch_tc<TH, 64>(a, n_blocks, s);
    case 128: return launch_tc<TH, 128>(a, n_blocks, s);
    case 256: return launch_tc<TH, 256>(a, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int NB>
cudaError_t launch_tf(const TfArgs& a, dim3 grid, cudaStream_t s) {
  static int allowed[kMaxDevices] = {};
  const int smem = tf_smem_bytes(NB);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    if ((e = cudaFuncSetAttribute(fgc_tf32x3_kernel<NB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return e;
    allowed[dev] = smem;
  }
  fgc_tf32x3_kernel<NB><<<grid, FNT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of one bf16 block for a tile height, N block and stage count.
extern "C" int fgc_tc_smem_bytes(int th, int nb, int stages) {
  return tc_smem_bytes(th, nb, stages);
}

// bf16 on the tensor cores. wpk: the packed weights of the plan
// ([ceil(Cout/nb)][ceil(C/32)][9][4][nb][8] bf16); tile th x 8 with th 8 or
// 16; nb: 8, 64, 128 or 256. res may be NULL. Returns cudaGetLastError().
extern "C" int fgc_tc_forward(const void* x, const void* scale, const void* shift, const void* wpk,
                              const void* bias, const void* res, void* out, int B, int H, int W,
                              int C, int Cout, int th, int nb, int stages, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || stages < 2 || (th != 8 && th != 16))
    return (int)cudaErrorInvalidValue;
  if (tc_smem_bytes(th, nb, stages) > 232448) return (int)cudaErrorInvalidValue;
  TcArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
           static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(wpk),
           static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
           static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout,
           (C + BKC - 1) / BKC, (W + TW - 1) / TW, (H + th - 1) / th, stages, C % 8 == 0};
  if ((long long)B * a.tiles_x * a.tiles_y > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_blocks = (Cout + nb - 1) / nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(th == 8 ? launch_nb<8>(a, nb, n_blocks, s) : launch_nb<16>(a, nb, n_blocks, s));
}

// Shared memory (bytes) of one fp32 block for an N block.
extern "C" int fgc_tf32_smem_bytes(int nb) { return tf_smem_bytes(nb); }

// fp32 on the tensor cores in split TF32. wpk: the packed weights of the
// plan ([ceil(Cout/nb)][ceil(C/32)][9][2][nb][32] fp32, TF32 big and small
// halves); nb: 8, 16, 32, 64 or 128. res may be NULL. Returns
// cudaGetLastError().
extern "C" int fgc_tf32_forward(const void* x, const void* scale, const void* shift,
                                const void* wpk, const void* bias, const void* res, void* out,
                                int B, int H, int W, int C, int Cout, int nb, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  TfArgs a{static_cast<const float*>(x), static_cast<const float*>(scale),
           static_cast<const float*>(shift), static_cast<const float*>(wpk),
           static_cast<const float*>(bias), static_cast<const float*>(res),
           static_cast<float*>(out), B, H, W, C, Cout,
           (C + FBK - 1) / FBK, (W + FTW - 1) / FTW, (H + FTH - 1) / FTH, C % 4 == 0};
  const long long tiles = (long long)B * a.tiles_x * a.tiles_y;
  const int n_blocks = (Cout + nb - 1) / nb;
  if (tiles > 0x7fffffffLL || n_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8: return (int)launch_tf<8>(a, grid, s);
    case 16: return (int)launch_tf<16>(a, grid, s);
    case 32: return (int)launch_tf<32>(a, grid, s);
    case 64: return (int)launch_tf<64>(a, grid, s);
    case 128: return (int)launch_tf<128>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
