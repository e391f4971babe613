// GroupNorm (+ SiLU) over NHWC activations, and the GroupNorm statistics of
// the fused ResBlock body as per-(B,C) scale and shift.
//
// Replaces instancediff_tpu/ops/pallas_kernels.py:group_norm_silu (Pallas
// kernel _gns_kernel) and the jnp statistics pass
// instancediff_tpu/ops/pallas_kernels.py:gn_channel_affine. For each (b, g),
// with Cg = C / G channels per group and n = H * W * Cg,
//
//   mean = sum(x) / n,  var = sum(x^2) / n - mean^2,  rstd = rsqrt(var + eps)
//   group_norm_silu:   y = ((x - mean) * rstd) * gamma[c] + beta[c], then y * sigmoid(y) if silu
//   gn_channel_affine: scale[b,c] = rstd * gamma[c],  shift[b,c] = beta[c] - mean * scale[b,c]
//
// with fp32 statistics and arithmetic, rounded once to T (bf16 or fp32) on
// store: the numerics of group_norm_silu_reference (E[x^2] - mean^2, not
// Welford).
//
// What bounds them on the H100: bytes. Both do a few operations per element;
// group_norm_silu must read x once and write y once, gn_channel_affine read x
// once. Three kernels:
//
//  gns_stats_kernel / gns_affine_kernel (one body): block (chunk, b) streams
//    `rows` rows of image b, all C channels of a row contiguously, with
//    U_STATS independent 16-byte loads in flight per thread. Each thread keeps
//    fp32 sum / sum of squares per channel (not per group: an 8-wide bf16
//    load straddles groups where Cg = 6, 17 or 22); the block reduces them
//    over its row groups (warp shuffles where a warp holds whole row groups,
//    then shared memory), folds the channels into groups and writes one
//    (sum, sum of squares) per group. The plan launches two blocks per SM
//    at every shape, so the 32^2 and 64^2 levels fill the card too.
//    The fold runs once per image: the last block of an image to finish (a
//    per-image ticket taken after __threadfence(), reset by that block) adds
//    the image's group partials in chunk order and writes the group mean and
//    rstd (for the apply pass) or scale and shift [2][B][C] (for the fused
//    conv). Only which block folds is racy; every sum is taken in a fixed
//    order, so results repeat bit for bit.
//  gns_apply_kernel: reads the folded mean / rstd, streams rows with
//    U_APPLY 16-byte loads and stores in flight (evict-first: each is touched
//    once), (x - mean) * rstd * gamma + beta in fp32, SiLU with __expf and a
//    fast division. It walks images and chunks in the reverse of the
//    statistics launch's order, so that its first reads find the rows that
//    launch read last still in L2. These two launches read x twice: their
//    floor is 1.5x the bound.
//  gns_cluster_kernel: where one image fits in the shared memory of a thread
//    block cluster, one launch of a cluster of CLUSTER = 8 blocks per image
//    loads the image into shared memory once while summing it, reduces the
//    group sums across the cluster through distributed shared memory
//    (cluster.sync, map_shared_rank, in rank order), then normalises from
//    shared memory and writes y: x is read once. The plan
//    (ops/group_norm_silu.py:gn_plan) takes it where it beat the two launches
//    on the card: the 32^2 levels up to 512 channels and 64^2 with 128.
//    (Clusters of 16 lost at every shape: only 7 fit on the card at once.)
//
//  gns_sums_kernel / gns_apply_kernel on ScaleShift: the two halves of
//    GroupNorm over an image split by rows across processes (H-sharded
//    sampling, ops/group_norm_silu.py:gn_partial_sums and gn_apply). The
//    sums launch is the statistics launch stopped before the group fold: it
//    writes each image's per-channel fp32 (sum, sum of squares) [2][B][C],
//    folded over its chunks in chunk order by the image's last block. The
//    callers add the shards' sums over the ranks, fold them to groups on the
//    host side (a few hundred scalars) and hand the apply launch a per-(B,C)
//    scale and shift: y = x * scale + shift, then SiLU.
//
// Every entry point issues all launches of one call, so the host crosses
// into this library once per call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;       // threads per block
constexpr int U_STATS = 8;    // 16-byte loads in flight per thread, statistics and cluster load
constexpr int U_APPLY = 4;    // 16-byte loads and stores in flight per thread, apply
constexpr int SMEM_LIMIT = 232448;
constexpr int CLUSTER = 8;     // blocks per image on the cluster path (portable size)
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float silu_fast(float u) { return __fdividef(u, 1.f + __expf(-u)); }

// VEC consecutive elements of T moved as one load / store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Loads and stores of the apply pass, which touches each x and y once:
// 16-byte packs with the evict-first hint (ld.global.cs / st.global.cs), so
// that streaming y out does not push from L2 the rows of x still to be read.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_last(const T* p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&v);
  } else {
    return *reinterpret_cast<const Pack<T, VEC>*>(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_streaming(T* p, const Pack<T, VEC>& o) {
  if constexpr (sizeof(Pack<T, VEC>) == 16)
    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&o));
  else
    *reinterpret_cast<Pack<T, VEC>*>(p) = o;
}

// The (column, row group) layout of every kernel: V = C / VEC vector
// columns; RG = NT / V row groups when a row fits the block, else 1. Thread
// i < V * RG owns column i % V of the rows r = rg, rg + RG, ... (rg = i / V).
// Where V is a power of two below 32 every warp holds 32 / V whole row groups
// and reduces them by shuffles first; then each warp is one shared-memory slot.
struct Layout {
  int V, RG, slots;
  bool shfl;
};

__host__ __device__ inline Layout layout(int C, int vec) {
  Layout L;
  L.V = C / vec;
  L.RG = L.V >= NT ? 1 : NT / L.V;
  L.shfl = L.V < 32 && (32 % L.V) == 0;
  L.slots = L.shfl ? NT / 32 : L.RG;
  return L;
}

// Shared memory of the block reduction: [slots][C] (sum, sumsq), [C] (sum,
// sumsq), [G] group (sum, sumsq), [max(NT, G)] fold scratch; in floats.
__host__ __device__ inline int red_floats(int C, int G, int vec) {
  const Layout L = layout(C, vec);
  return L.slots * C * 2 + C * 2 + G * 2 + (G > NT ? G : NT) * 2;
}

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// One work item's channel sums into slot `rg` of the reduction scratch
// (after shuffles over the warp's row groups, where L.shfl: then every
// thread holds exactly one work item and the slot is its warp).
template <int VEC>
__device__ __forceinline__ void put_sums(float (&s)[VEC], float (&q)[VEC], int cv, int rg,
                                         const Layout& L, int C, float* red) {
  int slot = rg;
  bool writer = true;
  if (L.shfl) {
    for (int off = L.V; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
      }
    }
    slot = threadIdx.x >> 5;
    writer = (int)(threadIdx.x & 31) < L.V;
  }
  if (writer) {
    float* dst = red + ((size_t)slot * C + cv * VEC) * 2;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dst[j * 2] = s[j];
      dst[j * 2 + 1] = q[j];
    }
  }
}

// The slots -> per-channel (sum, sumsq) in col = red + slots * C * 2, in a
// fixed order. Starts and ends with the block synchronised.
__device__ float* channel_sums(const Layout& L, int C, float* red) {
  float* col = red + L.slots * C * 2;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < L.slots; ++k) {
      a += red[((size_t)k * C + c) * 2];
      b += red[((size_t)k * C + c) * 2 + 1];
    }
    col[c * 2] = a;
    col[c * 2 + 1] = b;
  }
  __syncthreads();
  return col;
}

// The slots -> per-channel sums -> per-group (sum, sumsq) in gsum, each in a
// fixed order. Starts and ends with the block synchronised.
__device__ void group_sums(const Layout& L, int C, int G, float* red, float2* gsum) {
  const float* col = channel_sums(L, C, red);
  const int Cg = C / G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float a = 0.f, b = 0.f;
    for (int c = g * Cg; c < (g + 1) * Cg; ++c) {
      a += col[c * 2];
      b += col[c * 2 + 1];
    }
    gsum[g] = make_float2(a, b);
  }
  __syncthreads();
}

__device__ __forceinline__ float2 mean_rstd(float2 sums, float n, float eps) {
  const float mean = sums.x / n;
  const float var = sums.y / n - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

// Sums of one column's rows [r0 + rg, r1) step RG (xc points at the column
// of image row 0), U_STATS loads in flight; with STORE each pack is also
// stored to shared memory at xs + (r - r0) * C.
template <typename T, int VEC, bool STORE>
__device__ __forceinline__ void stream_sums(const T* __restrict__ xc, int r0, int r1, int rg,
                                            int RG, int C, T* xs, float (&s)[VEC],
                                            float (&q)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  for (int r = r0 + rg; r < r1; r += U_STATS * RG) {
    Pack<T, VEC> p[U_STATS];
#pragma unroll
    for (int u = 0; u < U_STATS; ++u) {
      const int rr = r + u * RG;
      if (rr < r1) p[u] = *reinterpret_cast<const Pack<T, VEC>*>(xc + (size_t)rr * C);
    }
#pragma unroll
    for (int u = 0; u < U_STATS; ++u) {
      const int rr = r + u * RG;
      if (rr < r1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f(p[u].v[j]);
          s[j] += f;
          q[j] = fmaf(f, f, q[j]);
        }
        if (STORE) *reinterpret_cast<Pack<T, VEC>*>(xs + (size_t)(rr - r0) * C) = p[u];
      }
    }
  }
}

// The statistics launch, grid (chunks, B): block (chunk, b) writes the group
// partials of rows [chunk * rows, ...) of image b to partials[b][chunk]; the
// block that takes the image's last ticket folds them, writes gstat [B][G]
// (mean, rstd) and / or scale_shift [2][B][C] where given, and resets the
// ticket.
template <typename T, int VEC>
__device__ __forceinline__ void stats_body(const T* __restrict__ x,
                                           float2* __restrict__ partials,
                                           unsigned* __restrict__ tickets,
                                           float2* __restrict__ gstat,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float* __restrict__ scale_shift, int HW, int C, int G,
                                           int rows, float eps) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  const Layout L = layout(C, VEC);
  float2* gsum = reinterpret_cast<float2*>(red + L.slots * C * 2 + C * 2);
  float2* tail = gsum + G;
  __shared__ bool is_last;

  const int B = gridDim.y, b = blockIdx.y, chunks = gridDim.x, chunk = blockIdx.x;
  const int i = threadIdx.x;
  const int r0 = chunk * rows, r1 = min(HW, r0 + rows);
  const T* xb = x + (size_t)b * HW * C;
  // one work item per thread where a row fits the block (V <= NT), else
  // several columns per thread (RG = 1)
  for (int w = i; w < L.V * L.RG; w += NT) {
    const int cv = w % L.V, rg = w / L.V;
    float s[VEC], q[VEC];
    stream_sums<T, VEC, false>(xb + cv * VEC, r0, r1, rg, L.RG, C, nullptr, s, q);
    put_sums<VEC>(s, q, cv, rg, L, C, red);
  }
  group_sums(L, C, G, red, gsum);

  float2* pb = partials + (size_t)b * chunks * G;
  for (int g = i; g < G; g += NT) {
    pb[(size_t)chunk * G + g] = gsum[g];
    __threadfence();
  }
  __syncthreads();
  if (i == 0) is_last = atomicAdd(&tickets[b], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!is_last) return;

  // the fold: this image's partials, chunk by chunk, P parts per group
  __threadfence();
  const int P = G >= NT ? 1 : NT / G;
  for (int t = i; t < P * G; t += NT) {
    const int g = t % G, p = t / G;
    float a = 0.f, c2 = 0.f;
#pragma unroll 4
    for (int k = p; k < chunks; k += P) {
      const float2 v = __ldcg(pb + (size_t)k * G + g);
      a += v.x;
      c2 += v.y;
    }
    tail[t] = make_float2(a, c2);
  }
  __syncthreads();
  const float n = (float)HW * (float)(C / G);
  for (int g = i; g < G; g += NT) {
    float2 sums = make_float2(0.f, 0.f);
    for (int p = 0; p < P; ++p) {
      sums.x += tail[p * G + g].x;
      sums.y += tail[p * G + g].y;
    }
    const float2 mr = mean_rstd(sums, n, eps);
    if (gstat != nullptr) gstat[(size_t)b * G + g] = mr;
    gsum[g] = mr;
  }
  if (scale_shift != nullptr) {
    __syncthreads();
    const int Cg = C / G;
    float* sc = scale_shift + (size_t)b * C;
    float* sh = scale_shift + ((size_t)B + b) * C;
    for (int c = i; c < C; c += NT) {
      const float2 mr = gsum[c / Cg];
      const float v = mr.y * gamma[c];
      sc[c] = v;
      sh[c] = beta[c] - mr.x * v;
    }
  }
  if (i == 0) tickets[b] = 0u;
}

// Two blocks per SM: up to 128 registers a thread, so that the U_STATS
// loads stay in flight together (at 64 the compiler serialised them).
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, 2)
    gns_stats_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                     unsigned* __restrict__ tickets, float2* __restrict__ gstat, int HW, int C,
                     int G, int rows, float eps) {
  stats_body<T, VEC>(x, partials, tickets, gstat, nullptr, nullptr, nullptr, HW, C, G, rows, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT, 2)
    gns_affine_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                      unsigned* __restrict__ tickets, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ scale_shift, int HW,
                      int C, int G, int rows, float eps) {
  stats_body<T, VEC>(x, partials, tickets, nullptr, gamma, beta, scale_shift, HW, C, G, rows,
                     eps);
}

// The per-channel sums launch, grid (chunks, B): block (chunk, b) writes
// the channel (sum, sumsq) of rows [chunk * rows, ...) of image b to
// partials[b][chunk][C]; the block that takes the image's last ticket adds
// them in chunk order into sums [2][B][C] and resets the ticket.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, 2)
    gns_sums_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                    unsigned* __restrict__ tickets, float* __restrict__ sums, int HW, int C,
                    int rows) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  const Layout L = layout(C, VEC);
  __shared__ bool is_last;

  const int B = gridDim.y, b = blockIdx.y, chunks = gridDim.x, chunk = blockIdx.x;
  const int i = threadIdx.x;
  const int r0 = chunk * rows, r1 = min(HW, r0 + rows);
  const T* xb = x + (size_t)b * HW * C;
  for (int w = i; w < L.V * L.RG; w += NT) {
    const int cv = w % L.V, rg = w / L.V;
    float s[VEC], q[VEC];
    stream_sums<T, VEC, false>(xb + cv * VEC, r0, r1, rg, L.RG, C, nullptr, s, q);
    put_sums<VEC>(s, q, cv, rg, L, C, red);
  }
  const float2* col = reinterpret_cast<const float2*>(channel_sums(L, C, red));

  float2* pb = partials + (size_t)b * chunks * C;
  for (int c = i; c < C; c += NT) {
    pb[(size_t)chunk * C + c] = col[c];
    __threadfence();
  }
  __syncthreads();
  if (i == 0) is_last = atomicAdd(&tickets[b], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!is_last) return;

  __threadfence();
  for (int c = i; c < C; c += NT) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float2 v = __ldcg(pb + (size_t)k * C + c);
      a += v.x;
      q += v.y;
    }
    sums[(size_t)b * C + c] = a;
    sums[((size_t)B + b) * C + c] = q;
  }
  if (i == 0) tickets[b] = 0u;
}

// What the apply launch normalises with: the folded group (mean, rstd)
// [B][G] with gamma and beta [C], or a per-(b, c) scale_shift [2][B][C].
struct Coefs {
  const float2* gstat;
  const float *gamma, *beta, *scale_shift;
  int B;
};

// The normalise of one column's packs: per-channel mean, rstd, gamma, beta.
template <int VEC>
struct Affine {
  float mu[VEC], rs[VEC], ga[VEC], be[VEC];

  __device__ __forceinline__ Affine(const float2* mr, const float* gamma, const float* beta,
                                    int c0, int Cg) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float2 m = mr[(c0 + j) / Cg];
      mu[j] = m.x;
      rs[j] = m.y;
      ga[j] = gamma[c0 + j];
      be[j] = beta[c0 + j];
    }
  }

  static __device__ __forceinline__ Affine at(const Coefs& k, int b, int c0, int C, int G) {
    return Affine(k.gstat + (size_t)b * G, k.gamma, k.beta, c0, C / G);
  }

  template <bool SILU, typename T>
  __device__ __forceinline__ Pack<T, VEC> apply(const Pack<T, VEC>& p) const {
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = (to_f(p.v[j]) - mu[j]) * rs[j];
      y = y * ga[j] + be[j];
      if (SILU) y = silu_fast(y);
      put(&o.v[j], y);
    }
    return o;
  }
};

// The same for a per-(b, c) scale and shift: y = x * scale + shift.
template <int VEC>
struct ScaleShift {
  float sc[VEC], sh[VEC];

  static __device__ __forceinline__ ScaleShift at(const Coefs& k, int b, int c0, int C, int) {
    ScaleShift f;
    const float* scale = k.scale_shift + (size_t)b * C + c0;
    const float* shift = k.scale_shift + ((size_t)k.B + b) * C + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      f.sc[j] = scale[j];
      f.sh[j] = shift[j];
    }
    return f;
  }

  template <bool SILU, typename T>
  __device__ __forceinline__ Pack<T, VEC> apply(const Pack<T, VEC>& p) const {
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = to_f(p.v[j]) * sc[j] + sh[j];
      if (SILU) y = silu_fast(y);
      put(&o.v[j], y);
    }
    return o;
  }
};

// The apply launch, grid (chunks, B), after the statistics launch: rows
// [chunk * rows, ...) of image b, normalised with image b's coefficients
// (Coef: Affine, image b's (mean, rstd) with gamma and beta; ScaleShift),
// U_APPLY 16-byte loads and stores in flight per thread. It walks images
// and chunks in the reverse of the statistics launch's order, so that its
// first reads find the rows that launch read last still in L2.
template <typename T, int VEC, bool SILU, template <int> class Coef>
__global__ void __launch_bounds__(NT, 2)
    gns_apply_kernel(const T* __restrict__ x, const Coefs k, T* __restrict__ out, int HW, int C,
                     int G, int rows) {
  const Layout L = layout(C, VEC);
  const int b = gridDim.y - 1 - blockIdx.y;
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int r0 = chunk * rows, r1 = min(HW, r0 + rows);
  for (int w = threadIdx.x; w < L.V * L.RG; w += NT) {
    const int cv = w % L.V, rg = w / L.V;
    const Coef<VEC> f = Coef<VEC>::at(k, b, cv * VEC, C, G);
    const size_t base = (size_t)b * HW * C + cv * VEC;
    const T* xc = x + base;
    T* oc = out + base;
    for (int r = r0 + rg; r < r1; r += U_APPLY * L.RG) {
      Pack<T, VEC> p[U_APPLY];
#pragma unroll
      for (int u = 0; u < U_APPLY; ++u) {
        const int rr = r + u * L.RG;
        if (rr < r1) p[u] = load_last<T, VEC>(xc + (size_t)rr * C);
      }
#pragma unroll
      for (int u = 0; u < U_APPLY; ++u) {
        const int rr = r + u * L.RG;
        if (rr < r1) store_streaming<T, VEC>(oc + (size_t)rr * C, f.template apply<SILU>(p[u]));
      }
    }
  }
}

// Shared memory of the cluster kernel: the block's rows of x, then the block
// reduction, then (mean, rstd) per group.
__host__ __device__ inline int cluster_smem(int rows, int C, int G, int vec, int tsize) {
  return align16(rows * C * tsize) + (red_floats(C, G, vec) + G * 2) * 4;
}

// One launch per call where an image fits a cluster: grid (CLUSTER, B),
// cluster (CLUSTER, 1, 1); block `rank` owns rows [rank * rows, ...) of image b.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(NT, 1)
    gns_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ out, int HW, int C, int G,
                       int rows, float eps) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(C, VEC);
  T* xs = reinterpret_cast<T*>(smem4);
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        align16(rows * C * (int)sizeof(T)));
  float2* gsum = reinterpret_cast<float2*>(red + L.slots * C * 2 + C * 2);
  float2* gmr = reinterpret_cast<float2*>(red + red_floats(C, G, VEC));

  const int b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * rows, r1 = min(HW, r0 + rows);
  const T* xb = x + (size_t)b * HW * C;
  T* ob = out + (size_t)b * HW * C;
  for (int w = threadIdx.x; w < L.V * L.RG; w += NT) {
    const int cv = w % L.V, rg = w / L.V;
    float s[VEC], q[VEC];
    stream_sums<T, VEC, true>(xb + cv * VEC, r0, r1, rg, L.RG, C, xs + cv * VEC, s, q);
    put_sums<VEC>(s, q, cv, rg, L, C, red);
  }
  group_sums(L, C, G, red, gsum);

  cluster.sync();  // every block's group sums are in its shared memory
  const float n = (float)HW * (float)(C / G);
  for (int g = threadIdx.x; g < G; g += NT) {
    float2 sums = make_float2(0.f, 0.f);
    for (int k = 0; k < (int)gridDim.x; ++k) {
      const float2 v = cluster.map_shared_rank(gsum, k)[g];
      sums.x += v.x;
      sums.y += v.y;
    }
    gmr[g] = mean_rstd(sums, n, eps);
  }
  __syncthreads();

  for (int w = threadIdx.x; w < L.V * L.RG; w += NT) {
    const int cv = w % L.V, rg = w / L.V;
    const Affine<VEC> f(gmr, gamma, beta, cv * VEC, C / G);
    const T* xc = xs + cv * VEC;
    T* oc = ob + cv * VEC;
    for (int r = r0 + rg; r < r1; r += L.RG) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xc + (size_t)(r - r0) * C);
      *reinterpret_cast<Pack<T, VEC>*>(oc + (size_t)r * C) = f.template apply<SILU>(p);
    }
  }
  cluster.sync();  // no block leaves while another may still read its group sums
}

// ---------------------------------------------------------------- launch

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Allow a kernel `smem` bytes of dynamic shared memory, once per device and
// launch site (the runtime calls cost more host time than a small launch
// takes); never less than it was allowed before.
struct AttrCache {
  int smem[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t allow(AttrCache& c, Kernel k, int smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= c.smem[dev]) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  c.smem[dev] = smem;
  return cudaSuccess;
}

struct Call {
  const void *x, *gamma, *beta;
  void *out, *partials, *gstat, *tickets;
  int B, HW, C, G;
  float eps;
  int silu, rows, cluster;
  cudaStream_t s;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int VEC>
cudaError_t stats_launch(const Call& a, bool affine) {
  const int smem = red_floats(a.C, a.G, VEC) * 4;
  const dim3 grid(cdiv(a.HW, a.rows), a.B);
  const T* x = static_cast<const T*>(a.x);
  float2* partials = static_cast<float2*>(a.partials);
  unsigned* tickets = static_cast<unsigned*>(a.tickets);
  cudaError_t e;
  if (affine) {
    static AttrCache cache;
    if ((e = allow(cache, gns_affine_kernel<T, VEC>, smem)) != cudaSuccess) return e;
    gns_affine_kernel<T, VEC><<<grid, NT, smem, a.s>>>(
        x, partials, tickets, static_cast<const float*>(a.gamma),
        static_cast<const float*>(a.beta), static_cast<float*>(a.out), a.HW, a.C, a.G, a.rows,
        a.eps);
  } else {
    static AttrCache cache;
    if ((e = allow(cache, gns_stats_kernel<T, VEC>, smem)) != cudaSuccess) return e;
    gns_stats_kernel<T, VEC><<<grid, NT, smem, a.s>>>(x, partials, tickets,
                                                       static_cast<float2*>(a.gstat), a.HW, a.C,
                                                       a.G, a.rows, a.eps);
  }
  return cudaGetLastError();
}

template <typename T, int VEC, bool SILU>
cudaError_t forward_launch(const Call& a) {
  const T* x = static_cast<const T*>(a.x);
  const float* gamma = static_cast<const float*>(a.gamma);
  const float* beta = static_cast<const float*>(a.beta);
  T* out = static_cast<T*>(a.out);
  cudaError_t e;
  if (a.cluster > 0) {
    const int rows = cdiv(a.HW, CLUSTER);
    const int smem = cluster_smem(rows, a.C, a.G, VEC, (int)sizeof(T));
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    auto kern = gns_cluster_kernel<T, VEC, SILU>;
    static AttrCache cache;
    if ((e = allow(cache, kern, smem)) != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER, a.B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((e = cudaLaunchKernelEx(&cfg, kern, x, gamma, beta, out, a.HW, a.C, a.G, rows, a.eps)) !=
        cudaSuccess)
      return e;
    return cudaGetLastError();
  }
  if ((e = stats_launch<T, VEC>(a, false)) != cudaSuccess) return e;
  const dim3 grid(cdiv(a.HW, a.rows), a.B);
  const Coefs k{static_cast<const float2*>(a.gstat), gamma, beta, nullptr, a.B};
  gns_apply_kernel<T, VEC, SILU, Affine><<<grid, NT, 0, a.s>>>(x, k, out, a.HW, a.C, a.G,
                                                                a.rows);
  return cudaGetLastError();
}

// The sharded halves: kind 0 the sums launch (a.out = sums [2][B][C]),
// kind 1 the apply launch on a.gamma = scale_shift [2][B][C].
template <typename T, int VEC>
cudaError_t sharded_launch(const Call& a, int kind) {
  const dim3 grid(cdiv(a.HW, a.rows), a.B);
  const T* x = static_cast<const T*>(a.x);
  if (kind == 0) {
    const Layout L = layout(a.C, VEC);
    const int smem = (L.slots * a.C * 2 + a.C * 2) * 4;
    static AttrCache cache;
    cudaError_t e;
    if ((e = allow(cache, gns_sums_kernel<T, VEC>, smem)) != cudaSuccess) return e;
    gns_sums_kernel<T, VEC><<<grid, NT, smem, a.s>>>(
        x, static_cast<float2*>(a.partials), static_cast<unsigned*>(a.tickets),
        static_cast<float*>(a.out), a.HW, a.C, a.rows);
  } else {
    const Coefs k{nullptr, nullptr, nullptr, static_cast<const float*>(a.gamma), a.B};
    T* out = static_cast<T*>(a.out);
    if (a.silu)
      gns_apply_kernel<T, VEC, true, ScaleShift><<<grid, NT, 0, a.s>>>(x, k, out, a.HW, a.C, 1,
                                                                        a.rows);
    else
      gns_apply_kernel<T, VEC, false, ScaleShift><<<grid, NT, 0, a.s>>>(x, k, out, a.HW, a.C, 1,
                                                                         a.rows);
  }
  return cudaGetLastError();
}

// vec: the plan's vector width, 16 bytes or 1 element; 16 bytes needs C a
// multiple of it and 16-byte aligned x (and out).
// sharded: -1 for gns_forward / gns_affine, else sharded_launch's kind.
template <typename T>
cudaError_t dispatch(const Call& a, int vec, bool affine, int sharded) {
  constexpr int V16 = 16 / sizeof(T);
  if (vec == V16) {
    if (a.C % V16 != 0 || !aligned16(a.x) || (!affine && sharded != 0 && !aligned16(a.out)))
      return cudaErrorInvalidValue;
    if (sharded >= 0) return sharded_launch<T, V16>(a, sharded);
    if (affine) return stats_launch<T, V16>(a, true);
    return a.silu ? forward_launch<T, V16, true>(a) : forward_launch<T, V16, false>(a);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (sharded >= 0) return sharded_launch<T, 1>(a, sharded);
  if (affine) return stats_launch<T, 1>(a, true);
  return a.silu ? forward_launch<T, 1, true>(a) : forward_launch<T, 1, false>(a);
}

bool bad_sizes(int B, int HW, int C, int G, int rows) {
  return B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || rows <= 0 || B > 65535;
}

int run(const Call& a, int dtype, int vec, bool affine, int sharded = -1) {
  if (dtype == 0) return (int)dispatch<float>(a, vec, affine, sharded);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, vec, affine, sharded);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory (bytes) of one block: kind 0 the statistics kernels, kind 1
// the cluster kernel with `rows` rows per block of elements of tsize bytes.
extern "C" int gns_smem_bytes(int kind, int C, int G, int vec, int rows, int tsize) {
  return kind == 0 ? red_floats(C, G, vec) * 4 : cluster_smem(rows, C, G, vec, tsize);
}

// out = SiLU?(GroupNorm(x) * gamma + beta), x/out [B, HW, C] in dtype (0 =
// float32, 1 = bfloat16), gamma/beta [C] float32. cluster = 8: one launch of
// clusters of 8 blocks per image; cluster = 0: the statistics launch and the
// apply launch, `rows` rows per block each. Scratch:
// partials [B][ceil(HW/rows)][G] float2, gstat [B][G] float2, tickets [B]
// uint32, zero at the first call and left zero by every call. Returns the
// first CUDA error.
extern "C" int gns_forward(const void* x, const void* gamma, const void* beta, void* out,
                           void* partials, void* gstat, void* tickets, int B, int HW, int C,
                           int G, float eps, int silu, int dtype, int vec, int rows, int cluster,
                           void* stream) {
  if (bad_sizes(B, HW, C, G, rows) || (cluster != 0 && cluster != CLUSTER))
    return (int)cudaErrorInvalidValue;
  const Call a{x, gamma, beta, out, partials, gstat, tickets, B, HW, C, G, eps, silu, rows,
               cluster, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, vec, false);
}

// scale_shift [2][B][C] float32: scale = rstd * gamma, shift = beta - mean *
// scale, per (b, c), from one statistics launch of `rows` rows per block.
// Scratch as for gns_forward (no gstat). Returns the first CUDA error.
extern "C" int gns_affine(const void* x, const void* gamma, const void* beta, void* scale_shift,
                          void* partials, void* tickets, int B, int HW, int C, int G, float eps,
                          int dtype, int vec, int rows, void* stream) {
  if (bad_sizes(B, HW, C, G, rows)) return (int)cudaErrorInvalidValue;
  const Call a{x, gamma, beta, scale_shift, partials, nullptr, tickets, B, HW, C, G, eps, 0,
               rows, 0, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, vec, true);
}

// sums [2][B][C] float32: each channel's sum and sum of squares over the
// HW rows of each image, from one launch of `rows` rows per block.
// Scratch: partials [B][ceil(HW/rows)][C] float2, tickets as for
// gns_forward. Returns the first CUDA error.
extern "C" int gns_partial_sums(const void* x, void* sums, void* partials, void* tickets, int B,
                                int HW, int C, int dtype, int vec, int rows, void* stream) {
  if (bad_sizes(B, HW, C, 1, rows)) return (int)cudaErrorInvalidValue;
  const Call a{x, nullptr, nullptr, sums, partials, nullptr, tickets, B, HW, C, 1, 0.f, 0, rows,
               0, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, vec, false, 0);
}

// out = SiLU?(x * scale + shift) per (b, c), x/out [B, HW, C] in dtype,
// scale_shift [2][B][C] float32 (scale, then shift); one launch of `rows`
// rows per block. Returns the first CUDA error.
extern "C" int gns_apply_affine(const void* x, const void* scale_shift, void* out, int B, int HW,
                                int C, int silu, int dtype, int vec, int rows, void* stream) {
  if (bad_sizes(B, HW, C, 1, rows)) return (int)cudaErrorInvalidValue;
  const Call a{x, scale_shift, nullptr, out, nullptr, nullptr, nullptr, B, HW, C, 1, 0.f, silu,
               rows, 0, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, vec, false, 1);
}
