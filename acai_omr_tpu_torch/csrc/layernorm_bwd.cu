// K8 layernorm_bwd: backward of y = LayerNorm(z) * gamma + beta given the
// saved pre-norm sum z: dz per row, dgamma and dbeta as column sums.
//
// Replaces: `_ln_bwd` of ops/pallas_train_layer.py `_bwd_kernel` in the JAX
// package (the three post-norm LayerNorms of a decoder layer, two of an
// encoder layer), together with the `_apply_drop` that follows it: the
// gradient that flows on into the branch (`dff`, `dca`, `dsa`) is dz with the
// forward's dropout mask applied, the gradient of the residual is dz itself.
//
// g, z: (R, E) bf16; gamma: (E,) fp32. Outputs: dz (R, E) bf16; dz_drop (R, E)
// bf16 or null; dgamma, dbeta (E,) fp32. E % 128 == 0, E <= 1024.
//
// Numerics follow `_ln_bwd`: statistics recomputed in fp32 from z (biased
// variance, eps), gg = g * gamma, dz = inv * (gg - mean(gg) - zh * mean(gg *
// zh)) rounded to bf16 once; dgamma = sum_r g * zh and dbeta = sum_r g in fp32
// over all rows in a fixed order (no atomics: two runs give equal bits).
//
// Bound on an H100: bytes (g and z in, one or two rows out) at 3.35 TB/s.
//
// Design (`acai_layernorm_bwd_one_pass`): one launch that reads g and z once.
// A grid of one or two blocks an SM (ops/layernorm_bwd_kernel.py
// `layernorm_bwd_plan`); block k walks the contiguous rows
// [k R / G, (k + 1) R / G), a warp per row at a time, the next row's g and z
// loaded before this row is computed. 16-byte loads and stores: 8 columns a
// lane per 256-column group where E % 256 == 0, else 4 columns a lane (8
// bytes) per 128-column group; gamma is in shared memory before the first
// row. Each lane keeps its columns' sums of g * zh and g in registers across
// its rows, so the column sums need no second read of g and z and no per-row
// statistics. At the end of its rows a block sums its warps' partials
// through shared memory in warp order and writes one (2, E) fp32 partial.
// The final sum is deterministic and has no float atomics: the last block of
// each group of `group` consecutive blocks to finish (an integer ticket,
// atomicAdd on an int after a __threadfence) sums its group's partials in
// block order; the last group to finish (a second ticket) sums the groups'
// sums in group order into dgamma / dbeta. Each ticket is reset by the block
// that drew the last number, so the counters are zero again for the next
// launch. Two levels, not one: one SM reads the partials from L2 at about
// 100 GB/s, so one block summing a (2, E) partial for each of 132-264
// blocks would take longer than the rows. Timed on an H100 80GB HBM3
// (700 W): two rows in flight a warp, two blocks an SM at E = 768 (spilling)
// and the blocks' partials summed through distributed shared memory in
// clusters of 8 (fewer blocks resident at once) were each slower than this
// form; the two-level sum costs about 5 us at 2,048 rows (fences, tickets
// and loads in turn), more or fewer loads in flight changing nothing.
//
// The form it replaced (`acai_layernorm_bwd`, kept as the yardstick,
// `variant="three_pass"`): three launches. (1) one warp per row, each lane
// holding E/32 values as groups of four neighbouring columns (8-byte
// accesses, one Philox call per group), writes dz, dz_drop and the row's
// (mean, inv); (2) column partial sums over slabs of 256 rows, 32 columns by
// 8 row lanes per block, reading g and z a second time, reduced through
// shared memory in a fixed order; (3) the sum over the slabs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout.cuh"
#include "func_attrs.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- the one-pass kernel

namespace one {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TICKETS = 64;  // the group tickets and the final one
constexpr int CHUNK = 4;         // partials' loads in flight a column step

// The columns of E: V columns a lane in groups of 32 V (16-byte accesses
// where E % 256 == 0), C = E / 32 columns a lane.
template <int E>
struct Cols {
  static constexpr int V = E % 256 == 0 ? 8 : 4;
  static constexpr int GROUPS = E / (32 * V);
  static constexpr int C = E / 32;
  // blocks an SM the registers allow (the plan's rule)
  static constexpr int MIN_BLOCKS = E <= 512 ? 2 : 1;
  // gamma, then the warps' partials: [1 + 2 WARPS][E] fp32
  static constexpr int SMEM = (1 + 2 * WARPS) * E * 4;
  // column steps of four floats a thread over a (2, E) partial
  static constexpr int STEPS = (2 * E + THREADS * 4 - 1) / (THREADS * 4);
};

// One lane's V bf16 of a row: 16 or 8 bytes.
template <int V>
struct Raw;
template <>
struct Raw<8> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float* v) const {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};
template <>
struct Raw<4> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void unpack(float* v) const {
    const unsigned u[2] = {w.x, w.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* v) {
  unsigned u[V / 2];
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}

// Lane column of group i, element 0.
template <int E>
__device__ __forceinline__ int col(int i, int lane) {
  return (i * 32 + lane) * Cols<E>::V;
}

__device__ __forceinline__ void add4(float4& s, const float4& p) {
  s.x += p.x;
  s.y += p.y;
  s.z += p.z;
  s.w += p.w;
}

// The sums over n (2, E) fp32 partials at `src` in their order, into dst (a
// (2, E) partial) or, with `final`, into dgamma (row 0) and dbeta (row 1).
// Four floats a thread a column step, every step's CHUNK loads in flight
// before they are added; through L2 (other blocks of this launch wrote
// them).
template <int E>
__device__ __forceinline__ void sum_partials(const float* src, int n,
                                             float* dst, float* dgamma,
                                             float* dbeta, bool final) {
  constexpr int STEPS = Cols<E>::STEPS;
  float4 s[STEPS];
  for (int k0 = 0; k0 < n; k0 += CHUNK) {
    float4 p[STEPS][CHUNK];
#pragma unroll
    for (int q = 0; q < STEPS; ++q) {
      const int i = q * THREADS * 4 + threadIdx.x * 4;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        if (i < 2 * E && k0 + u < n)
          p[q][u] = __ldcg(reinterpret_cast<const float4*>(
              src + (size_t)(k0 + u) * 2 * E + i));
    }
#pragma unroll
    for (int q = 0; q < STEPS; ++q)
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (k0 + u == 0)
          s[q] = p[q][u];
        else if (k0 + u < n)
          add4(s[q], p[q][u]);
      }
  }
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    const int i = q * THREADS * 4 + threadIdx.x * 4;
    if (i >= 2 * E) continue;
    if (!final)
      *reinterpret_cast<float4*>(dst + i) = s[q];
    else
      *reinterpret_cast<float4*>(i < E ? dgamma + i : dbeta + i - E) = s[q];
  }
}

// partial: (G, 2, E) fp32; group_sum: (ceil(G / group), 2, E) fp32;
// tickets: MAX_TICKETS ints, zero at the launch and again after it.
template <int E>
__global__ void __launch_bounds__(THREADS, Cols<E>::MIN_BLOCKS)
ln_bwd_one_pass(const __nv_bfloat16* __restrict__ g,
                const __nv_bfloat16* __restrict__ z,
                const float* __restrict__ gamma,
                __nv_bfloat16* __restrict__ dz,
                __nv_bfloat16* __restrict__ dz_drop,
                float* __restrict__ dgamma, float* __restrict__ dbeta,
                float* __restrict__ partial, float* __restrict__ group_sum,
                int* __restrict__ tickets, int R, int group, float eps,
                DropSpec drop) {
  using S = Cols<E>;
  constexpr int V = S::V, GR = S::GROUPS, C = S::C;
  extern __shared__ __align__(16) float smem[];
  float* gamma_s = smem;        // [E]
  float* warp_part = smem + E;  // [WARPS][2][E]
  __shared__ int last_s;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int blocks = (int)gridDim.x, k = (int)blockIdx.x;
  const int r_end = (int)((long long)(k + 1) * R / blocks);
  int r = (int)((long long)k * R / blocks) + warp;

  // this warp's first row in flight, gamma meanwhile
  Raw<V> zr[GR], gr[GR];
  if (r < r_end) {
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      zr[i].load(z + (size_t)r * E + col<E>(i, lane));
      gr[i].load(g + (size_t)r * E + col<E>(i, lane));
    }
  }
  for (int i = threadIdx.x; i < E; i += THREADS) gamma_s[i] = gamma[i];
  __syncthreads();

  float sa[C], sb[C];  // this lane's columns: sum of g * zh, sum of g
#pragma unroll
  for (int j = 0; j < C; ++j) sa[j] = sb[j] = 0.0f;

  for (; r < r_end; r += WARPS) {
    float zh[C], gg[C];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      zr[i].unpack(zh + i * V);
      gr[i].unpack(gg + i * V);
    }
    if (r + WARPS < r_end) {  // the next row loads while this one computes
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        zr[i].load(z + (size_t)(r + WARPS) * E + col<E>(i, lane));
        gr[i].load(g + (size_t)(r + WARPS) * E + col<E>(i, lane));
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) sum += zh[j];
    const float mean = warp_sum(sum) / E;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float d = zh[j] - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / E + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const int c = col<E>(i, lane);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = i * V + e;
        zh[j] = (zh[j] - mean) * inv;
        sa[j] += gg[j] * zh[j];
        sb[j] += gg[j];
        gg[j] *= gamma_s[c + e];
        s1 += gg[j];
        s2 += gg[j] * zh[j];
      }
    }
    const float m1 = warp_sum(s1) / E;
    const float m2 = warp_sum(s2) / E;
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const int c = col<E>(i, lane);
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = i * V + e;
        v[e] = round_bf16(inv * (gg[j] - m1 - zh[j] * m2));
      }
      store_bf16<V>(dz + (size_t)r * E + c, v);
      if (dz_drop != nullptr) {
#pragma unroll
        for (int q4 = 0; q4 < V; q4 += 4) drop4(drop, r, c + q4, v + q4);
        store_bf16<V>(dz_drop + (size_t)r * E + c, v);
      }
    }
  }

  // the block's partial: the warps' sums in warp order
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const int c = col<E>(i, lane);
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const int j = i * V + e;
      *reinterpret_cast<float4*>(warp_part + (warp * 2) * E + c + e) =
          make_float4(sa[j], sa[j + 1], sa[j + 2], sa[j + 3]);
      *reinterpret_cast<float4*>(warp_part + (warp * 2 + 1) * E + c + e) =
          make_float4(sb[j], sb[j + 1], sb[j + 2], sb[j + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x * 4; i < 2 * E; i += THREADS * 4) {
    float4 s = *reinterpret_cast<const float4*>(warp_part + i);
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      add4(s, *reinterpret_cast<const float4*>(warp_part + w * 2 * E + i));
    *reinterpret_cast<float4*>(partial + (size_t)k * 2 * E + i) = s;
  }

  // the last block of the group sums the group's partials in block order
  const int grp = k / group, n_groups = (blocks + group - 1) / group;
  const int first = grp * group, in_group = min(group, blocks - first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(&tickets[1 + grp], 1) == in_group - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  sum_partials<E>(partial + (size_t)first * 2 * E, in_group,
                  group_sum + (size_t)grp * 2 * E, nullptr, nullptr, false);
  // the last group sums the groups' sums in group order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    tickets[1 + grp] = 0;
    last_s = atomicAdd(&tickets[0], 1) == n_groups - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  sum_partials<E>(group_sum, n_groups, nullptr, dgamma, dbeta, true);
  if (threadIdx.x == 0) tickets[0] = 0;
}

template <int E>
int launch(const __nv_bfloat16* g, const __nv_bfloat16* z,
           const float* gamma, __nv_bfloat16* dz, __nv_bfloat16* dz_drop,
           float* dgamma, float* dbeta, float* partial, float* group_sum,
           int* tickets, int R, int blocks, int group, float eps,
           const DropSpec& d, cudaStream_t s) {
  using S = Cols<E>;
  const auto kernel = ln_bwd_one_pass<E>;
  if (S::SMEM > 48 * 1024) {  // the opt-in, once a width
    static const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, THREADS, S::SMEM, s>>>(g, z, gamma, dz, dz_drop, dgamma,
                                          dbeta, partial, group_sum, tickets,
                                          R, group, eps, d);
  return (int)cudaGetLastError();
}

}  // namespace one

// ----------------------------------------------- the three-launch form (yardstick)

namespace three {

constexpr int ROWS = 4;
constexpr int MAX_G = 8;  // groups of 4 columns per lane: E <= 1024
constexpr int SLAB = 256;
constexpr int CX = 32, CY = 8;

__global__ void __launch_bounds__(ROWS * 32)
ln_bwd_rows(const __nv_bfloat16* __restrict__ g,
            const __nv_bfloat16* __restrict__ z,
            const float* __restrict__ gamma, __nv_bfloat16* __restrict__ dz,
            __nv_bfloat16* __restrict__ dz_drop, float* __restrict__ stats,
            int R, int E, float eps, DropSpec drop) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int groups = E / 128;
  const size_t off = (size_t)row * E;
  float zv[MAX_G][4], gg[MAX_G][4];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      load4_bf16(z + off + i * 128 + lane * 4, zv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += zv[i][j];
    }
  }
  const float mean = warp_sum(sum) / E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = zv[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / E + eps);
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      const int c = i * 128 + lane * 4;
      load4_bf16(g + off + c, gg[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zv[i][j] = (zv[i][j] - mean) * inv;  // zh
        gg[i][j] *= gamma[c + j];
        s1 += gg[i][j];
        s2 += gg[i][j] * zv[i][j];
      }
    }
  }
  const float m1 = warp_sum(s1) / E;
  const float m2 = warp_sum(s2) / E;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      const int c = i * 128 + lane * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = round_bf16(inv * (gg[i][j] - m1 - zv[i][j] * m2));
      store4_bf16(dz + off + c, v);
      if (dz_drop != nullptr) {
        drop4(drop, row, c, v);
        store4_bf16(dz_drop + off + c, v);
      }
    }
  }
  if (lane == 0) {
    stats[2 * (size_t)row] = mean;
    stats[2 * (size_t)row + 1] = inv;
  }
}

// partial[(slab, 0, col)] = sum over the slab's rows of g * zh; (slab, 1, col)
// of g.
__global__ void __launch_bounds__(CX * CY)
ln_bwd_cols(const __nv_bfloat16* __restrict__ g,
            const __nv_bfloat16* __restrict__ z,
            const float* __restrict__ stats, float* __restrict__ partial, int R,
            int E) {
  __shared__ float sh[2][CY][CX];
  const int tx = threadIdx.x % CX;
  const int ty = threadIdx.x / CX;
  const int col = blockIdx.x * CX + tx;
  const int r_end = min(R, (int)(blockIdx.y + 1) * SLAB);
  float a = 0.0f, b = 0.0f;
  for (int r = blockIdx.y * SLAB + ty; r < r_end; r += CY) {
    const float gv = __bfloat162float(g[(size_t)r * E + col]);
    const float zh = (__bfloat162float(z[(size_t)r * E + col]) -
                      stats[2 * (size_t)r]) * stats[2 * (size_t)r + 1];
    a += gv * zh;
    b += gv;
  }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  __syncthreads();
  if (ty < 2) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CY; ++i) s += sh[ty][i][tx];
    partial[((size_t)blockIdx.y * 2 + ty) * E + col] = s;
  }
}

__global__ void ln_bwd_final(const float* __restrict__ partial, int slabs,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int E) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * E) return;
  const int which = i / E, col = i % E;
  float s = 0.0f;
  for (int k = 0; k < slabs; ++k) s += partial[((size_t)k * 2 + which) * E + col];
  (which == 0 ? dgamma : dbeta)[col] = s;
}

}  // namespace three

}  // namespace

// The three-launch form (`variant="three_pass"`). g, z: (R, E) bf16; gamma:
// (E,) fp32; dz, dz_drop (or null): (R, E) bf16; dgamma, dbeta: (E,) fp32;
// stats: (R, 2) fp32 scratch; partial: (ceil(R / 256), 2, E) fp32 scratch.
extern "C" int acai_layernorm_bwd(const void* g, const void* z,
                                  const void* gamma, void* dz, void* dz_drop,
                                  void* dgamma, void* dbeta, void* stats,
                                  void* partial, int R, int E, float eps,
                                  unsigned drop_thresh, float drop_scale,
                                  unsigned seed0, unsigned seed1,
                                  unsigned drop_stream, int drop_t,
                                  void* stream) {
  using namespace three;
  if (E % 128 != 0 || E > 128 * MAX_G) return (int)cudaErrorInvalidValue;
  if (dz_drop != nullptr && drop_thresh != 0u && drop_t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d{drop_thresh, drop_scale, seed0, seed1, drop_stream,
                   drop_t > 0 ? drop_t : 1};
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* zp = static_cast<const __nv_bfloat16*>(z);
  ln_bwd_rows<<<(R + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      gp, zp, static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(dz_drop), static_cast<float*>(stats), R, E,
      eps, d);
  const int slabs = (R + SLAB - 1) / SLAB;
  ln_bwd_cols<<<dim3(E / CX, slabs), CX * CY, 0, s>>>(
      gp, zp, static_cast<const float*>(stats), static_cast<float*>(partial), R,
      E);
  ln_bwd_final<<<(2 * E + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), slabs, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), E);
  return (int)cudaGetLastError();
}

// The one-pass kernel: the arguments of acai_layernorm_bwd above without its
// scratch, plus `blocks` and `group` as ops/layernorm_bwd_kernel.py
// `layernorm_bwd_plan` gives them; partial: (blocks, 2, E) fp32 scratch,
// group_sum: (ceil(blocks / group), 2, E) fp32 scratch; tickets: 64 ints
// that are zero (and are zero again when the kernel ends). E % 128 == 0,
// E <= 1024.
extern "C" int acai_layernorm_bwd_one_pass(
    const void* g, const void* z, const void* gamma, void* dz, void* dz_drop,
    void* dgamma, void* dbeta, void* partial, void* group_sum, void* tickets,
    int R, int E, int blocks, int group, float eps, unsigned drop_thresh,
    float drop_scale, unsigned seed0, unsigned seed1, unsigned drop_stream,
    int drop_t, void* stream) {
  if (R < 1 || blocks < 1 || blocks > R || group < 1 ||
      1 + (blocks + group - 1) / group > one::MAX_TICKETS)
    return (int)cudaErrorInvalidValue;
  if (dz_drop != nullptr && drop_thresh != 0u && drop_t <= 0)
    return (int)cudaErrorInvalidValue;
  const DropSpec d{drop_thresh, drop_scale, seed0, seed1, drop_stream,
                   drop_t > 0 ? drop_t : 1};
  using bf = __nv_bfloat16;
#define ACAI_E(EE)                                                           \
  one::launch<EE>(static_cast<const bf*>(g), static_cast<const bf*>(z),      \
                  static_cast<const float*>(gamma), static_cast<bf*>(dz),    \
                  static_cast<bf*>(dz_drop), static_cast<float*>(dgamma),    \
                  static_cast<float*>(dbeta), static_cast<float*>(partial),  \
                  static_cast<float*>(group_sum), static_cast<int*>(tickets), \
                  R, blocks, group, eps, d, static_cast<cudaStream_t>(stream))
  switch (E) {
    case 128: return ACAI_E(128);
    case 256: return ACAI_E(256);
    case 384: return ACAI_E(384);
    case 512: return ACAI_E(512);
    case 640: return ACAI_E(640);
    case 768: return ACAI_E(768);
    case 896: return ACAI_E(896);
    case 1024: return ACAI_E(1024);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_E
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launchers use them; the one-pass kernel at
// each E, the three-launch form's kernels.
#define ACAI_ONE(EE)                                                    \
  AcaiKernelEntry {                                                     \
    "layernorm_bwd|one_pass|ln_bwd_one_pass<" #EE ">",                  \
        reinterpret_cast<const void*>(&one::ln_bwd_one_pass<EE>),       \
        one::THREADS, one::Cols<EE>::SMEM                               \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_ONE(128), ACAI_ONE(256), ACAI_ONE(384), ACAI_ONE(512),
    ACAI_ONE(640), ACAI_ONE(768), ACAI_ONE(896), ACAI_ONE(1024),
    ACAI_KERNEL("layernorm_bwd", "three_pass", three::ln_bwd_rows,
                three::ROWS * 32, 0),
    ACAI_KERNEL("layernorm_bwd", "three_pass", three::ln_bwd_cols,
                three::CX * three::CY, 0),
    ACAI_KERNEL("layernorm_bwd", "three_pass", three::ln_bwd_final, 256, 0),
};
#undef ACAI_ONE
ACAI_EXPORT_RESOURCES(kResources)
