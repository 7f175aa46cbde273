// K2 decode_attention: single-token attention of one decode step.
//
// Replaces: the two `_attend_all` sites of ops/pallas_monolith.py `_kernel`
// (bf16 mode) in the JAX package -- the self-attention over the time-major
// KV cache with the fresh token appended in place at `pos` and folded into the
// softmax analytically, and the cross-attention over the precomputed memory
// K/V with its padding-bias column -- and the bf16 branch of `_attend_shared`
// (memory shared by a group of rows).
//
// Self mode (k_new != nullptr): q, the fresh k and the fresh v are the three
// E-wide column blocks of one (B, 3E) qkv row. The kernel writes the fresh
// k/v head slice into the (B, T, E) layer caches at `pos`, attends over cache
// positions [0, pos), and folds the fresh token in:
//   lc = <q, k_new> * scale,  m = max(max_t logit_t, lc),
//   out = (sum_t bf16(exp(logit_t - m)) * v_t + exp(lc - m) * v_new)
//         / (sum_t exp(logit_t - m) + exp(lc - m)).
// The unnormalised weights are rounded to bf16 before the PV product, the
// denominator sums the unrounded fp32 weights and the fresh token's term is
// added in fp32, as the monolith does. The max is global: over every key and
// lc, before any weight is formed.
// Cross mode (k_new == nullptr): attends over all n_keys memory positions with
// the additive fp32 bias (0 valid / -1e9 padding), same rounding. With
// mem_group = G > 1 the memory and its bias hold B / G rows and batch row b
// reads row b / G.
//
// Bound on an H100: the bytes of the cache rows read (2 * n_keys * E * 2 for
// each row of the caches or the memory, once per group) at 3.35 TB/s; a few
// flops per byte (G times more in grouped mode, still far below the FMA
// rate). The decode step runs it at 4-128 rows, where one block per
// (row, head) leaves most SMs idle and a block's loads one row at a time
// keep a few hundred bytes in flight where HBM needs tens of KB.
//
// Design (`acai_decode_attention_cluster`): the keys are split across a
// thread-block cluster. One cluster per (row, head), or per (memory row,
// head, group of up to 8 queries) in grouped mode, so each memory row is read
// once per group; block r of the cluster owns the r-th of `split` ranges of
// whole 16-key units, in order and none empty (ops/decode_kernel.py
// `decode_attention_plan` picks the split: the grid about one block an SM,
// at most a portable cluster of 8).
// * K and V arrive by TMA in boxes of 64 keys x Dh columns of the cache's
//   (rows x T, E) view (heads read in place), unswizzled, through a ring of
//   stages: the loads run K tiles then V tiles, and the ring starts with as
//   many of them in flight as fit (every V load too where the range fits),
//   each slot refilled as soon as the block is done with it.
// * Phase A: two threads a key, each over half of its Dh columns with
//   16-byte loads of eight bf16, rotated so that the eight lanes of a
//   quarter warp hit eight different bank groups; q staged in shared memory;
//   the fp32 logits (+ bias) kept in shared memory with the block's max.
// * The blocks' maxima meet through distributed shared memory: every block
//   reads all ranks and takes the global max (with lc in self mode).
// * Phase B: the weights exp(l - m), their fp32 partial denominator, and
//   the weights rounded to bf16 in place; then the PV partial over the V
//   tiles, a thread on eight head-dim columns of a subset of the keys,
//   summed over the key lanes by shuffles and over the warps in order.
// * Rank 0 sums the ranks' partials and denominators in rank order from
//   distributed shared memory, adds the fresh term, divides and writes bf16.
//   No atomics: two runs give the same bits. Keys at or past n_keys (a box
//   may cover them, stale or unwritten) never enter a sum: every loop is
//   bounded by the key index.
//
// The kernel it replaced (`acai_decode_attention`, kept as the yardstick,
// `variant="simt"`): one block per (row, head), each warp walking its key
// rows one at a time (one Dh-wide load, a five-shuffle sum), logits in
// shared memory, then the same rows again for V; grouped rows each read the
// shared memory themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>

#include "func_attrs.cuh"
#include "sm90_cluster.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the eight bf16 of a 16-byte chunk as floats
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  f[0] = sm90::bf16_lo(v.x);
  f[1] = sm90::bf16_hi(v.x);
  f[2] = sm90::bf16_lo(v.y);
  f[3] = sm90::bf16_hi(v.y);
  f[4] = sm90::bf16_lo(v.z);
  f[5] = sm90::bf16_hi(v.z);
  f[6] = sm90::bf16_lo(v.w);
  f[7] = sm90::bf16_hi(v.w);
}

// ----------------------------------------------------- the cluster kernel

namespace cl {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;                // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int RING_BYTES = 96 * 1024;   // the ring of K / V tiles
constexpr int LOGIT_BYTES = 96 * 1024;  // a block's logits, then weights

// DH: head dim (32 / 64 / 128); GQ: queries a cluster (1, 2, 4, 8).
template <int DH, int GQ>
struct Form {
  static constexpr int NC = DH / 8;        // 16-byte chunks of a key row
  static constexpr int HC = NC / 2;        // a thread's chunks in phase A
  static constexpr int KL = THREADS / NC;  // key lanes of the PV product
  static constexpr int TILE_BYTES = TILE * DH * 2;
  static constexpr int MAX_STAGES = RING_BYTES / TILE_BYTES;
  static constexpr int MAX_CHUNK = LOGIT_BYTES / (4 * GQ);  // keys a block
  static constexpr int SMEM_MAX = 128 + RING_BYTES + LOGIT_BYTES;
  // the kernel's static shared memory (barriers, q, partials, statistics)
  static constexpr int STATIC = 8 * MAX_STAGES + GQ * DH * 2 +
                                (WARPS + 1) * GQ * DH * 4 +
                                (WARPS + 3) * GQ * 4 + 4;
  static constexpr int smem(int stages, int chunk) {
    return 128 + stages * TILE_BYTES + GQ * chunk * 4;
  }
};

// Grid (split, H, B / G * ceil(G / GQ)), clusters of `split` along x. The
// cluster (bm, h, sub) takes queries [sub GQ, sub GQ + GQ) of memory row bm's
// group (those past G are computed on zeros and not written).
template <int DH, int GQ>
__global__ void __launch_bounds__(THREADS)
    attend_cluster(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ q, int q_stride,
                   const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new,
                   __nv_bfloat16* __restrict__ kc,
                   __nv_bfloat16* __restrict__ vc, int T, int E, int n_keys,
                   const float* __restrict__ bias, int pos, int mem_group,
                   int chunk, int stages, float scale,
                   __nv_bfloat16* __restrict__ out) {
  using F = Form<DH, GQ>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::MAX_STAGES];
  __shared__ __align__(16) __nv_bfloat16 q_s[GQ * DH];
  __shared__ __align__(16) float part[WARPS][GQ * DH];
  __shared__ __align__(16) float acc_s[GQ * DH];
  __shared__ float red[WARPS][GQ];
  __shared__ float mx_s[GQ], den_s[GQ], m_s[GQ];
  __shared__ float lc_s;

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  const unsigned char* ring_p = smem_raw + (ring - raw);
  float* logits = reinterpret_cast<float*>(smem_raw + (ring - raw) +
                                           stages * F::TILE_BYTES);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = sm90::cluster_rank(), split = (int)gridDim.x;
  const int h = blockIdx.y;
  const int groups = (mem_group + GQ - 1) / GQ;
  const int bm = blockIdx.z / groups;
  const int g0 = (blockIdx.z % groups) * GQ;  // first query in the group
  // block r's keys [lo, hi): units r U / split .. (r + 1) U / split of the
  // U = ceil(n_keys / UNIT) units, so ranges in order, none empty
  const int units = (n_keys + UNIT - 1) / UNIT;
  const int lo = min(n_keys, (int)((long long)rank * units / split) * UNIT);
  const int hi =
      min(n_keys, (int)((long long)(rank + 1) * units / split) * UNIT);
  const int nk = max(0, hi - lo);
  const int nt = (nk + TILE - 1) / TILE;
  const int loads = 2 * nt;  // K tiles 0 .. nt - 1, then V tiles
  const int row0 = bm * T + lo;
  const bool fresh = k_new != nullptr;

  auto fetch = [&](int j) {
    const int s = j % stages;
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, F::TILE_BYTES);
    const bool is_k = j < nt;
    sm90::tma_load(ring + s * F::TILE_BYTES, is_k ? &tk : &tv, bar, h * DH,
                   row0 + (is_k ? j : j - nt) * TILE);
  };

  // thread 0 starts the loads first: q, lc and the fresh k / v meanwhile
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, loads); ++j) fetch(j);
  }
  for (int i = tid; i < GQ * F::NC; i += THREADS) {
    const int qi = g0 + i / F::NC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qi < mem_group)
      v = *reinterpret_cast<const uint4*>(
          q + (size_t)(bm * mem_group + qi) * q_stride + h * DH +
          (i % F::NC) * 8);
    reinterpret_cast<uint4*>(q_s)[i] = v;
  }
  if (fresh) {  // mem_group is 1: row bm is the batch row
    const size_t src = (size_t)bm * q_stride + h * DH;
    if (warp == 0) {
      float s = 0.0f;
      for (int d = lane; d < DH; d += 32)
        s += __bfloat162float(q[src + d]) * __bfloat162float(k_new[src + d]);
      s = warp_sum(s);
      if (lane == 0) lc_s = s * scale;
    }
    if (rank == 0 && tid < F::NC) {  // the fresh k / v into the caches
      const size_t dst = ((size_t)bm * T + pos) * E + h * DH + tid * 8;
      *reinterpret_cast<uint4*>(kc + dst) =
          *reinterpret_cast<const uint4*>(k_new + src + tid * 8);
      *reinterpret_cast<uint4*>(vc + dst) =
          *reinterpret_cast<const uint4*>(v_new + src + tid * 8);
    }
  }
  __syncthreads();
  const bool refill = stages < loads;  // the ring is refilled as it drains

  // phase A: the logits of the block's keys, two threads a key
  float lmax[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) lmax[g] = -FLT_MAX;
  {
    const int key = tid / 2, half = tid % 2;
    const int rot = (tid % 8) * F::HC / 8;
    const uint4* qv = reinterpret_cast<const uint4*>(q_s);
    for (int i = 0; i < nt; ++i) {
      const int s = i % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / stages) & 1);
      const int t = i * TILE + key;
      float acc[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] = 0.0f;
      if (t < nk) {
        const unsigned char* row = ring_p + s * F::TILE_BYTES + key * DH * 2;
#pragma unroll
        for (int c = 0; c < F::HC; ++c) {
          const int j = half * F::HC + (c + rot) % F::HC;
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(row + j * 16), kf);
#pragma unroll
          for (int g = 0; g < GQ; ++g) {
            float qf[8];
            unpack8(qv[g * F::NC + j], qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g] = fmaf(qf[e], kf[e], acc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] += __shfl_xor_sync(FULL, acc[g], 1);
      if (t < nk && half == 0) {
        const float b =
            bias != nullptr ? bias[(size_t)bm * T + lo + t] : 0.0f;
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float l = acc[g] * scale + b;
          logits[g * chunk + t] = l;
          lmax[g] = fmaxf(lmax[g], l);
        }
      }
      if (refill) {
        __syncthreads();  // the slot is free
        if (tid == 0 && i + stages < loads) fetch(i + stages);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float v = warp_max(lmax[g]);
    if (lane == 0) red[warp][g] = v;
  }
  __syncthreads();
  if (tid < GQ) {
    float v = red[0][tid];
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w][tid]);
    mx_s[tid] = v;
  }
  sm90::cluster_sync();  // every block's max is published
  if (tid < GQ) {
    float v = sm90::load_peer(&mx_s[tid], 0);
    for (int r = 1; r < split; ++r) v = fmaxf(v, sm90::load_peer(&mx_s[tid], r));
    m_s[tid] = fresh ? fmaxf(v, lc_s) : v;
  }
  __syncthreads();

  // phase B: the weights against the global max, rounded to bf16 in place;
  // the denominator from the unrounded ones
  float den[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float m = m_s[g];
    den[g] = 0.0f;
    for (int t = tid; t < nk; t += THREADS) {
      const float w = expf(logits[g * chunk + t] - m);
      den[g] += w;
      logits[g * chunk + t] = __bfloat162float(__float2bfloat16(w));
    }
  }
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float v = warp_sum(den[g]);
    if (lane == 0) red[warp][g] = v;
  }
  __syncthreads();  // also publishes the weights
  if (tid < GQ) {
    float v = red[0][tid];
    for (int w = 1; w < WARPS; ++w) v += red[w][tid];
    den_s[tid] = v;
  }

  // the PV partial: a thread on eight head-dim columns of every KL-th key
  float acc[GQ][8];
#pragma unroll
  for (int g = 0; g < GQ; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  {
    const int c = tid % F::NC, kl = tid / F::NC;
    for (int i = 0; i < nt; ++i) {
      const int j = nt + i, s = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
      const unsigned char* tile = ring_p + s * F::TILE_BYTES;
      const int here = min(TILE, nk - i * TILE);
      for (int k = kl; k < here; k += F::KL) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + k * DH * 2 + c * 16),
                vf);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float w = logits[g * chunk + i * TILE + k];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
        }
      }
      if (refill) {
        __syncthreads();  // the slot is free
        if (tid == 0 && j + stages < loads) fetch(j + stages);
      }
    }
  }
  for (int o = F::NC; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GQ; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
  if (lane < F::NC) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      float4* p = reinterpret_cast<float4*>(&part[warp][g * DH + lane * 8]);
      p[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      p[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  for (int i = tid; i < GQ * DH; i += THREADS) {
    float v = part[0][i];
    for (int w = 1; w < WARPS; ++w) v += part[w][i];
    acc_s[i] = v;
  }
  sm90::cluster_sync();  // every block's partial is published

  // rank 0: the partials in rank order, the fresh term, the division
  if (rank == 0) {
    for (int i = tid; i < GQ * DH; i += THREADS) {
      const int g = i / DH, d = i % DH, qi = g0 + g;
      if (qi >= mem_group) continue;
      float o = sm90::load_peer(&acc_s[i], 0);
      float dn = sm90::load_peer(&den_s[g], 0);
      for (int r = 1; r < split; ++r) {
        o += sm90::load_peer(&acc_s[i], r);
        dn += sm90::load_peer(&den_s[g], r);
      }
      const size_t b = (size_t)bm * mem_group + qi;
      if (fresh) {
        const float wc = expf(lc_s - m_s[g]);
        o += wc * __bfloat162float(v_new[b * q_stride + h * DH + d]);
        dn += wc;
      }
      out[b * E + h * DH + d] = __float2bfloat16(o / dn);
    }
  }
  sm90::cluster_sync();  // no block leaves while rank 0 reads its partials
}

template <int DH, int GQ>
int launch(const void* q, int q_stride, const void* k_new, const void* v_new,
           void* kc, void* vc, int B, int H, int T, int n_keys,
           const void* bias, int pos, int mem_group, float scale, int chunk,
           int split, void* out, cudaStream_t s) {
  using F = Form<DH, GQ>;
  const int E = H * DH, bm = B / mem_group;
  const int units = (n_keys + UNIT - 1) / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > std::max(units, 1) ||
      chunk % UNIT != 0 || chunk > F::MAX_CHUNK ||
      chunk < (units + split - 1) / split * UNIT || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  int rc = sm90::tensor_map_plain(&tk, kc, (long long)bm * T, E, TILE, DH, E);
  if (rc == 0)
    rc = sm90::tensor_map_plain(&tv, vc, (long long)bm * T, E, TILE, DH, E);
  if (rc != 0) return rc;
  const int groups = (mem_group + GQ - 1) / GQ;
  const int stages = sm90::ring_stages(
      (long long)split * H * bm * groups, F::STATIC + F::smem(0, chunk),
      F::TILE_BYTES, F::MAX_STAGES, 2 * ((chunk + TILE - 1) / TILE));
  const auto kernel = attend_cluster<DH, GQ>;
  const int smem = F::smem(stages, chunk);
  // the opt-in past 48 KB, only where a launch needs it (STATIC is within
  // a few hundred bytes of what the compiler allots)
  if (smem + F::STATIC + 1024 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  using bf = __nv_bfloat16;
  return sm90::launch_cluster(
      kernel, dim3(split, H, bm * groups), THREADS,
      smem, split, s, tk, tv, static_cast<const bf*>(q),
      q_stride, static_cast<const bf*>(k_new), static_cast<const bf*>(v_new),
      static_cast<bf*>(kc), static_cast<bf*>(vc), T, E, n_keys,
      static_cast<const float*>(bias), pos, mem_group, chunk, stages, scale,
      static_cast<bf*>(out));
}

template <int DH>
int launch_dh(int gq, const void* q, int q_stride, const void* k_new,
              const void* v_new, void* kc, void* vc, int B, int H, int T,
              int n_keys, const void* bias, int pos, int mem_group,
              float scale, int chunk, int split, void* out, cudaStream_t s) {
#define ACAI_GQ(G)                                                          \
  launch<DH, G>(q, q_stride, k_new, v_new, kc, vc, B, H, T, n_keys, bias,   \
                pos, mem_group, scale, chunk, split, out, s)
  switch (gq) {
    case 1: return ACAI_GQ(1);
    case 2: return ACAI_GQ(2);
    case 4: return ACAI_GQ(4);
    case 8: return ACAI_GQ(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_GQ
}

}  // namespace cl

// ------------------------------------------------ the simt kernel (yardstick)

namespace simt {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int DH>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, int q_stride,
                        const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new,
                        __nv_bfloat16* __restrict__ kc,
                        __nv_bfloat16* __restrict__ vc, int T, int E,
                        int n_keys, const float* __restrict__ bias, int pos,
                        int mem_group, float scale,
                        __nv_bfloat16* __restrict__ out) {
  constexpr int PER = DH / 32;
  extern __shared__ float logits[];
  __shared__ float red[WARPS][DH];
  __shared__ float scratch[WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bm = b / mem_group;  // row of the caches / memory and the bias
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int col = h * DH + lane * PER;

  float qv[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p)
    qv[p] = __bfloat162float(q[(size_t)b * q_stride + col + p]);

  const bool fresh = k_new != nullptr;
  float lc = -FLT_MAX;
  if (fresh) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const __nv_bfloat16 kv = k_new[(size_t)b * q_stride + col + p];
      const __nv_bfloat16 vv = v_new[(size_t)b * q_stride + col + p];
      s += qv[p] * __bfloat162float(kv);
      if (warp == 0) {
        kc[((size_t)b * T + pos) * E + col + p] = kv;
        vc[((size_t)b * T + pos) * E + col + p] = vv;
      }
    }
    lc = warp_sum(s) * scale;
  }

  // logits over the cache / memory rows
  for (int t = warp; t < n_keys; t += WARPS) {
    const __nv_bfloat16* kr = kc + ((size_t)bm * T + t) * E + col;
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) s += qv[p] * __bfloat162float(kr[p]);
    s = warp_sum(s);
    if (lane == 0)
      logits[t] = s * scale + (bias != nullptr ? bias[(size_t)bm * T + t] : 0.0f);
  }
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) mx = fmaxf(mx, logits[t]);
  mx = warp_max(mx);
  if (lane == 0) scratch[warp] = mx;
  __syncthreads();
  mx = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, scratch[w]);
  if (fresh) mx = fmaxf(mx, lc);
  __syncthreads();

  float sum = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float w = expf(logits[t] - mx);
    logits[t] = w;
    sum += w;
  }
  sum = warp_sum(sum);
  if (lane == 0) scratch[warp] = sum;
  __syncthreads();
  float denom = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) denom += scratch[w];
  const float wc = fresh ? expf(lc - mx) : 0.0f;
  denom += wc;

  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.0f;
  for (int t = warp; t < n_keys; t += WARPS) {
    const float w = __bfloat162float(__float2bfloat16(logits[t]));
    const __nv_bfloat16* vr = vc + ((size_t)bm * T + t) * E + col;
#pragma unroll
    for (int p = 0; p < PER; ++p) acc[p] += w * __bfloat162float(vr[p]);
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) red[warp][lane * PER + p] = acc[p];
  __syncthreads();

  if (tid < DH) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][tid];
    if (fresh) {
      const float vfresh =
          __bfloat162float(v_new[(size_t)b * q_stride + h * DH + tid]);
      o += wc * vfresh;
    }
    out[(size_t)b * E + h * DH + tid] = __float2bfloat16(o / denom);
  }
}

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q: (B, q_stride) bf16 with head h's
// query at columns [h*Dh, (h+1)*Dh).
// Self mode: k_new/v_new point at the fresh k/v blocks of the same rows
// (q + E, q + 2E), pos is the cache slot to write and n_keys == pos; bias is
// null, mem_group is 1. Cross mode: k_new == v_new == null, n_keys == T,
// kc/vc (B / mem_group, T, E) and bias (B / mem_group, T) fp32.
// kc/vc: this layer's (B, T, E) caches in self mode. out: (B, E) bf16.
extern "C" int acai_decode_attention(const void* q, int q_stride,
                                     const void* k_new, const void* v_new,
                                     void* kc, void* vc, int B, int H, int dh,
                                     int T, int n_keys, const void* bias,
                                     int pos, int mem_group, float scale,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * dh;
  dim3 grid(H, B);
  const size_t smem = (size_t)(n_keys > 0 ? n_keys : 1) * sizeof(float);
#define ACAI_LAUNCH(D)                                                         \
  simt::decode_attention_kernel<D><<<grid, simt::THREADS, smem, s>>>(      \
      static_cast<const __nv_bfloat16*>(q), q_stride,                          \
      static_cast<const __nv_bfloat16*>(k_new),                                \
      static_cast<const __nv_bfloat16*>(v_new),                                \
      static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), T, E,  \
      n_keys, static_cast<const float*>(bias), pos, mem_group, scale,          \
      static_cast<__nv_bfloat16*>(out))
  switch (dh) {
    case 32: ACAI_LAUNCH(32); break;
    case 64: ACAI_LAUNCH(64); break;
    case 128: ACAI_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_LAUNCH
  return (int)cudaGetLastError();
}

// The cluster kernel: the arguments of acai_decode_attention above, plus
// `split` (blocks a cluster, <= 8 and at most the 16-key units of n_keys;
// n_keys == 0 takes one block) and `chunk`, the keys of its largest range
// (ceil(units / split) units or more: it sizes the logits in shared memory). The queries a cluster is the group rounded up to 1, 2, 4 or 8.
// kc / vc 16-byte aligned (TMA).
extern "C" int acai_decode_attention_cluster(
    const void* q, int q_stride, const void* k_new, const void* v_new,
    void* kc, void* vc, int B, int H, int dh, int T, int n_keys,
    const void* bias, int pos, int mem_group, float scale, int chunk,
    int split, void* out, void* stream) {
  if (mem_group < 1 || B % mem_group != 0 || (k_new != nullptr && mem_group != 1))
    return (int)cudaErrorInvalidValue;
  const int gq = mem_group == 1 ? 1 : mem_group == 2 ? 2 : mem_group <= 4 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACAI_DH(D)                                                             \
  cl::launch_dh<D>(gq, q, q_stride, k_new, v_new, kc, vc, B, H, T, n_keys,     \
                   bias, pos, mem_group, scale, chunk, split, out, s)
  switch (dh) {
    case 32: return ACAI_DH(32);
    case 64: return ACAI_DH(64);
    case 128: return ACAI_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_DH
}

// The resource report (func_attrs.cuh): the cluster kernels, which every
// `split{s}` launch runs, at their largest dynamic shared memory, and the
// simt kernel.
#define ACAI_CL(D, G)                                                       \
  AcaiKernelEntry {                                                         \
    "decode_attention|split|attend_cluster<" #D "," #G ">",                 \
        reinterpret_cast<const void*>(cl::attend_cluster<D, G>),            \
        cl::THREADS, cl::Form<D, G>::SMEM_MAX                               \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(32, 1), ACAI_CL(32, 2), ACAI_CL(32, 4), ACAI_CL(32, 8),
    ACAI_CL(64, 1), ACAI_CL(64, 2), ACAI_CL(64, 4), ACAI_CL(64, 8),
    ACAI_CL(128, 1), ACAI_CL(128, 2), ACAI_CL(128, 4), ACAI_CL(128, 8),
    ACAI_KERNEL("decode_attention", "simt", simt::decode_attention_kernel<64>,
                simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
