// K11 decode_attention_hd: single-query attention of the per-op decode step
// over a lane-major (B, H, Dh, T) cache in the compute dtype.
//
// Replaces: ops/pallas_decode.py `_kernel` (the bf16 branch of
// `decode_attention`, pallas_call at :382) of the JAX package. For each
// (row b, head h):
//   logit_t = (<q, k_t> * scale) + bias_t             q, k, v read as fp32
//   m = max_t logit_t,  w_t = exp(logit_t - m)         unnormalised weights
//   out = (sum_t w_t * v_t) / (sum_t w_t)              divide after the V sum
// and the result is rounded to bf16 once. bias (B, T) fp32 is additive
// (0 valid / -1e9 padding) or absent. Only the first n_keys positions are
// read: the caller passes n_keys = pos + 1 for the self-attention, where every
// later position carries the -1e9 bias and so a weight of exactly 0 in fp32.
//
// Bound on an H100: the bytes of the K and V planes read
// (2 * B * H * Dh * n_keys * 2) at 3.35 TB/s; a few flops per byte. At the
// decode step's 4-32 rows one block per (row, head) leaves SMs idle, and
// 2-byte loads strided by T keep few bytes in flight.
//
// Design (`acai_decode_attention_hd_cluster`), K2's (decode_attention.cu) on
// the transposed planes: the keys of a (row, head) are split across a
// thread-block cluster (ops/decode_kernel.py `decode_attention_plan`), block
// r owning the r-th of `split` ranges of whole 16-key units, in order and
// none empty.
// * K and V arrive by TMA in boxes of Dh rows x 128 keys of the
//   (B x H x Dh, T) view, T the contiguous axis, through a ring of stages
//   (K tiles then V tiles, as many in flight as fit). Where T is not a
//   multiple of 8 the rows are not 16-byte aligned, which TMA needs: the
//   block then copies each tile itself (2-byte loads, neighbouring threads
//   on neighbouring keys) into the same layout.
// * Logits: a thread per key column of the staged tile (neighbouring
//   threads on neighbouring keys: no bank conflict), q in shared memory, Dh a
//   template parameter (16 / 32 / 64 / 128) so the loop unrolls; fp32 logits
//   (+ bias) and the block's max in shared memory.
// * The blocks' maxima meet through distributed shared memory (the global
//   max); each block forms its fp32 weights and partial denominator.
// * PV: a warp on every fourth head-dim row, lanes over the keys (four
//   neighbouring keys a lane, 8-byte loads), summed over the lanes by
//   shuffles.
// * Rank 0 sums the ranks' partials and denominators in rank order from
//   distributed shared memory, divides, rounds to bf16 once. No atomics: two
//   runs give the same bits. Keys at or past n_keys never enter a sum.
//
// The kernel it replaced (`acai_decode_attention_hd`, kept as the yardstick,
// `variant="simt"`): one block per (row, head), a thread per key walking Dh
// with 2-byte loads strided by T, PV one warp per head-dim row, nothing
// staged in shared memory.

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

// ----------------------------------------------------- the cluster kernel

namespace cl {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;               // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int RING_BYTES = 96 * 1024;   // the ring of K / V tiles
constexpr int LOGIT_BYTES = 96 * 1024;  // a block's logits, then weights
constexpr int MAX_CHUNK = LOGIT_BYTES / 4;

template <int DH>
struct Form {
  static constexpr int TILE_BYTES = DH * TILE * 2;
  static constexpr int MAX_STAGES = RING_BYTES / TILE_BYTES;
  static constexpr int ROWS = DH / WARPS;  // head-dim rows a warp in PV
  static constexpr int SMEM_MAX = 128 + RING_BYTES + LOGIT_BYTES;
  // the kernel's static shared memory (barriers, q, partials, statistics)
  static constexpr int STATIC = 8 * MAX_STAGES + 8 * DH + 4 * WARPS + 12;
  static constexpr int smem(int stages, int chunk) {
    return 128 + stages * TILE_BYTES + chunk * 4;
  }
};

// Grid (split, H, B), clusters of `split` along x. TMA: the tiles arrive by
// TMA (T % 8 == 0, planes 16-byte aligned); else the block copies them.
template <int DH, bool TMA>
__global__ void __launch_bounds__(THREADS)
    attend_hd_cluster(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kT,
                      const __nv_bfloat16* __restrict__ vT,
                      const float* __restrict__ bias, int H, int T,
                      int n_keys, int chunk, int stages, float scale,
                      __nv_bfloat16* __restrict__ out) {
  using F = Form<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::MAX_STAGES];
  __shared__ __align__(16) float q_s[DH];
  __shared__ float acc_s[DH];
  __shared__ float red[WARPS];
  __shared__ float mx_s, den_s, m_s;

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* ring_p = smem_raw + (ring - raw);
  float* logits = reinterpret_cast<float*>(ring_p + stages * F::TILE_BYTES);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = sm90::cluster_rank(), split = (int)gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)b * H + h;
  // block r's keys [lo, hi): units r U / split .. (r + 1) U / split of the
  // U = ceil(n_keys / UNIT) units, so ranges in order, none empty
  const int units = (n_keys + UNIT - 1) / UNIT;
  const int lo = min(n_keys, (int)((long long)rank * units / split) * UNIT);
  const int hi =
      min(n_keys, (int)((long long)(rank + 1) * units / split) * UNIT);
  const int nk = max(0, hi - lo);
  const int nt = (nk + TILE - 1) / TILE;
  const int loads = 2 * nt;  // K tiles 0 .. nt - 1, then V tiles

  auto fetch = [&](int j) {
    const int s = j % stages;
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, F::TILE_BYTES);
    const bool is_k = j < nt;
    sm90::tma_load(ring + s * F::TILE_BYTES, is_k ? &tk : &tv, bar,
                   lo + (is_k ? j : j - nt) * TILE, (int)(row * DH));
  };
  // load j's tile, staged: by TMA into its slot, or copied into slot 0
  auto acquire = [&](int j) -> const __nv_bfloat16* {
    if constexpr (TMA) {
      const int s = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
      return reinterpret_cast<const __nv_bfloat16*>(ring_p +
                                                    s * F::TILE_BYTES);
    } else {
      const bool is_k = j < nt;
      const __nv_bfloat16* src = (is_k ? kT : vT) + row * DH * T;
      const int t0 = lo + (is_k ? j : j - nt) * TILE;
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(ring_p);
      for (int i = tid; i < DH * TILE; i += THREADS) {
        const int t = t0 + i % TILE;
        dst[i] = t < T ? src[(size_t)(i / TILE) * T + t]
                       : __float2bfloat16(0.0f);
      }
      __syncthreads();
      return dst;
    }
  };
  // the block is done with load j's tile (a copied tile is always
  // overwritten by the next; a TMA slot only where the ring is refilled)
  const bool refill = !TMA || stages < loads;
  auto release = [&](int j) {
    if (!refill) return;
    __syncthreads();
    if constexpr (TMA)
      if (tid == 0 && j + stages < loads) fetch(j + stages);
  };

  // thread 0 starts the loads first: q meanwhile
  if (TMA && tid == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, loads); ++j) fetch(j);
  }
  for (int d = tid; d < DH; d += THREADS)
    q_s[d] = __bfloat162float(q[row * DH + d]);
  __syncthreads();

  // logits: a thread per key column
  float lmax = -FLT_MAX;
  for (int i = 0; i < nt; ++i) {
    const __nv_bfloat16* tile = acquire(i);
    const int t = i * TILE + tid;
    if (t < nk) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d)
        s = fmaf(q_s[d], __bfloat162float(tile[d * TILE + tid]), s);
      s = s * scale;
      if (bias != nullptr) s = s + bias[(size_t)b * T + lo + t];
      logits[t] = s;
      lmax = fmaxf(lmax, s);
    }
    release(i);
  }
  lmax = warp_max(lmax);
  if (lane == 0) red[warp] = lmax;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w]);
    mx_s = v;
  }
  sm90::cluster_sync();  // every block's max is published
  if (tid == 0) {
    float v = sm90::load_peer(&mx_s, 0);
    for (int r = 1; r < split; ++r) v = fmaxf(v, sm90::load_peer(&mx_s, r));
    m_s = v;
  }
  __syncthreads();

  // the weights against the global max, and their partial sum
  const float m = m_s;
  float den = 0.0f;
  for (int t = tid; t < nk; t += THREADS) {
    const float w = expf(logits[t] - m);
    logits[t] = w;
    den += w;
  }
  den = warp_sum(den);
  if (lane == 0) red[warp] = den;
  __syncthreads();  // also publishes the weights
  if (tid == 0) {
    float v = red[0];
    for (int w = 1; w < WARPS; ++w) v += red[w];
    den_s = v;
  }

  // PV: a warp on every WARPS-th head-dim row, four keys a lane
  float acc[F::ROWS];
#pragma unroll
  for (int r = 0; r < F::ROWS; ++r) acc[r] = 0.0f;
  const int k0 = lane * 4;
  for (int i = 0; i < nt; ++i) {
    const int j = nt + i;
    const __nv_bfloat16* tile = acquire(j);
    const int here = min(TILE, nk - i * TILE);
    if (k0 < here) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(logits + i * TILE + k0);
      float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const bool whole = k0 + 4 <= here;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!whole && k0 + e >= here) w[e] = 0.0f;
#pragma unroll
      for (int r = 0; r < F::ROWS; ++r) {
        const uint2 v2 = *reinterpret_cast<const uint2*>(
            tile + (warp + WARPS * r) * TILE + k0);
        float v[4] = {sm90::bf16_lo(v2.x), sm90::bf16_hi(v2.x),
                      sm90::bf16_lo(v2.y), sm90::bf16_hi(v2.y)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!whole && k0 + e >= here) v[e] = 0.0f;
          acc[r] = fmaf(w[e], v[e], acc[r]);
        }
      }
    }
    release(j);
  }
#pragma unroll
  for (int r = 0; r < F::ROWS; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) acc_s[warp + WARPS * r] = v;
  }
  sm90::cluster_sync();  // every block's partial is published

  // rank 0: the partials in rank order, the division
  if (rank == 0) {
    for (int d = tid; d < DH; d += THREADS) {
      float o = sm90::load_peer(&acc_s[d], 0);
      float dn = sm90::load_peer(&den_s, 0);
      for (int r = 1; r < split; ++r) {
        o += sm90::load_peer(&acc_s[d], r);
        dn += sm90::load_peer(&den_s, r);
      }
      out[row * DH + d] = __float2bfloat16(o / dn);
    }
  }
  sm90::cluster_sync();  // no block leaves while rank 0 reads its partials
}

template <int DH, bool TMA>
int launch(const void* q, const void* kT, const void* vT, const void* bias,
           int B, int H, int T, int n_keys, float scale, int chunk, int split,
           void* out, cudaStream_t s) {
  using F = Form<DH>;
  const int units = (n_keys + UNIT - 1) / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > std::max(units, 1) ||
      chunk % UNIT != 0 || chunk > MAX_CHUNK ||
      chunk < (units + split - 1) / split * UNIT || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk = {}, tv = {};
  if (TMA) {
    const long long rows = (long long)B * H * DH;
    int rc = sm90::tensor_map_plain(&tk, kT, rows, T, DH, TILE, T);
    if (rc == 0) rc = sm90::tensor_map_plain(&tv, vT, rows, T, DH, TILE, T);
    if (rc != 0) return rc;
  }
  const int stages =
      TMA ? sm90::ring_stages((long long)split * H * B,
                              F::STATIC + F::smem(0, chunk), F::TILE_BYTES,
                              F::MAX_STAGES, 2 * ((chunk + TILE - 1) / TILE))
          : 1;
  const auto kernel = attend_hd_cluster<DH, TMA>;
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
      kernel, dim3(split, H, B), THREADS, smem, split, s,
      tk, tv, static_cast<const bf*>(q), static_cast<const bf*>(kT),
      static_cast<const bf*>(vT), static_cast<const float*>(bias), H, T,
      n_keys, chunk, stages, scale, static_cast<bf*>(out));
}

template <int DH>
int launch_dh(bool tma, const void* q, const void* kT, const void* vT,
              const void* bias, int B, int H, int T, int n_keys, float scale,
              int chunk, int split, void* out, cudaStream_t s) {
  return tma ? launch<DH, true>(q, kT, vT, bias, B, H, T, n_keys, scale,
                                chunk, split, out, s)
             : launch<DH, false>(q, kT, vT, bias, B, H, T, n_keys, scale,
                                 chunk, split, out, s);
}

}  // namespace cl

// ------------------------------------------------ the simt kernel (yardstick)

namespace simt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// every thread gets the block's max / sum; `red` is reused after the return
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
decode_attention_hd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kT,
                           const __nv_bfloat16* __restrict__ vT,
                           const float* __restrict__ bias, int H, int Dh,
                           int T, int n_keys, float scale,
                           __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;       // [Dh]
  float* w = smem + Dh;   // [n_keys] logits, then weights
  __shared__ float red[WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t row = (size_t)b * H + h;
  const __nv_bfloat16* kp = kT + row * Dh * T;
  const __nv_bfloat16* vp = vT + row * Dh * T;

  for (int d = tid; d < Dh; d += THREADS) qs[d] = __bfloat162float(q[row * Dh + d]);
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s += qs[d] * __bfloat162float(kp[(size_t)d * T + t]);
    s = s * scale;
    if (bias != nullptr) s = s + bias[(size_t)b * T + t];
    w[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, red);

  float sum = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float e = expf(w[t] - mx);
    w[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its barrier also publishes w

  for (int d = warp; d < Dh; d += WARPS) {
    const __nv_bfloat16* vr = vp + (size_t)d * T;
    float acc = 0.0f;
    for (int t = lane; t < n_keys; t += 32) acc += w[t] * __bfloat162float(vr[t]);
    acc = warp_sum(acc);
    if (lane == 0) out[row * Dh + d] = __float2bfloat16(acc / sum);
  }
}

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q: (B, H, Dh) bf16; kT/vT: (B, H, Dh, T) bf16; bias: (B, T) fp32 or null;
// 1 <= n_keys <= T; out: (B, H, Dh) bf16.
extern "C" int acai_decode_attention_hd(const void* q, const void* kT,
                                        const void* vT, const void* bias,
                                        int B, int H, int Dh, int T,
                                        int n_keys, float scale, void* out,
                                        void* stream) {
  const size_t smem = (size_t)(Dh + n_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simt::decode_attention_hd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  simt::decode_attention_hd_kernel<<<dim3(H, B), simt::THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(vT), static_cast<const float*>(bias),
      H, Dh, T, n_keys, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The cluster kernel: the arguments of acai_decode_attention_hd above (Dh 16,
// 32, 64 or 128), plus `split` and `chunk` as acai_decode_attention_cluster
// takes them (decode_attention.cu).
extern "C" int acai_decode_attention_hd_cluster(
    const void* q, const void* kT, const void* vT, const void* bias, int B,
    int H, int Dh, int T, int n_keys, float scale, int chunk, int split,
    void* out, void* stream) {
  const bool tma = T % 8 == 0 && reinterpret_cast<uintptr_t>(kT) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vT) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACAI_DH(D)                                                           \
  cl::launch_dh<D>(tma, q, kT, vT, bias, B, H, T, n_keys, scale, chunk,      \
                   split, out, s)
  switch (Dh) {
    case 16: return ACAI_DH(16);
    case 32: return ACAI_DH(32);
    case 64: return ACAI_DH(64);
    case 128: return ACAI_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_DH
}

// The resource report (func_attrs.cuh): the cluster kernels, which every
// `split{s}` launch runs (`copy`: the tiles copied by the block), at their
// largest dynamic shared memory, and the simt kernel.
#define ACAI_CL(D, TMA, NAME)                                               \
  AcaiKernelEntry {                                                         \
    "decode_attention_hd|split|attend_hd_cluster<" #D "," NAME ">",         \
        reinterpret_cast<const void*>(cl::attend_hd_cluster<D, TMA>),       \
        cl::THREADS, cl::Form<D>::SMEM_MAX                                  \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(16, true, "tma"),   ACAI_CL(32, true, "tma"),
    ACAI_CL(64, true, "tma"),   ACAI_CL(128, true, "tma"),
    ACAI_CL(16, false, "copy"), ACAI_CL(32, false, "copy"),
    ACAI_CL(64, false, "copy"), ACAI_CL(128, false, "copy"),
    ACAI_KERNEL("decode_attention_hd", "simt",
                simt::decode_attention_hd_kernel, simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
