// K12 decode_attention_hd_int8: single-query attention of the per-op decode
// step over an int8 lane-major cache, per layer or reading one layer of a
// stacked cache.
//
// Replaces: ops/pallas_decode.py `_kernel_int8` (the int8 branch of
// `decode_attention`, pallas_call at :374) and `_kernel_int8_stacked`
// (`decode_attention_stacked`, pallas_call at :329) of the JAX package: one
// kernel, the stacked form selected by a layer index. For each (row b, head h)
// of layer l, with kT/vT int8 (Dh, T) planes and fp32 scales ks/vs (T,):
//   logit_t = ((<q, k_t> * scale) * ks_t) + bias_t    q in fp32, k as integers
//   p_t = exp(logit_t - m) / sum_t exp(logit_t - m)    normalised in fp32
//   out = sum_t (p_t * vs_t) * v_t
// Nothing is rounded to bf16 before the output. bias (B, T) fp32 or absent
// (zeros). Only the first n_keys positions are read (masked weights are
// exactly 0 in fp32).
//
// Bound on an H100: the int8 K and V bytes read (2 * B * H * Dh * n_keys)
// plus their fp32 scales (2 * 4 * B * H * n_keys) at 3.35 TB/s. At the
// per-op step's 4-32 rows one block per (row, head) leaves SMs idle, and
// 1-byte loads strided by T keep few bytes in flight.
//
// Design (`acai_decode_attention_hd_int8_cluster`), K11's
// (decode_attention_hd.cu) on int8 planes: the keys of a (row, head) are
// split across a thread-block cluster (ops/decode_kernel.py
// `decode_attention_int8_plan`), block r owning the r-th of `split` ranges
// of whole 16-key units, in order and none empty.
// * K and V arrive by TMA in boxes of Dh rows x 128 keys of the
//   (B x H x Dh, T) int8 view of the layer (a row is 128 bytes), each with
//   the box of its 128 fp32 scales from the (B x H, T) view (contiguous along
//   T), on one barrier, through a ring of stages (K tiles then V tiles, as
//   many in flight as fit). Where T is not a multiple of 16 the int8 rows
//   are not 16-byte aligned, which TMA needs: the block then copies each
//   tile itself into the same layout.
// * Logits: a thread per key column of the staged tile (neighbouring
//   threads on neighbouring bytes: no bank conflict), q in shared memory as
//   fp32, Dh a template parameter (16 / 32 / 64 / 128) so the loop unrolls.
//   Each int8 value becomes a float by one logic operation and one
//   subtraction (`i8_float`), not the integer conversion, which runs at a
//   quarter of the fp32 rate.
// * The exchanges keep the twin's order of operations: the blocks' logit
//   maxima meet through distributed shared memory (the global max); each
//   block forms exp(logit - max) and its partial denominator; the
//   denominators are summed in rank order, the same sum in every block,
//   before any block divides its weights by it; then p_t * vs_t enters the
//   PV partials (a warp on every fourth head-dim row, four neighbouring keys
//   a lane, one 4-byte load of int8 values); rank 0 sums the partials in
//   rank order and rounds to bf16 once. No atomics: two runs give the same
//   bits. Keys at or past n_keys never enter a sum.
//
// The kernel it replaced (`acai_decode_attention_hd_int8`, kept as the
// yardstick, `variant="simt"`): one block of 256 threads per (row, head), a
// thread per key walking Dh with 1-byte loads strided by T, every logit of
// the row in shared memory, PV one warp per head-dim row on 1-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>

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

// An int8 value as a float, exactly, without the quarter-rate integer
// conversion: the float 2^23 + (b + 128), whose low mantissa byte is the
// byte with its sign bit flipped, less 2^23 + 128. `u`: the byte as stored;
// `flipped`: a word of four int8 values with their sign bits flipped
// (w ^ 0x80808080), j picking the byte.
__device__ __forceinline__ float i8_float(uint32_t biased) {
  return __uint_as_float(biased) - 8388736.0f;
}
__device__ __forceinline__ float i8_byte(uint8_t u) {
  return i8_float(0x4B000000u | ((uint32_t)u ^ 0x80u));
}
__device__ __forceinline__ float i8_lane(uint32_t flipped, int j) {
  return i8_float(__byte_perm(flipped, 0x4B000000u, 0x7540 | j));
}

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;               // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int RING_BYTES = 96 * 1024;   // the ring of K / V tiles
constexpr int LOGIT_BYTES = 96 * 1024;  // a block's logits, then weights
constexpr int MAX_CHUNK = LOGIT_BYTES / 4;

template <int DH>
struct Form {
  static constexpr int PLANE_BYTES = DH * TILE;  // the int8 box
  static constexpr int TILE_BYTES = PLANE_BYTES + TILE * 4;  // + its scales
  static constexpr int MAX_STAGES = RING_BYTES / TILE_BYTES;
  static constexpr int ROWS = DH / WARPS;  // head-dim rows a warp in PV
  static constexpr int SMEM_MAX = 128 + RING_BYTES + LOGIT_BYTES;
  // the kernel's static shared memory (barriers, q, partials, statistics)
  static constexpr int STATIC = 8 * MAX_STAGES + 8 * DH + 4 * WARPS + 16;
  static constexpr int smem(int stages, int chunk) {
    return 128 + stages * TILE_BYTES + chunk * 4;
  }
};

// Grid (split, H, B), clusters of `split` along x; kT / vT / ks / vs at the
// layer. TMA: the tiles arrive by TMA (T % 16 == 0, the layer's planes and
// scales 16-byte aligned); else the block copies them.
template <int DH, bool TMA>
__global__ void __launch_bounds__(THREADS)
    attend_hd_int8_cluster(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tks,
                           const __grid_constant__ CUtensorMap tvs,
                           const __nv_bfloat16* __restrict__ q,
                           const int8_t* __restrict__ kT,
                           const int8_t* __restrict__ vT,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const float* __restrict__ bias, int H, int T,
                           int n_keys, int chunk, int stages, float scale,
                           __nv_bfloat16* __restrict__ out) {
  using F = Form<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::MAX_STAGES];
  __shared__ __align__(16) float q_s[DH];
  __shared__ float acc_s[DH];
  __shared__ float red[WARPS];
  __shared__ float mx_s, den_s, m_s, d_s;

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
    const int t0 = lo + (is_k ? j : j - nt) * TILE;
    sm90::tma_load(ring + s * F::TILE_BYTES, is_k ? &tk : &tv, bar, t0,
                   (int)(row * DH));
    sm90::tma_load(ring + s * F::TILE_BYTES + F::PLANE_BYTES,
                   is_k ? &tks : &tvs, bar, t0, (int)row);
  };
  // load j's tile (the int8 plane, then its fp32 scales), staged: by TMA
  // into its slot, or copied into slot 0
  auto acquire = [&](int j) -> const unsigned char* {
    if constexpr (TMA) {
      const int s = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
      return ring_p + s * F::TILE_BYTES;
    } else {
      const bool is_k = j < nt;
      const int8_t* src = (is_k ? kT : vT) + row * DH * T;
      const float* sc = (is_k ? ks : vs) + row * T;
      const int t0 = lo + (is_k ? j : j - nt) * TILE;
      int8_t* dst = reinterpret_cast<int8_t*>(ring_p);
      for (int i = tid; i < DH * TILE; i += THREADS) {
        const int t = t0 + i % TILE;
        dst[i] = t < T ? src[(size_t)(i / TILE) * T + t] : (int8_t)0;
      }
      float* dsc = reinterpret_cast<float*>(ring_p + F::PLANE_BYTES);
      for (int i = tid; i < TILE; i += THREADS)
        dsc[i] = t0 + i < T ? sc[t0 + i] : 0.0f;
      __syncthreads();
      return ring_p;
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

  // logits: a thread per key column, ((<q, k> * scale) * ks) + bias
  float lmax = -FLT_MAX;
  for (int i = 0; i < nt; ++i) {
    const unsigned char* tile = acquire(i);
    const int t = i * TILE + tid;
    if (t < nk) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d)
        s = fmaf(q_s[d], i8_byte(tile[d * TILE + tid]), s);
      const float* sc = reinterpret_cast<const float*>(tile + F::PLANE_BYTES);
      s = __fmul_rn(__fmul_rn(s, scale), sc[tid]);
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
    float p[sm90::MAX_CLUSTER];
    sm90::load_peers(&mx_s, split, p);
    float v = p[0];
#pragma unroll
    for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
      if (r < split) v = fmaxf(v, p[r]);
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
  sm90::cluster_sync();  // every block's denominator is published
  if (tid == 0) {  // in rank order: the same sum in every block
    float p[sm90::MAX_CLUSTER];
    sm90::load_peers(&den_s, split, p);
    float v = p[0];
#pragma unroll
    for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
      if (r < split) v += p[r];
    d_s = v;
  }
  __syncthreads();
  // the normalised weights, a thread a key
  const float dsum = d_s;
  for (int t = tid; t < nk; t += THREADS) logits[t] = logits[t] / dsum;
  __syncthreads();

  // PV: a warp on every WARPS-th head-dim row, four keys a lane, the
  // normalised weight times the value scale first
  float acc[F::ROWS];
#pragma unroll
  for (int r = 0; r < F::ROWS; ++r) acc[r] = 0.0f;
  const int k0 = lane * 4;
  for (int i = 0; i < nt; ++i) {
    const int j = nt + i;
    const unsigned char* tile = acquire(j);
    const int here = min(TILE, nk - i * TILE);
    if (k0 < here) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(logits + i * TILE + k0);
      const float4 s4 =
          *reinterpret_cast<const float4*>(tile + F::PLANE_BYTES + 4 * k0);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = k0 + e < here ? __fmul_rn(w[e], sv[e]) : 0.0f;
#pragma unroll
      for (int r = 0; r < F::ROWS; ++r) {
        const uint32_t v4 = *reinterpret_cast<const uint32_t*>(
                                tile + (warp + WARPS * r) * TILE + k0) ^
                            0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[r] = fmaf(p[e], i8_lane(v4, e), acc[r]);
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

  // rank 0: the partials in rank order, rounded to bf16 once
  if (rank == 0) {
    for (int d = tid; d < DH; d += THREADS) {
      float p[sm90::MAX_CLUSTER];
      sm90::load_peers(&acc_s[d], split, p);
      float o = p[0];
#pragma unroll
      for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
        if (r < split) o += p[r];
      out[row * DH + d] = __float2bfloat16(o);
    }
  }
  sm90::cluster_sync();  // no block leaves while rank 0 reads its partials
}

template <int DH, bool TMA>
int launch(const void* q, const int8_t* kT, const int8_t* vT, const float* ks,
           const float* vs, const void* bias, int B, int H, int T,
           int n_keys, float scale, int chunk, int split, void* out,
           cudaStream_t s) {
  using F = Form<DH>;
  const int units = (n_keys + UNIT - 1) / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > std::max(units, 1) ||
      chunk % UNIT != 0 || chunk > MAX_CHUNK ||
      chunk < (units + split - 1) / split * UNIT || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk = {}, tv = {}, tks = {}, tvs = {};
  if (TMA) {
    const long long rows = (long long)B * H;
    int rc = sm90::encode_map(&tk, kT, rows * DH, T, T, DH, TILE,
                              CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
    if (rc == 0)
      rc = sm90::encode_map(&tv, vT, rows * DH, T, T, DH, TILE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
    if (rc == 0)
      rc = sm90::encode_map(&tks, ks, rows, T, T, 1, TILE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
    if (rc == 0)
      rc = sm90::encode_map(&tvs, vs, rows, T, T, 1, TILE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
    if (rc != 0) return rc;
  }
  const int stages =
      TMA ? sm90::ring_stages((long long)split * H * B,
                              F::STATIC + F::smem(0, chunk), F::TILE_BYTES,
                              F::MAX_STAGES, 2 * ((chunk + TILE - 1) / TILE))
          : 1;
  const auto kernel = attend_hd_int8_cluster<DH, TMA>;
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
      kernel, dim3(split, H, B), THREADS, smem, split, s, tk, tv, tks, tvs,
      static_cast<const bf*>(q), kT, vT, ks, vs,
      static_cast<const float*>(bias), H, T, n_keys, chunk, stages, scale,
      static_cast<bf*>(out));
}

template <int DH>
int launch_dh(bool tma, const void* q, const int8_t* kT, const int8_t* vT,
              const float* ks, const float* vs, const void* bias, int B,
              int H, int T, int n_keys, float scale, int chunk, int split,
              void* out, cudaStream_t s) {
  return tma ? launch<DH, true>(q, kT, vT, ks, vs, bias, B, H, T, n_keys,
                                scale, chunk, split, out, s)
             : launch<DH, false>(q, kT, vT, ks, vs, bias, B, H, T, n_keys,
                                 scale, chunk, split, out, s);
}

}  // namespace cl

// ------------------------------------------------ the simt kernel (yardstick)

namespace simt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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
decode_attention_hd_int8_kernel(const __nv_bfloat16* __restrict__ q,
                                const int8_t* __restrict__ kT,
                                const int8_t* __restrict__ vT,
                                const float* __restrict__ ks,
                                const float* __restrict__ vs,
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
  const size_t row = (size_t)b * H + h;  // kT, vT, ks, vs already at layer l
  const int8_t* kp = kT + row * Dh * T;
  const int8_t* vp = vT + row * Dh * T;
  const float* ksr = ks + row * T;
  const float* vsr = vs + row * T;

  for (int d = tid; d < Dh; d += THREADS) qs[d] = __bfloat162float(q[row * Dh + d]);
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s += qs[d] * (float)kp[(size_t)d * T + t];
    s = (s * scale) * ksr[t];
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
  sum = block_sum(sum, red);
  for (int t = tid; t < n_keys; t += THREADS) w[t] = (w[t] / sum) * vsr[t];
  __syncthreads();

  for (int d = warp; d < Dh; d += WARPS) {
    const int8_t* vr = vp + (size_t)d * T;
    float acc = 0.0f;
    for (int t = lane; t < n_keys; t += 32) acc += w[t] * (float)vr[t];
    acc = warp_sum(acc);
    if (lane == 0) out[row * Dh + d] = __float2bfloat16(acc);
  }
}

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q: (B, H, Dh) bf16; kT/vT:
// (L, B, H, Dh, T) int8 (L = 1 for a per-layer call) and layer in [0, L);
// ks/vs: (L, B, H, T) fp32; bias: (B, T) fp32 or null; 1 <= n_keys <= T;
// out: (B, H, Dh) bf16.
extern "C" int acai_decode_attention_hd_int8(const void* q, const void* kT,
                                             const void* vT, const void* ks,
                                             const void* vs, const void* bias,
                                             int layer, int B, int H, int Dh,
                                             int T, int n_keys, float scale,
                                             void* out, void* stream) {
  const size_t smem = (size_t)(Dh + n_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simt::decode_attention_hd_int8_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  simt::decode_attention_hd_int8_kernel<<<dim3(H, B), simt::THREADS, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(kT) + plane,
      static_cast<const int8_t*>(vT) + plane,
      static_cast<const float*>(ks) + splane,
      static_cast<const float*>(vs) + splane, static_cast<const float*>(bias),
      H, Dh, T, n_keys, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The cluster kernel: the arguments of acai_decode_attention_hd_int8 above
// (Dh 16, 32, 64 or 128), plus `split` and `chunk` as
// acai_decode_attention_cluster takes them (decode_attention.cu).
extern "C" int acai_decode_attention_hd_int8_cluster(
    const void* q, const void* kT, const void* vT, const void* ks,
    const void* vs, const void* bias, int layer, int B, int H, int Dh, int T,
    int n_keys, float scale, int chunk, int split, void* out, void* stream) {
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  const int8_t* k8 = static_cast<const int8_t*>(kT) + plane;
  const int8_t* v8 = static_cast<const int8_t*>(vT) + plane;
  const float* ksl = static_cast<const float*>(ks) + splane;
  const float* vsl = static_cast<const float*>(vs) + splane;
  const bool tma = T % 16 == 0 && reinterpret_cast<uintptr_t>(k8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ksl) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vsl) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACAI_DH(D)                                                          \
  cl::launch_dh<D>(tma, q, k8, v8, ksl, vsl, bias, B, H, T, n_keys, scale,  \
                   chunk, split, out, s)
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
#define ACAI_CL(D, TMA, NAME)                                                \
  AcaiKernelEntry {                                                          \
    "decode_attention_hd_int8|split|attend_hd_int8_cluster<" #D "," NAME ">", \
        reinterpret_cast<const void*>(&cl::attend_hd_int8_cluster<D, TMA>),   \
        cl::THREADS, cl::Form<D>::SMEM_MAX                                   \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(16, true, "tma"),   ACAI_CL(32, true, "tma"),
    ACAI_CL(64, true, "tma"),   ACAI_CL(128, true, "tma"),
    ACAI_CL(16, false, "copy"), ACAI_CL(32, false, "copy"),
    ACAI_CL(64, false, "copy"), ACAI_CL(128, false, "copy"),
    ACAI_KERNEL("decode_attention_hd_int8", "simt",
                simt::decode_attention_hd_int8_kernel, simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
