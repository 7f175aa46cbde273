// hd_int8_cluster.cuh: the cluster kernel of the per-op decode step's int8
// attention over lane-major (B x H x Dh, T) planes, shared by K12
// decode_attention_hd_int8 (decode_attention_hd_int8.cu: the cross-attention
// over the memory) and K13 self_attention_append_int8
// (self_attention_append_int8.cu: the self-attention over the cache, with
// the fresh token quantized, folded in analytically and appended).
//
// One cluster per (row, head); the keys split across the cluster's blocks,
// block r owning the r-th of `split` ranges of whole 16-key units, in order
// and none empty (ops/decode_kernel.py `decode_attention_int8_plan`).
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
// * The exchanges go through distributed shared memory in rank order, so
//   two runs give the same bits without atomics: the blocks' logit maxima
//   (the global max); the partial denominators; the PV partials (a warp on
//   every fourth head-dim row, four neighbouring keys a lane, one 4-byte load
//   of int8 values), which rank 0 sums and rounds to bf16 once. Keys at or
//   past n_keys never enter a sum.
// * K12 (FRESH false) follows its twin's order: the denominators meet
//   before PV, the same sum in every block, and each block normalises its
//   weights before they enter the V sum.
// * K13 (FRESH true): every block quantizes the fresh k / v head rows as the
//   twin does (one warp, while the first tiles are in flight) for the fresh
//   logit lc, which enters the max; the weights stay unnormalised, the
//   partial denominators meet with the PV partials at one barrier, and rank
//   0 adds wc = exp(lc - m) last to the denominator, wc * vq * vsc to the
//   V sum, and divides once. Rank 0 writes column `pos` (the quantized k / v
//   and their scales) after the cluster's last barrier, when no block of the
//   cluster can still read a box that holds it; no block reads column `pos`
//   as a key. pos = 0 (no cached key) takes one block a (row, head), an
//   ordinary launch: no cluster, no TMA, no cluster barrier.
// * A split of 1 is an ordinary launch (a cluster of one): on an H100 80GB
//   HBM3 (700 W) the cluster launch of K13's 512 blocks at B = 32 took
//   0.0130 ms against 0.0110 for the same blocks launched without it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>

#include "sm90_cluster.cuh"

namespace hd8 {

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

// the int8-to-float conversions of sm90_cluster.cuh
using sm90::i8_byte;
using sm90::i8_lane;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;               // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int RING_BYTES = 96 * 1024;   // the ring of K / V tiles
constexpr int LOGIT_BYTES = 96 * 1024;  // a block's logits, then weights
constexpr int MAX_CHUNK = LOGIT_BYTES / 4;
constexpr float QMAX = 127.0f;

template <int DH>
struct Form {
  static constexpr int PLANE_BYTES = DH * TILE;  // the int8 box
  static constexpr int TILE_BYTES = PLANE_BYTES + TILE * 4;  // + its scales
  static constexpr int MAX_STAGES = RING_BYTES / TILE_BYTES;
  static constexpr int ROWS = DH / WARPS;  // head-dim rows a warp in PV
  static constexpr int PER = (DH + 31) / 32;  // head dims a lane (fresh)
  static constexpr int SMEM_MAX = 128 + RING_BYTES + LOGIT_BYTES;
  // the kernel's static shared memory (barriers, q, partials, statistics),
  // and K13's fresh token beside it
  static constexpr int STATIC = 8 * MAX_STAGES + 8 * DH + 4 * WARPS + 16;
  static constexpr int FRESH_STATIC = 6 * DH + 16;
  static constexpr int smem(int stages, int chunk) {
    return 128 + stages * TILE_BYTES + chunk * 4;
  }
};

// K13's fresh token: its bf16 k / v head rows, (B, H, Dh), and where its
// quantized column goes: column `pos` of the layer's (B, H, Dh, T) int8
// planes and (B, H, T) fp32 scales. K12 passes none (all null).
struct Fresh {
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  int8_t* kc;
  int8_t* vc;
  float* ksc;
  float* vsc;
  int pos;
};

// The fresh token's shared state in a block.
template <int DH>
struct FreshSmem {
  int8_t kq[DH], vq[DH];  // the quantized k / v
  float vf[DH];           // vq * vsc, the value it adds
  float lc, ks, vs;       // its logit, its two scales
};

// One warp: the fresh k / v head rows of `row` quantized as the twin does
// (s = max(amax, 1e-8) / 127 in fp32, x = clip(rint(x / s), -127, 127),
// division, round half to even), and lc = <q, kq * ks> * scale.
template <int DH>
__device__ __forceinline__ void fresh_token(const __nv_bfloat16* q,
                                            const Fresh& fr, size_t row,
                                            float scale, FreshSmem<DH>& f) {
  constexpr int PER = Form<DH>::PER;
  const int lane = threadIdx.x % 32;
  float kx[PER], vx[PER], qx[PER];
  float ka = 0.0f, va = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int d = lane + 32 * p;
    const bool in = d < DH;
    kx[p] = in ? __bfloat162float(fr.k_new[row * DH + d]) : 0.0f;
    vx[p] = in ? __bfloat162float(fr.v_new[row * DH + d]) : 0.0f;
    qx[p] = in ? __bfloat162float(q[row * DH + d]) : 0.0f;
    ka = fmaxf(ka, fabsf(kx[p]));
    va = fmaxf(va, fabsf(vx[p]));
  }
  const float ks = __fdiv_rn(fmaxf(warp_max(ka), 1e-8f), QMAX);
  const float vs = __fdiv_rn(fmaxf(warp_max(va), 1e-8f), QMAX);
  float lc = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int d = lane + 32 * p;
    if (d < DH) {
      const float kr = fminf(fmaxf(rintf(__fdiv_rn(kx[p], ks)), -QMAX), QMAX);
      const float vr = fminf(fmaxf(rintf(__fdiv_rn(vx[p], vs)), -QMAX), QMAX);
      f.kq[d] = (int8_t)kr;
      f.vq[d] = (int8_t)vr;
      f.vf[d] = __fmul_rn(vr, vs);
      lc = fmaf(qx[p], __fmul_rn(kr, ks), lc);
    }
  }
  lc = warp_sum(lc);
  if (lane == 0) {
    f.lc = __fmul_rn(lc, scale);
    f.ks = ks;
    f.vs = vs;
  }
}

// Column `pos` of (row)'s planes and scales: the quantized fresh k / v.
template <int DH>
__device__ __forceinline__ void write_column(const Fresh& fr, size_t row,
                                             int T, const FreshSmem<DH>& f) {
  for (int d = threadIdx.x; d < DH; d += THREADS) {
    fr.kc[(row * DH + d) * T + fr.pos] = f.kq[d];
    fr.vc[(row * DH + d) * T + fr.pos] = f.vq[d];
  }
  if (threadIdx.x == 0) {
    fr.ksc[row * T + fr.pos] = f.ks;
    fr.vsc[row * T + fr.pos] = f.vs;
  }
}

// Grid (split, H, B), clusters of `split` along x; kT / vT / ks / vs at the
// layer. TMA: the tiles arrive by TMA (T % 16 == 0, the layer's planes and
// scales 16-byte aligned); else the block copies them. FRESH: K13 (n_keys
// == pos; n_keys 0 an ordinary launch of one block a (row, head)), else K12.
template <int DH, bool TMA, bool FRESH>
__device__ __forceinline__ void attend_body(
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* tks,
    const CUtensorMap* tvs, const __nv_bfloat16* __restrict__ q,
    const int8_t* kT, const int8_t* vT, const float* ks, const float* vs,
    const float* __restrict__ bias, int H, int T, int n_keys, int chunk,
    int stages, float scale, __nv_bfloat16* __restrict__ out,
    const Fresh& fr) {
  using F = Form<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::MAX_STAGES];
  __shared__ __align__(16) float q_s[DH];
  __shared__ float acc_s[DH];
  __shared__ float red[WARPS];
  __shared__ float mx_s, den_s, m_s, d_s;
  __shared__ FreshSmem<FRESH ? DH : 1> fresh;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)b * H + h;

  if constexpr (FRESH) {
    if (n_keys == 0) {  // the fresh token alone: out = (wc * vf) / wc
      if (warp == 0) fresh_token<DH>(q, fr, row, scale, fresh);
      __syncthreads();
      const float wc = expf(fresh.lc - fresh.lc);
      for (int d = tid; d < DH; d += THREADS)
        out[row * DH + d] = __float2bfloat16(__fdiv_rn(
            __fadd_rn(0.0f, __fmul_rn(wc, fresh.vf[d])), __fadd_rn(0.0f, wc)));
      write_column<DH>(fr, row, T, fresh);
      return;
    }
  }

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* ring_p = smem_raw + (ring - raw);
  float* logits = reinterpret_cast<float*>(ring_p + stages * F::TILE_BYTES);

  const int rank = sm90::cluster_rank(), split = (int)gridDim.x;
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
    sm90::tma_load(ring + s * F::TILE_BYTES, is_k ? tk : tv, bar, t0,
                   (int)(row * DH));
    sm90::tma_load(ring + s * F::TILE_BYTES + F::PLANE_BYTES,
                   is_k ? tks : tvs, bar, t0, (int)row);
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

  // thread 0 starts the loads first: q and the fresh token meanwhile
  if (TMA && tid == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, loads); ++j) fetch(j);
  }
  for (int d = tid; d < DH; d += THREADS)
    q_s[d] = __bfloat162float(q[row * DH + d]);
  if constexpr (FRESH)
    if (warp == WARPS - 1) fresh_token<DH>(q, fr, row, scale, fresh);
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
    m_s = FRESH ? fmaxf(v, fresh.lc) : v;
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
  if constexpr (!FRESH) {
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
  }

  // PV: a warp on every WARPS-th head-dim row, four keys a lane, the weight
  // times the value scale first
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
  sm90::cluster_sync();  // every block's partial (K13: and denominator)

  // rank 0: the partials in rank order, rounded to bf16 once (K13: the
  // denominators in rank order, then wc, the fresh value, one division)
  if (rank == 0) {
    float dn = 0.0f, wc = 0.0f;
    if constexpr (FRESH) {
      float p[sm90::MAX_CLUSTER];
      sm90::load_peers(&den_s, split, p);
      dn = p[0];
#pragma unroll
      for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
        if (r < split) dn += p[r];
      wc = expf(fresh.lc - m);
      dn = __fadd_rn(dn, wc);
    }
    for (int d = tid; d < DH; d += THREADS) {
      float p[sm90::MAX_CLUSTER];
      sm90::load_peers(&acc_s[d], split, p);
      float o = p[0];
#pragma unroll
      for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
        if (r < split) o += p[r];
      if constexpr (FRESH)
        o = __fdiv_rn(__fadd_rn(o, __fmul_rn(wc, fresh.vf[d])), dn);
      out[row * DH + d] = __float2bfloat16(o);
    }
  }
  sm90::cluster_sync();  // no block leaves while rank 0 reads its partials
  if constexpr (FRESH)
    if (rank == 0) write_column<DH>(fr, row, T, fresh);
}

#define ACAI_HD8_PARAMS                                                      \
  const __grid_constant__ CUtensorMap tk,                                    \
      const __grid_constant__ CUtensorMap tv,                                \
      const __grid_constant__ CUtensorMap tks,                               \
      const __grid_constant__ CUtensorMap tvs,                               \
      const __nv_bfloat16 *__restrict__ q, const int8_t *kT,                 \
      const int8_t *vT, const float *ks, const float *vs,                    \
      const float *__restrict__ bias, int H, int T, int n_keys, int chunk,   \
      int stages, float scale, __nv_bfloat16 *__restrict__ out,              \
      const __grid_constant__ Fresh fr
#define ACAI_HD8_ARGS                                                        \
  &tk, &tv, &tks, &tvs, q, kT, vT, ks, vs, bias, H, T, n_keys, chunk, stages, \
      scale, out, fr

// K12's kernel.
template <int DH, bool TMA>
__global__ void __launch_bounds__(THREADS)
    attend_hd_int8_cluster(ACAI_HD8_PARAMS) {
  attend_body<DH, TMA, false>(ACAI_HD8_ARGS);
}

// K13's kernel (a name of its own: the profiler's rows tell the two apart).
template <int DH, bool TMA>
__global__ void __launch_bounds__(THREADS)
    append_hd_int8_cluster(ACAI_HD8_PARAMS) {
  attend_body<DH, TMA, true>(ACAI_HD8_ARGS);
}

#undef ACAI_HD8_PARAMS
#undef ACAI_HD8_ARGS

template <int DH, bool TMA, bool FRESH>
auto kernel_of() {
  if constexpr (FRESH)
    return append_hd_int8_cluster<DH, TMA>;
  else
    return attend_hd_int8_cluster<DH, TMA>;
}

// kT / vT / ks / vs at the layer; `split` and `chunk` as the plan gives
// them (decode_attention.cu's acai_decode_attention_cluster); split 1 an
// ordinary launch. FRESH with n_keys 0: split 1, no TMA.
template <int DH, bool TMA, bool FRESH>
int launch(const void* q, const int8_t* kT, const int8_t* vT, const float* ks,
           const float* vs, const void* bias, int B, int H, int T,
           int n_keys, float scale, int chunk, int split, void* out,
           const Fresh& fr, cudaStream_t s) {
  using F = Form<DH>;
  using bf = __nv_bfloat16;
  const int units = (n_keys + UNIT - 1) / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > std::max(units, 1) ||
      chunk % UNIT != 0 || chunk > MAX_CHUNK ||
      chunk < (units + split - 1) / split * UNIT || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel = kernel_of<DH, TMA, FRESH>();
  CUtensorMap tk = {}, tv = {}, tks = {}, tvs = {};
  if (FRESH && n_keys == 0) {
    kernel<<<dim3(1, H, B), THREADS, 0, s>>>(
        tk, tv, tks, tvs, static_cast<const bf*>(q), kT, vT, ks, vs,
        static_cast<const float*>(bias), H, T, n_keys, chunk, 0, scale,
        static_cast<bf*>(out), fr);
    return (int)cudaGetLastError();
  }
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
  const int fixed = F::STATIC + (FRESH ? F::FRESH_STATIC : 0);
  const int stages =
      TMA ? sm90::ring_stages((long long)split * H * B,
                              fixed + F::smem(0, chunk), F::TILE_BYTES,
                              F::MAX_STAGES, 2 * ((chunk + TILE - 1) / TILE))
          : 1;
  const int smem = F::smem(stages, chunk);
  // the opt-in past 48 KB, only where a launch needs it (`fixed` is within
  // a few hundred bytes of what the compiler allots)
  if (smem + fixed + 1024 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  if (split == 1) {  // one block a (row, head): an ordinary launch
    kernel<<<dim3(1, H, B), THREADS, smem, s>>>(
        tk, tv, tks, tvs, static_cast<const bf*>(q), kT, vT, ks, vs,
        static_cast<const float*>(bias), H, T, n_keys, chunk, stages, scale,
        static_cast<bf*>(out), fr);
    return (int)cudaGetLastError();
  }
  return sm90::launch_cluster(
      kernel, dim3(split, H, B), THREADS, smem, split, s, tk, tv, tks, tvs,
      static_cast<const bf*>(q), kT, vT, ks, vs,
      static_cast<const float*>(bias), H, T, n_keys, chunk, stages, scale,
      static_cast<bf*>(out), fr);
}

// The layer's planes and scales, the TMA form where T and the pointers
// allow it, at head dim Dh (16, 32, 64 or 128; else cudaErrorInvalidValue).
template <bool FRESH>
int launch_layer(const void* q, const void* kT, const void* vT,
                 const void* ks, const void* vs, const void* bias, int layer,
                 int B, int H, int Dh, int T, int n_keys, float scale,
                 int chunk, int split, void* out, Fresh fr, void* stream) {
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  const int8_t* k8 = static_cast<const int8_t*>(kT) + plane;
  const int8_t* v8 = static_cast<const int8_t*>(vT) + plane;
  const float* ksl = static_cast<const float*>(ks) + splane;
  const float* vsl = static_cast<const float*>(vs) + splane;
  if constexpr (FRESH) {  // the column is written into the same layer
    fr.kc += plane;
    fr.vc += plane;
    fr.ksc += splane;
    fr.vsc += splane;
  }
  const bool tma = T % 16 == 0 && reinterpret_cast<uintptr_t>(k8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ksl) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vsl) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACAI_DH(D)                                                           \
  (tma ? launch<D, true, FRESH>(q, k8, v8, ksl, vsl, bias, B, H, T, n_keys,  \
                                scale, chunk, split, out, fr, s)             \
       : launch<D, false, FRESH>(q, k8, v8, ksl, vsl, bias, B, H, T, n_keys, \
                                 scale, chunk, split, out, fr, s))
  switch (Dh) {
    case 16: return ACAI_DH(16);
    case 32: return ACAI_DH(32);
    case 64: return ACAI_DH(64);
    case 128: return ACAI_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_DH
}

}  // namespace hd8
