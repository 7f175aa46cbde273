// K6 decode_attention_int8: single-token attention of one decode step over
// int8 KV caches, with the fresh token's quantized append.
//
// Replaces, in ops/pallas_monolith.py of the JAX package: `_quant_rows` (the
// per-head max-abs quantizer), the int8 branches of `_attend_all` and
// `_attend_shared`, and the quantized cache append of `_kernel`.
//
// Quantizer (per row and head): s = bf16(max(amax, 1e-8) / 127),
// xq = clip(rint(x / s), -127, 127): the scale is rounded to bf16 BEFORE
// quantizing, division not reciprocal, round half to even.
//
// Self mode (pos >= 0): q, k, v are the three E-wide column blocks of one
// (B, 3E) bf16 qkv row and are each quantized per head. The int8 k/v head
// slices go into the (B, T, E) int8 caches at `pos` and their scales into the
// (B, T, H) bf16 scale tensors; attention runs over cache positions [0, pos)
// plus the fresh token:
//   logit_t = (float(<qq, kq_t>) * ks_t) * (qs * scale)       cached keys
//   lc      = sum((qq*qs) * (kq*ks)) * scale                  fresh token
//   m = max(max_t logit_t, lc),  w_t = exp(logit_t - m),  wc = exp(lc - m)
//   wv_t = w_t * vs_t,  ws = max(max_t wv_t, 1e-30) / 127,  wq_t = rint(wv_t / ws)
//   out = (float(sum_t wq_t * vq_t) * ws + wc * (vq*vs)) / (sum_t w_t + wc).
// The softmax weights are quantized, not rounded to bf16; both integer
// products are exact. Cross mode (pos < 0): q (B, E) is quantized per head and
// attends over all n_keys memory rows with the additive fp32 bias; no fresh
// token. With mem_group = G > 1 the memory, its scales and its bias hold B / G
// rows and batch row b reads row b / G.
//
// Bound on an H100: the int8 K/V bytes of the keys read (2 * n_keys * E a
// memory row, once per group) plus their bf16 scales, at 3.35 TB/s; a few
// integer operations a byte (G times more in grouped mode, far below the
// card's rate). The decode step runs it at 4-128 rows, where one block per
// (row, head) leaves SMs idle and keeps a few KB in flight an SM.
//
// Design (`acai_decode_attention_int8_cluster`, K2's cluster design on int8
// rows): the keys are split across a thread-block cluster. One cluster per
// (row, head), or per (memory row, head, group of up to 8 queries) in grouped
// mode, so each memory row is read once per group; block r of the cluster
// owns the r-th of `split` ranges of whole 16-key units, in order and none
// empty (ops/decode_kernel.py `decode_attention_int8_plan` picks the split).
// * Every block quantizes its queries itself (the same bits in every block);
//   in self mode it also quantizes the fresh k / v for lc and the fresh
//   value, and rank 0 appends them.
// * K and V arrive by TMA in boxes of 64 keys x Dh bytes of the cache's
//   (rows x T, E) int8 view (heads read in place), unswizzled, through a ring
//   of stages that starts with every load in flight that fits; the bf16
//   scales (strided by H: no legal TMA box) are read with ordinary loads
//   into shared memory meanwhile.
// * Phase A: two threads a key, each on half of its Dh bytes as 16-byte
//   chunks rotated across bank groups, `__dp4a` against the int8 queries in
//   shared memory; the fp32 logits (+ bias) stay in shared memory.
// * The exchanges keep the twin's arithmetic: the global logit max through
//   distributed shared memory (with lc in self mode); then the weights
//   w = exp(l - m), their fp32 partial denominator and w * vs, whose global
//   max (a second cluster-wide exchange) sets the weights' scale ws before
//   any integer weight rint(w * vs / ws) is formed; the integer weights are
//   kept as int8 (0..127).
// * Phase B: a thread on one 32-bit word column (4 head dims) of four keys at
//   a time: the four V words are transposed with byte permutes into four
//   words of one dim each, and `__dp4a` multiplies each with the four keys'
//   packed integer weights. The exact int32 partials are summed over the key
//   lanes by shuffles, over the warps in shared memory, over the ranks from
//   distributed shared memory; the fp32 denominators in rank order. Every
//   block writes a share of the outputs. No float atomics: two runs give the
//   same bits. Keys at or past n_keys (a box may cover them) never enter a
//   sum: every loop is bounded by the key index.
//
// The kernel it replaced (`acai_decode_attention_int8`, kept as the
// yardstick, `variant="simt"`): one block of four warps per (row, head), each
// warp pass reading 8 key rows of one 4-byte word a lane, K then the same
// rows again for V, logits in shared memory; grouped rows each read the
// shared memory themselves.

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

// Max-abs int8 quantization of one head slice held by one warp, element
// d = lane + 32 * p in xq[p]. Returns the bf16-rounded scale.
template <int PER>
__device__ __forceinline__ float quantize_head(const __nv_bfloat16* x, int lane,
                                               float (&xq)[PER]) {
  float v[PER];
  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    v[p] = __bfloat162float(x[lane + 32 * p]);
    amax = fmaxf(amax, fabsf(v[p]));
  }
  amax = warp_max(amax);
  const float s = __bfloat162float(
      __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)));
#pragma unroll
  for (int p = 0; p < PER; ++p)
    xq[p] = fminf(fmaxf(rintf(__fdiv_rn(v[p], s)), -127.0f), 127.0f);
  return s;
}

// ----------------------------------------------------- the cluster kernel

namespace cl {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;                // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int RING_BYTES = 64 * 1024;   // the ring of K / V tiles
constexpr int KEY_BUDGET = 96 * 1024;   // a block's per-key shared memory

// DH: head dim (32 / 64 / 128); GQ: queries a cluster (1, 2, 4, 8).
template <int DH, int GQ>
struct Form {
  static constexpr int PER = DH / 32;      // elements a lane in the quantizer
  static constexpr int NC = DH / 16;       // 16-byte chunks of a key row
  static constexpr int HC = NC / 2;        // a thread's chunks in phase A
  static constexpr int NW = DH / 4;        // 32-bit words of a key row
  static constexpr int KQL = THREADS / NW; // key-quad lanes of phase B
  static constexpr int TILE_BYTES = TILE * DH;
  static constexpr int MAX_STAGES = std::min(32, RING_BYTES / TILE_BYTES);
  // a key of the block's range: GQ fp32 logits (then w * vs), GQ int8
  // weights, its bf16 k and v scales
  static constexpr int KEY_BYTES = 5 * GQ + 4;
  static constexpr int MAX_CHUNK = KEY_BUDGET / KEY_BYTES / UNIT * UNIT;
  static constexpr int SMEM_MAX = 128 + RING_BYTES + KEY_BUDGET;
  // the kernel's static shared memory (barriers, queries, partials,
  // statistics, the fresh value)
  static constexpr int STATIC = 8 * MAX_STAGES + GQ * DH + (WARPS + 1) * GQ * DH * 4 +
                                DH * 4 + (WARPS + 8) * GQ * 4 + 16;
  static constexpr int smem(int stages, int chunk) {
    return 128 + stages * TILE_BYTES + chunk * KEY_BYTES;
  }
};

// Grid (split, H, B / G * ceil(G / GQ)), clusters of `split` along x. The
// cluster (bm, h, sub) takes queries [sub GQ, sub GQ + GQ) of memory row bm's
// group (those past G are computed on zeros and not written).
template <int DH, int GQ>
__global__ void __launch_bounds__(THREADS)
    attend_int8_cluster(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __nv_bfloat16* __restrict__ q, int q_stride,
                        int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                        __nv_bfloat16* __restrict__ ksc,
                        __nv_bfloat16* __restrict__ vsc, int T, int E, int H,
                        int n_keys, const float* __restrict__ bias, int pos,
                        int mem_group, int chunk, int stages, float scale,
                        __nv_bfloat16* __restrict__ out) {
  using F = Form<DH, GQ>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::MAX_STAGES];
  __shared__ __align__(16) int8_t q8[GQ * DH];
  __shared__ __align__(16) int part[WARPS][GQ * DH];
  __shared__ __align__(16) int acc_s[GQ * DH];
  __shared__ float v_fresh[DH];
  __shared__ float red[WARPS][GQ], red2[WARPS][GQ];
  __shared__ float qs_s[GQ], mx_s[GQ], m_s[GQ], wvmax_s[GQ], den_s[GQ],
      ws_s[GQ];
  __shared__ float lc_s;

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* base = smem_raw + (ring - raw);
  float* logit = reinterpret_cast<float*>(base + stages * F::TILE_BYTES);
  __nv_bfloat16* ks_s = reinterpret_cast<__nv_bfloat16*>(logit + GQ * chunk);
  __nv_bfloat16* vs_s = ks_s + chunk;
  int8_t* wq_s = reinterpret_cast<int8_t*>(vs_s + chunk);

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
  const size_t row0 = (size_t)bm * T + lo;
  const bool fresh = pos >= 0;
  const int head = h * DH;

  auto fetch = [&](int j) {
    const int s = j % stages;
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, F::TILE_BYTES);
    const bool is_k = j < nt;
    sm90::tma_load(ring + s * F::TILE_BYTES, is_k ? &tk : &tv, bar, head,
                   (int)row0 + (is_k ? j : j - nt) * TILE);
  };

  // thread 0 starts the loads first: scales, queries, the fresh token
  // meanwhile
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, loads); ++j) fetch(j);
  }
  for (int i = tid; i < nk; i += THREADS) {
    ks_s[i] = ksc[(row0 + i) * H + h];
    vs_s[i] = vsc[(row0 + i) * H + h];
  }
  for (int g = warp; g < GQ; g += WARPS) {  // a warp quantizes a query
    const int qi = g0 + g;
    float qq[F::PER];
    float qs = 1.0f;
    if (qi < mem_group) {
      qs = quantize_head<F::PER>(
          q + (size_t)(bm * mem_group + qi) * q_stride + head, lane, qq);
    } else {
#pragma unroll
      for (int p = 0; p < F::PER; ++p) qq[p] = 0.0f;
    }
#pragma unroll
    for (int p = 0; p < F::PER; ++p) q8[g * DH + lane + 32 * p] = (int8_t)(int)qq[p];
    if (lane == 0) qs_s[g] = qs;
    if (fresh && g == 0) {  // mem_group is 1: row bm is the batch row
      const __nv_bfloat16* row = q + (size_t)bm * q_stride + head;
      float kq[F::PER], vq[F::PER];
      const float ks = quantize_head<F::PER>(row + E, lane, kq);
      const float vs = quantize_head<F::PER>(row + 2 * E, lane, vq);
      const size_t slot = ((size_t)bm * T + pos) * E + head;
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < F::PER; ++p) {
        const int d = lane + 32 * p;
        if (rank == 0) {
          kc[slot + d] = (int8_t)(int)kq[p];
          vc[slot + d] = (int8_t)(int)vq[p];
        }
        v_fresh[d] = __fmul_rn(vq[p], vs);
        s += __fmul_rn(__fmul_rn(qq[p], qs), __fmul_rn(kq[p], ks));
      }
      s = __fmul_rn(warp_sum(s), scale);
      if (lane == 0) {
        lc_s = s;
        if (rank == 0) {
          ksc[((size_t)bm * T + pos) * H + h] = __float2bfloat16_rn(ks);
          vsc[((size_t)bm * T + pos) * H + h] = __float2bfloat16_rn(vs);
        }
      }
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
    // a quarter warp (four keys, both halves) reads eight distinct 16-byte
    // bank groups: the chunk order rotates with the key
    const int rot = F::HC > 1 ? (key / (128 / DH)) % F::HC : 0;
    const uint4* qv = reinterpret_cast<const uint4*>(q8);
    for (int i = 0; i < nt; ++i) {
      const int s = i % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / stages) & 1);
      const int t = i * TILE + key;
      int acc[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] = 0;
      if (t < nk) {
        const unsigned char* row = base + s * F::TILE_BYTES + key * DH;
#pragma unroll
        for (int c = 0; c < F::HC; ++c) {
          const int j = half * F::HC + (c + rot) % F::HC;
          const uint4 kw = *reinterpret_cast<const uint4*>(row + j * 16);
#pragma unroll
          for (int g = 0; g < GQ; ++g) {
            const uint4 qw = qv[g * F::NC + j];
            acc[g] = __dp4a((int)kw.x, (int)qw.x, acc[g]);
            acc[g] = __dp4a((int)kw.y, (int)qw.y, acc[g]);
            acc[g] = __dp4a((int)kw.z, (int)qw.z, acc[g]);
            acc[g] = __dp4a((int)kw.w, (int)qw.w, acc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] += __shfl_xor_sync(FULL, acc[g], 1);
      if (t < nk && half == 0) {
        const float ks = __bfloat162float(ks_s[t]);
        const float b = bias != nullptr ? bias[row0 + t] : 0.0f;
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          float l = __fmul_rn(__fmul_rn(__int2float_rn(acc[g]), ks),
                              __fmul_rn(qs_s[g], scale));
          if (bias != nullptr) l = __fadd_rn(l, b);
          logit[g * chunk + t] = l;
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
    float p[sm90::MAX_CLUSTER];
    sm90::load_peers(&mx_s[tid], split, p);
    float v = p[0];
#pragma unroll
    for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
      if (r < split) v = fmaxf(v, p[r]);
    m_s[tid] = fresh ? fmaxf(v, lc_s) : v;
  }
  __syncthreads();

  // the weights against the global max: their fp32 partial denominator, and
  // w * vs in place with its block max
  float den[GQ], wvm[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float m = m_s[g];
    den[g] = 0.0f;
    wvm[g] = 0.0f;
    for (int t = tid; t < nk; t += THREADS) {
      const float w = expf(logit[g * chunk + t] - m);
      const float wv = __fmul_rn(w, __bfloat162float(vs_s[t]));
      den[g] += w;
      wvm[g] = fmaxf(wvm[g], wv);
      logit[g * chunk + t] = wv;
    }
  }
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float d = warp_sum(den[g]);
    const float v = warp_max(wvm[g]);
    if (lane == 0) {
      red[warp][g] = d;
      red2[warp][g] = v;
    }
  }
  __syncthreads();
  if (tid < GQ) {
    float d = red[0][tid], v = red2[0][tid];
    for (int w = 1; w < WARPS; ++w) {
      d += red[w][tid];
      v = fmaxf(v, red2[w][tid]);
    }
    den_s[tid] = d;
    wvmax_s[tid] = v;
  }
  sm90::cluster_sync();  // every block's w * vs max is published
  if (tid < GQ) {
    float p[sm90::MAX_CLUSTER];
    sm90::load_peers(&wvmax_s[tid], split, p);
    float v = p[0];
#pragma unroll
    for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
      if (r < split) v = fmaxf(v, p[r]);
    ws_s[tid] = __fdiv_rn(fmaxf(v, 1e-30f), 127.0f);
  }
  __syncthreads();
  // the integer weights (0..127), zero up to the next whole quad of keys
  const int nk4 = (nk + 3) / 4 * 4;
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float ws = ws_s[g];
    for (int t = tid; t < nk4; t += THREADS)
      wq_s[g * chunk + t] =
          t < nk ? (int8_t)__float2int_rn(__fdiv_rn(logit[g * chunk + t], ws))
                 : (int8_t)0;
  }
  __syncthreads();

  // phase B: the integer PV partial, a thread on one word column (four head
  // dims) of every KQL-th quad of keys
  int acc[GQ][4];
#pragma unroll
  for (int g = 0; g < GQ; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0;
  {
    const int c = tid % F::NW, kl = tid / F::NW;
    // the lanes of one warp on different quads read rows rotated by their
    // quad, so that they fall in different banks
    const int ir = (lane / F::NW) % 4;
    for (int i = 0; i < nt; ++i) {
      const int j = nt + i, s = j % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
      const unsigned char* tile = base + s * F::TILE_BYTES;
      const int quads = (min(TILE, nk - i * TILE) + 3) / 4;
      for (int kq = kl; kq < quads; kq += F::KQL) {
        uint32_t v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r] = *reinterpret_cast<const uint32_t*>(
              tile + (4 * kq + (r + ir) % 4) * DH + 4 * c);
        // four words of one dim each, key r in byte r
        const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
        const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
        const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
        const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
        const int d[4] = {(int)__byte_perm(t0, t1, 0x5410),
                          (int)__byte_perm(t0, t1, 0x7632),
                          (int)__byte_perm(t2, t3, 0x5410),
                          (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const uint32_t wv = *reinterpret_cast<const uint32_t*>(
              wq_s + g * chunk + i * TILE + 4 * kq);
          const int w = (int)__funnelshift_r(wv, wv, 8 * ir);  // rows' order
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = __dp4a(d[e], w, acc[g][e]);
        }
      }
      if (refill) {
        __syncthreads();  // the slot is free
        if (tid == 0 && j + stages < loads) fetch(j + stages);
      }
    }
  }
  for (int o = F::NW; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GQ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
  if (lane < F::NW) {
#pragma unroll
    for (int g = 0; g < GQ; ++g)
      *reinterpret_cast<int4*>(&part[warp][g * DH + 4 * lane]) =
          make_int4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  for (int i = tid; i < GQ * DH; i += THREADS) {
    int v = part[0][i];
    for (int w = 1; w < WARPS; ++w) v += part[w][i];
    acc_s[i] = v;
  }
  sm90::cluster_sync();  // every block's partial and denominator published

  // every block a share of the outputs: the exact partials over the ranks,
  // the denominators in rank order, the fresh term, the division
  for (int i = rank * THREADS + tid; i < GQ * DH; i += split * THREADS) {
    const int g = i / DH, dd = i % DH, qi = g0 + g;
    if (qi >= mem_group) continue;
    int pi[sm90::MAX_CLUSTER];
    float pd[sm90::MAX_CLUSTER];
    sm90::load_peers(&acc_s[i], split, pi);
    sm90::load_peers(&den_s[g], split, pd);
    int o_int = pi[0];
    float dn = pd[0];
#pragma unroll
    for (int r = 1; r < sm90::MAX_CLUSTER; ++r)
      if (r < split) {
        o_int += pi[r];
        dn += pd[r];
      }
    float o = __fmul_rn(__int2float_rn(o_int), ws_s[g]);
    if (fresh) {
      const float wc = expf(lc_s - m_s[g]);
      o = __fadd_rn(o, __fmul_rn(wc, v_fresh[dd]));
      dn += wc;
    }
    out[((size_t)bm * mem_group + qi) * E + head + dd] =
        __float2bfloat16(__fdiv_rn(o, dn));
  }
  sm90::cluster_sync();  // no block leaves while another reads its partials
}

template <int DH, int GQ>
int launch(const void* q, int q_stride, void* kc, void* vc, void* ksc,
           void* vsc, int B, int H, int T, int n_keys, const void* bias,
           int pos, int mem_group, float scale, int chunk, int split,
           void* out, cudaStream_t s) {
  using F = Form<DH, GQ>;
  const int E = H * DH, bm = B / mem_group;
  const int units = (n_keys + UNIT - 1) / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > std::max(units, 1) ||
      chunk % UNIT != 0 || chunk > F::MAX_CHUNK ||
      chunk < (units + split - 1) / split * UNIT || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  int rc = sm90::encode_map(&tk, kc, (long long)bm * T, E, E, TILE, DH,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (rc == 0)
    rc = sm90::encode_map(&tv, vc, (long long)bm * T, E, E, TILE, DH,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (rc != 0) return rc;
  const int groups = (mem_group + GQ - 1) / GQ;
  const int stages = sm90::ring_stages(
      (long long)split * H * bm * groups, F::STATIC + F::smem(0, chunk),
      F::TILE_BYTES, F::MAX_STAGES, 2 * ((chunk + TILE - 1) / TILE));
  const auto kernel = attend_int8_cluster<DH, GQ>;
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
      kernel, dim3(split, H, bm * groups), THREADS, smem, split, s, tk, tv,
      static_cast<const bf*>(q), q_stride, static_cast<int8_t*>(kc),
      static_cast<int8_t*>(vc), static_cast<bf*>(ksc), static_cast<bf*>(vsc),
      T, E, H, n_keys, static_cast<const float*>(bias), pos, mem_group, chunk,
      stages, scale, static_cast<bf*>(out));
}

template <int DH>
int launch_dh(int gq, const void* q, int q_stride, void* kc, void* vc,
              void* ksc, void* vsc, int B, int H, int T, int n_keys,
              const void* bias, int pos, int mem_group, float scale, int chunk,
              int split, void* out, cudaStream_t s) {
#define ACAI_GQ(G)                                                          \
  launch<DH, G>(q, q_stride, kc, vc, ksc, vsc, B, H, T, n_keys, bias, pos,  \
                mem_group, scale, chunk, split, out, s)
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
decode_attention_int8_kernel(const __nv_bfloat16* __restrict__ q, int q_stride,
                             int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                             __nv_bfloat16* __restrict__ ksc,
                             __nv_bfloat16* __restrict__ vsc, int T, int E,
                             int H, int n_keys, const float* __restrict__ bias,
                             int pos, int mem_group, float scale,
                             __nv_bfloat16* __restrict__ out) {
  constexpr int PER = DH / 32;  // elements per lane in the quantizer
  constexpr int LPR = DH / 4;   // lanes per key row, one 32-bit word each
  constexpr int RPW = 32 / LPR; // key rows per warp pass
  extern __shared__ float logits[];  // n_keys words: logits, w*vs, int weights
  __shared__ int red[WARPS][DH];
  __shared__ float scratch[2][WARPS];
  __shared__ __align__(4) int8_t q8[DH];
  __shared__ float v_fresh[DH];
  __shared__ float head_scalars[2];  // q scale, fresh logit

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bm = b / mem_group;  // row of the caches / memory and the bias
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool fresh = pos >= 0;
  const size_t head = (size_t)h * DH;

  if (warp == 0) {
    const __nv_bfloat16* row = q + (size_t)b * q_stride + head;
    float qq[PER];
    const float qs = quantize_head<PER>(row, lane, qq);
#pragma unroll
    for (int p = 0; p < PER; ++p) q8[lane + 32 * p] = (int8_t)(int)qq[p];
    float lc = -FLT_MAX;
    if (fresh) {
      float kq[PER], vq[PER];
      const float ks = quantize_head<PER>(row + E, lane, kq);
      const float vs = quantize_head<PER>(row + 2 * E, lane, vq);
      const size_t slot = ((size_t)b * T + pos) * E + head;
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int d = lane + 32 * p;
        kc[slot + d] = (int8_t)(int)kq[p];
        vc[slot + d] = (int8_t)(int)vq[p];
        v_fresh[d] = __fmul_rn(vq[p], vs);
        s += __fmul_rn(__fmul_rn(qq[p], qs), __fmul_rn(kq[p], ks));
      }
      lc = __fmul_rn(warp_sum(s), scale);
      if (lane == 0) {
        ksc[((size_t)b * T + pos) * H + h] = __float2bfloat16_rn(ks);
        vsc[((size_t)b * T + pos) * H + h] = __float2bfloat16_rn(vs);
      }
    }
    if (lane == 0) {
      head_scalars[0] = qs;
      head_scalars[1] = lc;
    }
  }
  __syncthreads();
  const float q_scale = __fmul_rn(head_scalars[0], scale);
  const float lc = head_scalars[1];
  const int sub = lane % LPR;
  const int32_t qw = reinterpret_cast<const int32_t*>(q8)[sub];

  // logits over the cache / memory rows
  for (int t0 = warp * RPW; t0 < n_keys; t0 += WARPS * RPW) {
    const int t = t0 + lane / LPR;
    int dot = 0;
    if (t < n_keys) {
      const int32_t kw = *reinterpret_cast<const int32_t*>(
          kc + ((size_t)bm * T + t) * E + head + 4 * sub);
      dot = __dp4a(kw, qw, 0);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    if (t < n_keys && sub == 0) {
      const float ks = __bfloat162float(ksc[((size_t)bm * T + t) * H + h]);
      float l = __fmul_rn(__fmul_rn(__int2float_rn(dot), ks), q_scale);
      if (bias != nullptr) l = __fadd_rn(l, bias[(size_t)bm * T + t]);
      logits[t] = l;
    }
  }
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) mx = fmaxf(mx, logits[t]);
  mx = warp_max(mx);
  if (lane == 0) scratch[0][warp] = mx;
  __syncthreads();
  mx = scratch[0][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, scratch[0][w]);
  if (fresh) mx = fmaxf(mx, lc);
  __syncthreads();

  // w = exp(logit - m); the denominator sums w, the V product takes w * vs
  float sum = 0.0f;
  float wv_max = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float w = expf(logits[t] - mx);
    const float wv =
        __fmul_rn(w, __bfloat162float(vsc[((size_t)bm * T + t) * H + h]));
    logits[t] = wv;
    sum += w;
    wv_max = fmaxf(wv_max, wv);
  }
  sum = warp_sum(sum);
  wv_max = warp_max(wv_max);
  if (lane == 0) {
    scratch[0][warp] = sum;
    scratch[1][warp] = wv_max;
  }
  __syncthreads();
  float denom = 0.0f;
  wv_max = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    denom += scratch[0][w];
    wv_max = fmaxf(wv_max, scratch[1][w]);
  }
  const float wc = fresh ? expf(lc - mx) : 0.0f;
  denom += wc;
  const float ws = __fdiv_rn(fmaxf(wv_max, 1e-30f), 127.0f);
  int* wq = reinterpret_cast<int*>(logits);
  for (int t = tid; t < n_keys; t += THREADS)
    wq[t] = __float2int_rn(__fdiv_rn(logits[t], ws));
  __syncthreads();

  // integer PV: each lane owns four output dims (one V word per key row)
  int acc[4] = {0, 0, 0, 0};
  for (int t0 = warp * RPW; t0 < n_keys; t0 += WARPS * RPW) {
    const int t = t0 + lane / LPR;
    if (t < n_keys) {
      const int w = wq[t];
      const int32_t vw = *reinterpret_cast<const int32_t*>(
          vc + ((size_t)bm * T + t) * E + head + 4 * sub);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += w * (int)(int8_t)(vw >> (8 * j));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
    if (lane < LPR) red[warp][4 * lane + j] = acc[j];
  }
  __syncthreads();

  if (tid < DH) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][tid];
    float o = __fmul_rn(__int2float_rn(s), ws);
    if (fresh) o = __fadd_rn(o, __fmul_rn(wc, v_fresh[tid]));
    out[(size_t)b * E + head + tid] = __float2bfloat16(__fdiv_rn(o, denom));
  }
}

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q: (B, q_stride) bf16 with head h's
// query at columns [h*Dh, (h+1)*Dh); in self mode (pos >= 0) the fresh k/v
// follow at +E and +2E of the same row, n_keys == pos, bias is null and
// mem_group is 1. Cross mode (pos < 0): n_keys == T, kc/vc (B / mem_group, T,
// E) int8, ksc/vsc (B / mem_group, T, H) bf16, bias (B / mem_group, T) fp32.
// out: (B, E) bf16.
extern "C" int acai_decode_attention_int8(const void* q, int q_stride, void* kc,
                                          void* vc, void* ksc, void* vsc, int B,
                                          int H, int dh, int T, int n_keys,
                                          const void* bias, int pos,
                                          int mem_group, float scale, void* out,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * dh;
  dim3 grid(H, B);
  const size_t smem = (size_t)(n_keys > 0 ? n_keys : 1) * sizeof(float);
#define ACAI_LAUNCH(D)                                                         \
  simt::decode_attention_int8_kernel<D><<<grid, simt::THREADS, smem, s>>>(     \
      static_cast<const __nv_bfloat16*>(q), q_stride,                          \
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),                      \
      static_cast<__nv_bfloat16*>(ksc), static_cast<__nv_bfloat16*>(vsc), T,   \
      E, H, n_keys, static_cast<const float*>(bias), pos, mem_group, scale,    \
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

// The cluster kernel: the arguments of acai_decode_attention_int8 above,
// plus `split` (blocks a cluster, <= 8 and at most the 16-key units of
// n_keys; n_keys == 0 takes one block) and `chunk`, the keys of its largest
// range (ceil(units / split) units or more: it sizes the block's per-key
// shared memory). The queries a cluster are the group rounded up to 1, 2, 4
// or 8. kc / vc 16-byte aligned (TMA), E a multiple of 16.
extern "C" int acai_decode_attention_int8_cluster(
    const void* q, int q_stride, void* kc, void* vc, void* ksc, void* vsc,
    int B, int H, int dh, int T, int n_keys, const void* bias, int pos,
    int mem_group, float scale, int chunk, int split, void* out,
    void* stream) {
  if (mem_group < 1 || B % mem_group != 0 || (pos >= 0 && mem_group != 1))
    return (int)cudaErrorInvalidValue;
  const int gq = mem_group == 1 ? 1 : mem_group == 2 ? 2 : mem_group <= 4 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACAI_DH(D)                                                             \
  cl::launch_dh<D>(gq, q, q_stride, kc, vc, ksc, vsc, B, H, T, n_keys, bias,   \
                   pos, mem_group, scale, chunk, split, out, s)
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
    "decode_attention_int8|split|attend_int8_cluster<" #D "," #G ">",       \
        reinterpret_cast<const void*>(cl::attend_int8_cluster<D, G>),       \
        cl::THREADS, cl::Form<D, G>::SMEM_MAX                               \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(32, 1), ACAI_CL(32, 2), ACAI_CL(32, 4), ACAI_CL(32, 8),
    ACAI_CL(64, 1), ACAI_CL(64, 2), ACAI_CL(64, 4), ACAI_CL(64, 8),
    ACAI_CL(128, 1), ACAI_CL(128, 2), ACAI_CL(128, 4), ACAI_CL(128, 8),
    ACAI_KERNEL("decode_attention_int8", "simt",
                simt::decode_attention_int8_kernel<64>, simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
