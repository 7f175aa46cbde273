// K7 attention_bwd: the backward of one multi-head attention site of the
// training stacks: (q, k, v, dO, key validity, causal) -> (dQ, dK, dV).
//
// Replaces: `_attend_bwd` and the `_attend` recompute around it in
// ops/pallas_train_layer.py `_bwd_kernel` (the self-attention loop and the
// cross-attention loop over `mem_kv`) in the JAX package.
//
// Operands as K3 (encoder_attention.cu): q and dO rows (B*Tq), k and v rows
// (B*Tk), each with its own row stride, head h at columns h*Dh; valid (B, Tk)
// uint8; dQ, dK, dV are written through their own row strides, so the self
// site fills one (B*T, 3E) dqkv buffer and the cross site fills dqc and
// d(mem_kv)[l] (B, M, 2E) in place.
//
// Numerics follow `_attend_bwd`: the probabilities are recomputed exactly as
// the forward computes them (additive -1e9 masks, fp32 softmax normalised
// before any rounding), dP = dO V^T in fp32, dV = bf16(P)^T dO,
// D = rowsum(dP * P), dS = P * (dP - D) scaled by 1/sqrt(Dh) and rounded to
// bf16, dQ = dS K, dK = dS^T Q, each from an fp32 accumulator rounded once.
//
// Bound on an H100: the larger of its tensor-core flops (five Tq x Tk x Dh
// products a head over the attended (query, key) pairs, at 989 TFLOP/s
// bf16) and its bytes (q, k, v, dO read once, dQ, dK, dV written once, at
// 3.35 TB/s): the flops at the encoder's T = 1,024, the bytes at the
// decoder's 256 rows and at dh = 32. Either is far below what the
// recomputed softmax costs, so the design cuts products and keeps every
// product on wgmma.
//
// The Hopper design (`sm90`, the default): two launches, no atomics, so two
// runs give equal bits. Nine products, the fewest two launches without
// atomics allow (the dK / dV launch needs every row's statistics and D before
// its first tile, so the dQ launch sweeps the keys twice; summing dQ across
// key tiles in memory instead costs more bytes than the two products it
// saves at dh = 32):
//   1. attn_bwd_dq_sm90, one block per (128 query rows, head, image): sweep
//      1 computes S = Q K^T and dP = dO V^T a key tile at a time and keeps
//      the row max, the row sum and D = sum exp(s - max) dP under the running
//      max (rescaled when it moves; D = that sum / the row sum); sweep 2
//      recomputes S and dP, forms dS and accumulates dQ += dS K. Writes dQ
//      and (max, 1/sum, D) to the (3, B, H, Tq) statistics.
//   2. attn_bwd_dkv_sm90, one block per (128 key rows, head, image): per
//      query tile S^T = K Q^T, dP^T = V dO^T, P^T and dS^T from the
//      statistics, dV += P^T dO, dK += dS^T Q.
// Each block: a producer warp (TMA loads of the block's fixed Q / dO or K / V
// tiles, then a ring of four stages of the streamed K / V or Q / dO tiles,
// with the key validity bytes or the statistics beside them as bulk copies)
// and two consumer warpgroups of 64 rows (the building blocks, shared with
// K3's forward, are in attention_sm90.cuh). Operands are read in place from
// the strided buffers (a head is a 64 x Dh box of the operand's map) into
// swizzled shared memory: 128-byte swizzle at Dh = 64, 64-byte at Dh = 32,
// each head alone. All products are wgmma m64nNk16 bf16 -> fp32: S and dP
// with both operands in shared memory (K-major), dQ / dK / dV with A = dS or
// P from registers (the accumulator's fragment is the A fragment, rounded to
// bf16 pairs) and B = K, Q or dO read MN-major (the transpose bit). The dK
// and dV accumulators stay in registers (64 a thread at Dh = 64). Skips,
// exact because a masked key's probability underflows to 0 when the row has
// a key it may attend (bidirectional: the image has a valid key; causal: its
// key 0 is valid): key tiles past the last valid key and, causal, past the
// diagonal (dQ); query tiles before the diagonal and key rows past the last
// valid key (dK / dV, written as zeros). Without that (a row with no key it
// may attend spreads its probability over the masked keys, as the forward
// does) nothing is skipped.
//
// The pre-Hopper design (`wmma`, kept as the yardstick): two launches of four
// warps, wmma 16x16x16 bf16 tiles, 64 x 64 tiles through padded shared
// memory with 16-byte loads, ten products: attn_bwd_dq sweeps the keys three
// times (statistics; D; dS and dQ), attn_bwd_dkv recomputes P and dS from the
// statistics. The head dim is a template parameter in both designs, 64 or 32
// (the MAE decoder): each head is its own Dh-wide tile product, as in K3; the
// TPU kernel's pairing of two 32-wide heads under 0/1 lane masks has no
// counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

#include "func_attrs.cuh"
#include "attention_sm90.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 128;
constexpr int P_LD = TILE + 8;  // bf16 tiles of P and dS (64 x 64)
constexpr int S_LD = TILE + 4;  // fp32 tile
constexpr float NEG = -1e9f;
constexpr int P_TILE = TILE * P_LD;  // elements of one P / dS tile
constexpr int F_TILE = TILE * S_LD;  // elements of one fp32 tile

// Per head dim: the 64 x DH bf16 tiles of Q, dO, K, V (row stride DH + 8) and
// the two kernels' dynamic shared memory.
template <int DH>
struct Dims {
  static constexpr int H_LD = DH + 8;
  static constexpr int BF_TILE = TILE * H_LD;
  static constexpr size_t DQ_SMEM =
      (4 * BF_TILE + P_TILE) * sizeof(__nv_bfloat16) + F_TILE * sizeof(float) +
      TILE * sizeof(float);
  static constexpr size_t DKV_SMEM =
      (4 * BF_TILE + 2 * P_TILE) * sizeof(__nv_bfloat16) +
      F_TILE * sizeof(float) + 4 * TILE * sizeof(float);
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld_g,
                                          int tid) {
#pragma unroll
  for (int v = tid; v < TILE * DH / 8; v += THREADS) {
    const int r = v / (DH / 8);
    const int c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld_g + c);
  }
}

// C(16 x 64, fp32, into dst rows row0..) = A_w (16 x DH of `a`) * B^T where B
// is a 64 x DH bf16 tile: C[r][c] = sum_d a[row0 + r][d] * b[c][d].
template <int DH>
__device__ __forceinline__ void mm_abt(float* dst, const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, int row0) {
  constexpr int H_LD = DH + 8;
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
    FragC s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + row0 * H_LD + kk * 16, H_LD);
      wmma::load_matrix_sync(fb, b + (j * 16) * H_LD + kk * 16, H_LD);
      wmma::mma_sync(s, fa, fb, s);
    }
    wmma::store_matrix_sync(dst + row0 * S_LD + j * 16, s, S_LD,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

// The two logits of this lane in row r of the warp's score rows, biased.
__device__ __forceinline__ void biased(const float* Ss, const float* kbias,
                                       int row, int lane, int qi, int k0,
                                       float scale, int causal, float& s0,
                                       float& s1) {
  const float* srow = Ss + row * S_LD;
  const float c0 = (causal && k0 + lane > qi) ? NEG : 0.0f;
  const float c1 = (causal && k0 + lane + 32 > qi) ? NEG : 0.0f;
  s0 = srow[lane] * scale + (c0 + kbias[lane]);
  s1 = srow[lane + 32] * scale + (c1 + kbias[lane + 32]);
}

struct Operands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* d_o;
  const uint8_t* valid;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;  // (3, B, H, Tq): max, 1/sum, D
  int B, H, Tq, Tk;
  int ldq, ldkv, ldo, lddq, lddkv;
  float scale;
  int causal;
};

template <int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq(Operands p) {
  constexpr int H_LD = Dims<DH>::H_LD;
  constexpr int BF_TILE = Dims<DH>::BF_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BF_TILE;
  __nv_bfloat16* Ks = dOs + BF_TILE;
  __nv_bfloat16* Vs = Ks + BF_TILE;
  __nv_bfloat16* dSs = Vs + BF_TILE;
  float* Ss = reinterpret_cast<float*>(dSs + P_TILE);
  float* kbias = Ss + F_TILE;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * 16;
  const __nv_bfloat16* kb = p.k + (size_t)b * p.Tk * p.ldkv + h * DH;
  const __nv_bfloat16* vb = p.v + (size_t)b * p.Tk * p.ldkv + h * DH;

  load_tile<DH>(Qs, p.q + ((size_t)b * p.Tq + q0) * p.ldq + h * DH, p.ldq, tid);
  load_tile<DH>(dOs, p.d_o + ((size_t)b * p.Tq + q0) * p.ldo + h * DH, p.ldo, tid);

  float m_run[16], l_run[16], dsum[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.0f;
    dsum[r] = 0.0f;
  }

  auto load_keys = [&](int k0, bool with_v) {
    __syncthreads();
    load_tile<DH>(Ks, kb + (size_t)k0 * p.ldkv, p.ldkv, tid);
    if (with_v) load_tile<DH>(Vs, vb + (size_t)k0 * p.ldkv, p.ldkv, tid);
    if (tid < TILE)
      kbias[tid] = p.valid[(size_t)b * p.Tk + k0 + tid] ? 0.0f : NEG;
    __syncthreads();
  };

  // pass 1: softmax statistics, as the forward takes them
  for (int k0 = 0; k0 < p.Tk; k0 += TILE) {
    load_keys(k0, false);
    mm_abt<DH>(Ss, Qs, Ks, row0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s0, s1;
      biased(Ss, kbias, row0 + r, lane, q0 + row0 + r, k0, p.scale, p.causal,
             s0, s1);
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + e;
      m_run[r] = m_new;
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) l_run[r] = 1.0f / l_run[r];  // now 1/sum

  // pass 2: D = rowsum(dP * P); pass 3: dS and dQ += dS K
  FragC dq[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(dq[j], 0.0f);

  for (int pass = 2; pass <= 3; ++pass) {
    for (int k0 = 0; k0 < p.Tk; k0 += TILE) {
      load_keys(k0, true);
      mm_abt<DH>(Ss, Qs, Ks, row0);
      float p0[16], p1[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float s0, s1;
        biased(Ss, kbias, row0 + r, lane, q0 + row0 + r, k0, p.scale, p.causal,
               s0, s1);
        p0[r] = expf(s0 - m_run[r]) * l_run[r];
        p1[r] = expf(s1 - m_run[r]) * l_run[r];
      }
      __syncwarp();
      mm_abt<DH>(Ss, dOs, Vs, row0);  // dP over the score rows
      if (pass == 2) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float* srow = Ss + (row0 + r) * S_LD;
          dsum[r] += warp_sum(p0[r] * srow[lane] + p1[r] * srow[lane + 32]);
        }
        __syncwarp();
        continue;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float* srow = Ss + (row0 + r) * S_LD;
        __nv_bfloat16* drow = dSs + (row0 + r) * P_LD;
        drow[lane] =
            __float2bfloat16(p0[r] * (srow[lane] - dsum[r]) * p.scale);
        drow[lane + 32] =
            __float2bfloat16(p1[r] * (srow[lane + 32] - dsum[r]) * p.scale);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        FragA fa;
        wmma::load_matrix_sync(fa, dSs + row0 * P_LD + kk * 16, P_LD);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, Ks + (kk * 16) * H_LD + j * 16, H_LD);
          wmma::mma_sync(dq[j], fa, fb, dq[j]);
        }
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16, dq[j], S_LD,
                            wmma::mem_row_major);
  __syncwarp();
  const size_t plane = (size_t)p.B * p.H * p.Tq;
  const size_t srow0 = ((size_t)b * p.H + h) * p.Tq + q0 + row0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float* srow = Ss + (row0 + r) * S_LD;
    __nv_bfloat16* orow =
        p.dq + ((size_t)b * p.Tq + q0 + row0 + r) * p.lddq + h * DH;
#pragma unroll
    for (int c = lane; c < DH; c += 32) orow[c] = __float2bfloat16(srow[c]);
    if (lane == 0) {
      p.stats[srow0 + r] = m_run[r];
      p.stats[plane + srow0 + r] = l_run[r];
      p.stats[2 * plane + srow0 + r] = dsum[r];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv(Operands p) {
  constexpr int H_LD = Dims<DH>::H_LD;
  constexpr int BF_TILE = Dims<DH>::BF_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BF_TILE;
  __nv_bfloat16* Qs = Vs + BF_TILE;
  __nv_bfloat16* dOs = Qs + BF_TILE;
  __nv_bfloat16* Ps = dOs + BF_TILE;
  __nv_bfloat16* dSs = Ps + P_TILE;
  float* Ss = reinterpret_cast<float*>(dSs + P_TILE);
  float* kbias = Ss + F_TILE;
  float* st_m = kbias + TILE;
  float* st_il = st_m + TILE;
  float* st_d = st_il + TILE;

  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * 16;
  const size_t plane = (size_t)p.B * p.H * p.Tq;

  load_tile<DH>(Ks, p.k + ((size_t)b * p.Tk + k0) * p.ldkv + h * DH, p.ldkv, tid);
  load_tile<DH>(Vs, p.v + ((size_t)b * p.Tk + k0) * p.ldkv + h * DH, p.ldkv, tid);
  if (tid < TILE) kbias[tid] = p.valid[(size_t)b * p.Tk + k0 + tid] ? 0.0f : NEG;

  FragC dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.0f);
    wmma::fill_fragment(dv[j], 0.0f);
  }

  for (int q0 = 0; q0 < p.Tq; q0 += TILE) {
    __syncthreads();  // the last tile's P, dS, Q, dO are consumed
    load_tile<DH>(Qs, p.q + ((size_t)b * p.Tq + q0) * p.ldq + h * DH, p.ldq, tid);
    load_tile<DH>(dOs, p.d_o + ((size_t)b * p.Tq + q0) * p.ldo + h * DH, p.ldo, tid);
    if (tid < TILE) {
      const size_t s = ((size_t)b * p.H + h) * p.Tq + q0 + tid;
      st_m[tid] = p.stats[s];
      st_il[tid] = p.stats[plane + s];
      st_d[tid] = p.stats[2 * plane + s];
    }
    __syncthreads();

    // this warp's 16 query rows: P, then dS, into shared memory
    mm_abt<DH>(Ss, Qs, Ks, row0);
    float p0[16], p1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s0, s1;
      biased(Ss, kbias, row0 + r, lane, q0 + row0 + r, k0, p.scale, p.causal,
             s0, s1);
      p0[r] = expf(s0 - st_m[row0 + r]) * st_il[row0 + r];
      p1[r] = expf(s1 - st_m[row0 + r]) * st_il[row0 + r];
      __nv_bfloat16* prow = Ps + (row0 + r) * P_LD;
      prow[lane] = __float2bfloat16(p0[r]);
      prow[lane + 32] = __float2bfloat16(p1[r]);
    }
    __syncwarp();
    mm_abt<DH>(Ss, dOs, Vs, row0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      __nv_bfloat16* drow = dSs + (row0 + r) * P_LD;
      const float d = st_d[row0 + r];
      drow[lane] = __float2bfloat16(p0[r] * (srow[lane] - d) * p.scale);
      drow[lane + 32] =
          __float2bfloat16(p1[r] * (srow[lane + 32] - d) * p.scale);
    }
    __syncthreads();  // all 64 query rows of P and dS are written

    // this warp's 16 key rows: dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int qq = 0; qq < TILE / 16; ++qq) {
      FragAT fp, fs;
      wmma::load_matrix_sync(fp, Ps + (qq * 16) * P_LD + row0, P_LD);
      wmma::load_matrix_sync(fs, dSs + (qq * 16) * P_LD + row0, P_LD);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        FragB fo, fq;
        wmma::load_matrix_sync(fo, dOs + (qq * 16) * H_LD + j * 16, H_LD);
        wmma::load_matrix_sync(fq, Qs + (qq * 16) * H_LD + j * 16, H_LD);
        wmma::mma_sync(dv[j], fp, fo, dv[j]);
        wmma::mma_sync(dk[j], fs, fq, dk[j]);
      }
    }
  }

  // write dK then dV through the score buffer (each warp its own 16 rows)
  __syncthreads();
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j)
      wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16,
                              which == 0 ? dk[j] : dv[j], S_LD,
                              wmma::mem_row_major);
    __syncwarp();
    __nv_bfloat16* dst = which == 0 ? p.dk : p.dv;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      __nv_bfloat16* orow =
          dst + ((size_t)b * p.Tk + k0 + row0 + r) * p.lddkv + h * DH;
#pragma unroll
      for (int c = lane; c < DH; c += 32) orow[c] = __float2bfloat16(srow[c]);
    }
    __syncwarp();
  }
}

template <int DH>
int launch_wmma(const Operands& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Dims<DH>::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Dims<DH>::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<DH><<<dim3(p.Tq / TILE, p.H, p.B), THREADS, Dims<DH>::DQ_SMEM,
                    s>>>(p);
  attn_bwd_dkv<DH><<<dim3(p.Tk / TILE, p.H, p.B), THREADS, Dims<DH>::DKV_SMEM,
                     s>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the Hopper form

using attn90::bias_scores;
using attn90::block_skip;
using attn90::desc_k;
using attn90::desc_mn;
using attn90::init_ring;
using attn90::LOG2E;
using attn90::pack_bf16;
using attn90::quad_max;
using attn90::quad_sum;
using attn90::release;
using attn90::ROWS;
using attn90::Skip;
using attn90::SM90_THREADS;
using attn90::STAGES;
using attn90::store_rows;
using attn90::wgmma_rs;
using attn90::zero;

// Shared memory of both kernels: the fixed tiles (two consumers' Q and dO,
// or K and V), the ring of STAGES pairs of streamed tiles, and beside each
// stage its validity bytes (dQ) or its three rows of statistics (dK / dV).
template <int DH>
struct Smem {
  static constexpr int TILE = ROWS * DH * 2;  // a 64 x DH bf16 tile
  static constexpr int FIXED = 4 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int SIDE = 3 * ROWS * 4;
  static constexpr int BYTES = 1024 + FIXED + STAGES * STAGE + STAGES * SIDE;
  static_assert(TILE % 1024 == 0, "every tile keeps the swizzle's alignment");
  static_assert(BYTES <= 227 * 1024, "past the card's shared memory");
};

// Two 64 x 64 products of one warpgroup, both operands K-major in shared
// memory, waited for: s = a0 b0^T and t = a1 b1^T over Dh.
template <int DH>
__device__ __forceinline__ void two_products(float (&s)[32], float (&t)[32],
                                             uint32_t a0, uint32_t b0,
                                             uint32_t a1, uint32_t b1) {
  zero(s);
  zero(t);
  sm90::fence_acc(s);
  sm90::fence_acc(t);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    sm90::wgmma_n64<0, 0>(s, desc_k<DH>(a0, kk), desc_k<DH>(b0, kk));
    sm90::wgmma_n64<0, 0>(t, desc_k<DH>(a1, kk), desc_k<DH>(b1, kk));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_acc(s);
  sm90::fence_acc(t);
}

template <int DH>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, Operands p) {
  using L = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t fixed;
  __shared__ int last_sh;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + L::FIXED;
  const uint32_t side = ring + STAGES * L::STAGE;
  const unsigned char* side_g = smem_raw + (side - raw);

  const int q0 = blockIdx.x * 2 * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int n_wg = min(2, (p.Tq - q0) / ROWS);
  const Skip sk = block_skip(p.valid, p.Tk, p.causal, b, &last_sh);
  int n_kt = p.Tk / ROWS;  // key tiles swept, twice
  if (sk.on) {
    n_kt = sk.last / ROWS + 1;
    if (p.causal) n_kt = min(n_kt, (q0 + n_wg * ROWS - 1) / ROWS + 1);
  }
  init_ring(full, empty, &fixed, 4 * n_wg);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const uint32_t fb = sm90::smem_u32(&fixed);
      sm90::mbar_expect_tx(fb, n_wg * 2 * L::TILE);
      for (int c = 0; c < n_wg; ++c) {
        const int row = b * p.Tq + q0 + c * ROWS;
        sm90::tma_load(base + c * L::TILE, &tq, fb, h * DH, row);
        sm90::tma_load(base + (2 + c) * L::TILE, &tdo, fb, h * DH, row);
      }
      for (int i = 0; i < 2 * n_kt; ++i) {
        const int s = i % STAGES, kt = i < n_kt ? i : i - n_kt;
        const uint32_t fs = sm90::smem_u32(&full[s]);
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(fs, L::STAGE + ROWS);
        const int row = b * p.Tk + kt * ROWS;
        sm90::tma_load(ring + s * L::STAGE, &tk, fs, h * DH, row);
        sm90::tma_load(ring + s * L::STAGE + L::TILE, &tv, fs, h * DH, row);
        sm90::bulk_load(side + s * L::SIDE, p.valid + row, ROWS, fs);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int lt = threadIdx.x % 128, lane = lt % 32;
  const int t4 = lane % 4;
  const int qa = q0 + c * ROWS + (lt / 32) * 16 + lane / 4;  // rows qa, qa + 8
  const int q_hi = q0 + c * ROWS + ROWS - 1;
  const uint32_t qs = base + c * L::TILE, dos = base + (2 + c) * L::TILE;
  const float scale = p.scale;
  sm90::mbar_wait(sm90::smem_u32(&fixed), 0);

  float mrow[2] = {-FLT_MAX, -FLT_MAX}, lrow[2] = {0.0f, 0.0f};
  float drow[2] = {0.0f, 0.0f};
  float sc[32], dp[32], dq[DH / 2];
  zero(dq);
  for (int i = 0; i < 2 * n_kt; ++i) {
    const int s = i % STAGES, kt = i < n_kt ? i : i - n_kt;
    const bool sweep2 = i >= n_kt;
    if (i == n_kt) {  // the statistics, for sweep 2 and the dK / dV launch
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lrow[hh] = 1.0f / quad_sum(lrow[hh]);
        drow[hh] = quad_sum(drow[hh]) * lrow[hh];
        if (t4 == 0) {
          const size_t plane = (size_t)p.B * p.H * p.Tq;
          const size_t o = ((size_t)b * p.H + h) * p.Tq + qa + 8 * hh;
          p.stats[o] = mrow[hh];
          p.stats[plane + o] = lrow[hh];
          p.stats[2 * plane + o] = drow[hh];
        }
        mrow[hh] *= LOG2E;
      }
    }
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / STAGES) & 1);
    if (sk.on && p.causal && kt * ROWS > q_hi) {  // past this warpgroup's
      release(&empty[s], lane);                  // diagonal: all zeros
      continue;
    }
    const uint32_t ks = ring + s * L::STAGE;
    two_products<DH>(sc, dp, qs, ks, dos, ks + L::TILE);
    // the logits, biased as the forward biases them
    bias_scores(sc, side_g + s * L::SIDE, kt, qa, t4, scale, p.causal);
    if (!sweep2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -FLT_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        const float m_new = fmaxf(mrow[hh], quad_max(mx));
        const float alpha = exp2f((mrow[hh] - m_new) * LOG2E);
        const float ml = m_new * LOG2E;
        float l = lrow[hh] * alpha, d = drow[hh] * alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float ex = exp2f(fmaf(sc[x], LOG2E, -ml));
            l += ex;
            d = fmaf(ex, dp[x], d);
          }
        mrow[hh] = m_new;
        lrow[hh] = l;
        drow[hh] = d;
      }
      release(&empty[s], lane);
      continue;
    }
    // sweep 2: dS (rounded) into A fragments, then dQ += dS K
    uint32_t a[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int hh = x % 2;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = exp2f(fmaf(sc[2 * x + e], LOG2E, -mrow[hh])) * lrow[hh];
        ds[e] = pr * (dp[2 * x + e] - drow[hh]) * scale;
      }
      a[x] = pack_bf16(ds[0], ds[1]);
    }
    sm90::fence_acc(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma_rs<DH>(dq, a + 4 * kk, desc_mn<DH>(ks, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(dq);
    sm90::fence_regs(a);
    release(&empty[s], lane);
  }
  store_rows<DH>(p.dq + ((size_t)b * p.Tq + q0 + c * ROWS) * p.lddq, p.lddq,
                 h * DH, dq, lt);
}

template <int DH>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    attn_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, Operands p) {
  using L = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t fixed;
  __shared__ int last_sh;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + L::FIXED;
  const uint32_t side = ring + STAGES * L::STAGE;
  const float* side_g = reinterpret_cast<const float*>(smem_raw + (side - raw));

  const int k0 = blockIdx.x * 2 * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int n_wg = min(2, (p.Tk - k0) / ROWS);
  const Skip sk = block_skip(p.valid, p.Tk, p.causal, b, &last_sh);
  // consumers whose 64 keys all lie past the last valid key write zeros
  const int n_work = !sk.on ? n_wg
                     : sk.last < k0 ? 0
                                    : min(n_wg, (sk.last - k0) / ROWS + 1);
  const int qt0 = sk.on && p.causal ? k0 / ROWS : 0;  // the diagonal's tile
  const int n_qt = p.Tq / ROWS - qt0;
  init_ring(full, empty, &fixed, 4 * n_work);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0 && n_work > 0) {
      const uint32_t fb = sm90::smem_u32(&fixed);
      sm90::mbar_expect_tx(fb, n_work * 2 * L::TILE);
      for (int c = 0; c < n_work; ++c) {
        const int row = b * p.Tk + k0 + c * ROWS;
        sm90::tma_load(base + c * L::TILE, &tk, fb, h * DH, row);
        sm90::tma_load(base + (2 + c) * L::TILE, &tv, fb, h * DH, row);
      }
      const size_t plane = (size_t)p.B * p.H * p.Tq;
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % STAGES, qt = qt0 + i;
        const uint32_t fs = sm90::smem_u32(&full[s]);
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(fs, L::STAGE + L::SIDE);
        const int row = b * p.Tq + qt * ROWS;
        sm90::tma_load(ring + s * L::STAGE, &tq, fs, h * DH, row);
        sm90::tma_load(ring + s * L::STAGE + L::TILE, &tdo, fs, h * DH, row);
        const float* st = p.stats + ((size_t)b * p.H + h) * p.Tq + qt * ROWS;
        for (int k = 0; k < 3; ++k)
          sm90::bulk_load(side + s * L::SIDE + k * ROWS * 4, st + k * plane,
                          ROWS * 4, fs);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int lt = threadIdx.x % 128, lane = lt % 32;
  const int t4 = lane % 4;
  const size_t out_row = (size_t)b * p.Tk + k0 + c * ROWS;
  float dk[DH / 2], dv[DH / 2];
  zero(dk);
  zero(dv);
  if (c < n_work) {
    const int ka = k0 + c * ROWS + (lt / 32) * 16 + lane / 4;  // keys ka, +8
    float kb[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      kb[hh] = p.valid[(size_t)b * p.Tk + ka + 8 * hh] ? 0.0f : NEG;
    const int wg_qt = sk.on && p.causal ? (k0 + c * ROWS) / ROWS : 0;
    const uint32_t ks = base + c * L::TILE, vs = base + (2 + c) * L::TILE;
    const float scale = p.scale;
    sm90::mbar_wait(sm90::smem_u32(&fixed), 0);
    float st[32], dpt[32];
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % STAGES, qt = qt0 + i;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / STAGES) & 1);
      if (qt < wg_qt) {  // before this warpgroup's diagonal: all zeros
        release(&empty[s], lane);
        continue;
      }
      const uint32_t qs = ring + s * L::STAGE, dos = qs + L::TILE;
      two_products<DH>(st, dpt, ks, qs, vs, dos);
      const float* sd = side_g + s * (L::SIDE / 4);
      uint32_t ap[16], as[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 m2 = *reinterpret_cast<const float2*>(sd + col);
        const float2 il2 = *reinterpret_cast<const float2*>(sd + ROWS + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sd + 2 * ROWS + col);
        const float mq[2] = {m2.x * LOG2E, m2.y * LOG2E};
        const float ilq[2] = {il2.x, il2.y}, dq2[2] = {d2.x, d2.y};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const int q = qt * ROWS + col + e;
            const float cm = (p.causal && ka + 8 * hh > q) ? NEG : 0.0f;
            const float lg = st[x] * scale + (cm + kb[hh]);
            pr[e] = exp2f(fmaf(lg, LOG2E, -mq[e])) * ilq[e];
            ds[e] = pr[e] * (dpt[x] - dq2[e]) * scale;
          }
          ap[2 * j + hh] = pack_bf16(pr[0], pr[1]);
          as[2 * j + hh] = pack_bf16(ds[0], ds[1]);
        }
      }
      sm90::fence_acc(dv);
      sm90::fence_acc(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        wgmma_rs<DH>(dv, ap + 4 * kk, desc_mn<DH>(dos, kk));
        wgmma_rs<DH>(dk, as + 4 * kk, desc_mn<DH>(qs, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dv);
      sm90::fence_acc(dk);
      sm90::fence_regs(ap);
      sm90::fence_regs(as);
      release(&empty[s], lane);
    }
  }
  store_rows<DH>(p.dk + out_row * p.lddkv, p.lddkv, h * DH, dk, lt);
  store_rows<DH>(p.dv + out_row * p.lddkv, p.lddkv, h * DH, dv, lt);
}

template <int DH>
int launch_sm90(const Operands& p, cudaStream_t s) {
  using L = Smem<DH>;
  const int e = p.H * DH;
  CUtensorMap mq, mk, mv, mo;
  int rc = sm90::tensor_map(&mq, p.q, p.B * p.Tq, e, ROWS, p.ldq, DH);
  if (rc == 0) rc = sm90::tensor_map(&mk, p.k, p.B * p.Tk, e, ROWS, p.ldkv, DH);
  if (rc == 0) rc = sm90::tensor_map(&mv, p.v, p.B * p.Tk, e, ROWS, p.ldkv, DH);
  if (rc == 0) rc = sm90::tensor_map(&mo, p.d_o, p.B * p.Tq, e, ROWS, p.ldo, DH);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dkv_sm90<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = 2 * ROWS;
  attn_bwd_dq_sm90<DH><<<dim3((p.Tq + blocks - 1) / blocks, p.H, p.B),
                         SM90_THREADS, L::BYTES, s>>>(mq, mk, mv, mo, p);
  attn_bwd_dkv_sm90<DH><<<dim3((p.Tk + blocks - 1) / blocks, p.H, p.B),
                          SM90_THREADS, L::BYTES, s>>>(mq, mk, mv, mo, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, d_o, dq: rows B*Tq with strides ldq, ldo, lddq; k, v: rows B*Tk with
// stride ldkv; dk, dv: rows B*Tk with stride lddkv; valid (B, Tk) uint8; stats
// (3, B, H, Tq) fp32 scratch. Requires Dh == 64 or Dh == 32, Tq % 64 == 0,
// Tk % 64 == 0, every stride a multiple of 8; wmma 0 (the Hopper kernels):
// q, k, v, d_o 16-byte aligned (TMA); wmma 1: the pre-Hopper kernels.
extern "C" int acai_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* d_o, const void* valid, void* dq,
                                  void* dk, void* dv, void* stats, int B,
                                  int Tq, int Tk, int H, int dh, int ldq,
                                  int ldkv, int ldo, int lddq, int lddkv,
                                  float scale, int causal, int wmma,
                                  void* stream) {
  if ((dh != 64 && dh != 32) || Tq % TILE != 0 || Tk % TILE != 0 ||
      ldq % 8 != 0 || ldkv % 8 != 0 || ldo % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Operands p{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<const __nv_bfloat16*>(d_o),
                   static_cast<const uint8_t*>(valid),
                   static_cast<__nv_bfloat16*>(dq),
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv),
                   static_cast<float*>(stats),
                   B, H, Tq, Tk, ldq, ldkv, ldo, lddq, lddkv, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wmma) return dh == 32 ? launch_wmma<32>(p, s) : launch_wmma<64>(p, s);
  return dh == 32 ? launch_sm90<32>(p, s) : launch_sm90<64>(p, s);
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("attention_bwd", "sm90_dh64", attn_bwd_dq_sm90<64>,
                SM90_THREADS, Smem<64>::BYTES),
    ACAI_KERNEL("attention_bwd", "sm90_dh64", attn_bwd_dkv_sm90<64>,
                SM90_THREADS, Smem<64>::BYTES),
    ACAI_KERNEL("attention_bwd", "sm90_dh32", attn_bwd_dq_sm90<32>,
                SM90_THREADS, Smem<32>::BYTES),
    ACAI_KERNEL("attention_bwd", "sm90_dh32", attn_bwd_dkv_sm90<32>,
                SM90_THREADS, Smem<32>::BYTES),
    ACAI_KERNEL("attention_bwd", "wmma_dh64", attn_bwd_dq<64>, THREADS, Dims<64>::DQ_SMEM),
    ACAI_KERNEL("attention_bwd", "wmma_dh64", attn_bwd_dkv<64>, THREADS, Dims<64>::DKV_SMEM),
    ACAI_KERNEL("attention_bwd", "wmma_dh32", attn_bwd_dq<32>, THREADS, Dims<32>::DQ_SMEM),
    ACAI_KERNEL("attention_bwd", "wmma_dh32", attn_bwd_dkv<32>, THREADS, Dims<32>::DKV_SMEM),
};
ACAI_EXPORT_RESOURCES(kResources)
