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
// dS = P * (dP - rowsum(dP * P)) scaled by 1/sqrt(Dh) and rounded to bf16,
// dQ = dS K, dK = dS^T Q, each from an fp32 accumulator rounded once.
//
// Bound on an H100: tensor-core flops (five Tq x Tk x Dh products per head
// are needed; this design recomputes QK^T twice and dO V^T once more, nine in
// all) at 989 TFLOP/s bf16. Design: two launches and no atomics, so two runs
// give equal bits.
//   1. attn_bwd_dq: one block per (64-query tile, head, image). Three passes
//      over the key tiles: softmax statistics (max, sum); D = rowsum(dP * P);
//      dS and the dQ accumulation. Writes dQ and the row statistics
//      (max, 1/sum, D) for the second launch.
//   2. attn_bwd_dkv: one block per (64-key tile, head, image) loops over the
//      query tiles, recomputes P and dS from the statistics and accumulates
//      dV += P^T dO and dK += dS^T Q in fragments.
// Four warps, wmma 16x16x16 bf16 tiles, dynamic shared memory above 48 KB.
// The head dim is a template parameter, 64 or 32 (the MAE decoder): each head
// is its own Dh-wide tile product, as in K3; the TPU kernel's pairing of two
// 32-wide heads under 0/1 lane masks has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

#include "func_attrs.cuh"

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
int launch(const Operands& p, cudaStream_t s) {
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

}  // namespace

// q, d_o, dq: rows B*Tq with strides ldq, ldo, lddq; k, v: rows B*Tk with
// stride ldkv; dk, dv: rows B*Tk with stride lddkv; valid (B, Tk) uint8; stats
// (3, B, H, Tq) fp32 scratch. Requires Dh == 64 or Dh == 32, Tq % 64 == 0,
// Tk % 64 == 0, every stride a multiple of 8.
extern "C" int acai_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* d_o, const void* valid, void* dq,
                                  void* dk, void* dv, void* stats, int B,
                                  int Tq, int Tk, int H, int dh, int ldq,
                                  int ldkv, int ldo, int lddq, int lddkv,
                                  float scale, int causal, void* stream) {
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
  return dh == 32 ? launch<32>(p, s) : launch<64>(p, s);
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("attention_bwd", "dh64", attn_bwd_dq<64>, THREADS, Dims<64>::DQ_SMEM),
    ACAI_KERNEL("attention_bwd", "dh64", attn_bwd_dkv<64>, THREADS, Dims<64>::DKV_SMEM),
    ACAI_KERNEL("attention_bwd", "dh32", attn_bwd_dq<32>, THREADS, Dims<32>::DQ_SMEM),
    ACAI_KERNEL("attention_bwd", "dh32", attn_bwd_dkv<32>, THREADS, Dims<32>::DKV_SMEM),
};
ACAI_EXPORT_RESOURCES(kResources)
