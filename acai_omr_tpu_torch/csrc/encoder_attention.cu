// K3 encoder_attention: the multi-head attention forward of both training
// stacks, masked by key validity and optionally causal, without materialising
// (B, H, Tq, Tk).
//
// Replaces: the per-(image, head) `_attend` loops of ops/pallas_train_layer.py
// `_fwd_kernel` in the JAX package: the encoder's bidirectional self-attention
// (cross=False), the decoder's causal self-attention and its cross-attention
// over the precomputed `mem_kv` (cross=True).
//
// Operands: q rows (B*Tq) with row stride ldq, k and v rows (B*Tk) with row
// stride ldkv, head h at columns h*Dh of each; valid (B, Tk) uint8 (1 = real
// key). Self-attention passes three views of one (B*T, 3E) qkv buffer
// (ldq = ldkv = 3E); cross-attention passes qc (ld E) and the two halves of
// mem_kv[l] (B, M, 2E) (ld 2E). Output (B*Tq, E) bf16.
//
// Numerics follow the JAX kernel: logits = q.k * scale + bias in fp32, where
// bias is ADDITIVE: -1e9 for a padded key plus -1e9 for a key after the query
// when causal (not -inf: a query row with no valid key gets the uniform
// distribution, not NaN). p = exp(logit - max) / sum is normalised in fp32
// FIRST and only then rounded to bf16 for the PV product, fp32 accumulation.
// Because p must be normalised before it is rounded, the kernel makes two
// passes over the key tiles: the first keeps the online softmax statistics
// (running max and rescaled sum) per query row, the second recomputes the
// logits tile by tile, forms the normalised p in bf16 and accumulates p @ V in
// tensor-core fragments. The scores exist only one 64x64 tile at a time in
// shared memory. The head dim is a template parameter, 64 (the ViT encoder and
// the seq2seq decoder) or 32 (the MAE decoder's 16 heads of a 512-wide layer):
// each head is a tile product of its own Dh columns, so a head of 32 does half
// the work of a head of 64 (the TPU kernel pairs two such heads in one 64-lane
// group with the other head's lanes zeroed, `_group_spec` / `_head_col_mask`,
// because it cannot slice below 64 lanes; nothing of that is needed here). Causal runs visit every key tile too: with the additive mask
// a fully padded row spreads over the keys after it as well, and skipping
// tiles would change that.
//
// Bound on an H100: tensor-core flops (4 * B * H * Tq * Tk * Dh for QK^T and
// PV, plus the second QK^T this design recomputes) at 989 TFLOP/s bf16; the
// bytes are small beside them at T = 1024 (at Dh = 32 and T = 512, the MAE
// decoder, reading q, k, v and writing the output once is the larger of the
// two). Design: one block per (64-query
// tile, head, image), four warps of 16 query rows each, wmma 16x16x16 bf16
// tiles; K and V tiles share one shared-memory buffer. No pipelining of the
// tile loads yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

#include "func_attrs.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 64;
constexpr int KT = 64;
constexpr int THREADS = 128;
constexpr int P_LD = KT + 8;  // bf16 probability tile
constexpr int S_LD = KT + 4;  // fp32 score tile
constexpr float NEG = -1e9f;

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

// 64 x DH bf16 tile from global (row stride ld_g elements) into shared (row
// stride DH + 8).
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld_g,
                                          int tid) {
#pragma unroll
  for (int v = tid; v < 64 * DH / 8; v += THREADS) {
    const int r = v / (DH / 8);
    const int c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld_g + c);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ valid,
                         __nv_bfloat16* __restrict__ out, int Tq, int Tk,
                         int E, int ldq, int ldkv, float scale, int causal) {
  constexpr int H_LD = DH + 8;  // bf16 tiles of Q and K/V
  __shared__ __align__(128) __nv_bfloat16 Qs[QT * H_LD];
  __shared__ __align__(128) __nv_bfloat16 KVs[KT * H_LD];
  __shared__ __align__(128) float Ss[QT * S_LD];
  __shared__ __align__(128) __nv_bfloat16 Ps[QT * P_LD];
  __shared__ float kbias[KT];

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const __nv_bfloat16* qb = q + (size_t)b * Tq * ldq + h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * ldkv + h * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * ldkv + h * DH;
  const int row0 = warp * 16;

  load_tile<DH>(Qs, qb + (size_t)q0 * ldq, ldq, tid);

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.0f;
  }

  // S = Q_w K^T for this warp's 16 rows, scaled and biased, into Ss.
  auto scores = [&](int k0) {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + row0 * H_LD + kk * 16, H_LD);
        wmma::load_matrix_sync(bk, KVs + (j * 16) * H_LD + kk * 16, H_LD);
        wmma::mma_sync(s, a, bk, s);
      }
      wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16, s, S_LD,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float* srow = Ss + (row0 + r) * S_LD;
      const int qi = q0 + row0 + r;
      const float c0 = (causal && k0 + lane > qi) ? NEG : 0.0f;
      const float c1 = (causal && k0 + lane + 32 > qi) ? NEG : 0.0f;
      srow[lane] = srow[lane] * scale + (c0 + kbias[lane]);
      srow[lane + 32] = srow[lane + 32] * scale + (c1 + kbias[lane + 32]);
    }
    __syncwarp();
  };

  auto load_keys = [&](int k0) {
    load_tile<DH>(KVs, kb + (size_t)k0 * ldkv, ldkv, tid);
    if (tid < KT) kbias[tid] = valid[(size_t)b * Tk + k0 + tid] ? 0.0f : NEG;
  };

  // pass 1: softmax statistics per query row
  for (int k0 = 0; k0 < Tk; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + e;
      m_run[r] = m_new;
    }
  }

  // pass 2: normalised bf16 probabilities times V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  float inv_l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) inv_l[r] = 1.0f / l_run[r];

  for (int k0 = 0; k0 < Tk; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      __nv_bfloat16* prow = Ps + (row0 + r) * P_LD;
      prow[lane] = __float2bfloat16(expf(srow[lane] - m_run[r]) * inv_l[r]);
      prow[lane + 32] =
          __float2bfloat16(expf(srow[lane + 32] - m_run[r]) * inv_l[r]);
    }
    __syncthreads();  // every warp is done reading K from KVs
    load_tile<DH>(KVs, vb + (size_t)k0 * ldkv, ldkv, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + row0 * P_LD + kk * 16, P_LD);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, KVs + (kk * 16) * H_LD + j * 16, H_LD);
        wmma::mma_sync(o[j], a, bv, o[j]);
      }
    }
  }

  // out tile through the (now free) score buffer
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16, o[j], S_LD,
                            wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float* srow = Ss + (row0 + r) * S_LD;
    __nv_bfloat16* orow =
        out + ((size_t)b * Tq + q0 + row0 + r) * E + h * DH;
#pragma unroll
    for (int c = lane; c < DH; c += 32) orow[c] = __float2bfloat16(srow[c]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int Tq, int Tk, int H, int ldq, int ldkv,
           float scale, int causal, cudaStream_t s) {
  dim3 grid(Tq / QT, H, B);
  encoder_attention_kernel<DH><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), Tq, Tk, H * DH, ldq, ldkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: rows B*Tq, stride ldq; k, v: rows B*Tk, stride ldkv; valid: (B, Tk)
// uint8; out: (B*Tq, E) bf16. Requires Dh == 64 or Dh == 32, Tq % 64 == 0,
// Tk % 64 == 0 and strides that keep 16-byte loads aligned (multiples of 8).
extern "C" int acai_encoder_attention(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, int B, int Tq, int Tk, int H,
                                      int dh, int ldq, int ldkv, float scale,
                                      int causal, void* stream) {
  if ((dh != 64 && dh != 32) || Tq % QT != 0 || Tk % KT != 0 || ldq % 8 != 0 ||
      ldkv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 32)
    return launch<32>(q, k, v, valid, out, B, Tq, Tk, H, ldq, ldkv, scale,
                      causal, s);
  return launch<64>(q, k, v, valid, out, B, Tq, Tk, H, ldq, ldkv, scale,
                    causal, s);
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("encoder_attention", "dh64", encoder_attention_kernel<64>, THREADS, 0),
    ACAI_KERNEL("encoder_attention", "dh32", encoder_attention_kernel<32>, THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
