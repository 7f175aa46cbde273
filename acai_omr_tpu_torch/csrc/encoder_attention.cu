// K3 encoder_attention: bidirectional multi-head attention of the ViT encoder
// stack, masked by key validity, without materialising (B, H, T, T).
//
// Replaces: the per-(image, head) `_attend` loop of ops/pallas_train_layer.py
// `_fwd_kernel` (cross=False, save=False) in the JAX package.
//
// Input qkv (B*T, 3E) bf16: head h's q, k, v at columns h*Dh, E + h*Dh,
// 2E + h*Dh. valid (B, T) uint8 (1 = real patch). Output (B*T, E) bf16.
//
// Numerics follow the JAX kernel: logits = q.k * scale + bias (bias 0 for a
// valid key, -1e9 for padding) in fp32, p = exp(logit - max) / sum normalised
// in fp32 FIRST and only then rounded to bf16 for the PV product, fp32
// accumulation. Because p must be normalised before it is rounded, the kernel
// makes two passes over the key tiles: the first keeps the online softmax
// statistics (running max and rescaled sum) per query row, the second
// recomputes the logits tile by tile, forms the normalised p in bf16 and
// accumulates p @ V in tensor-core fragments. The (T, T) scores exist only one
// 64x64 tile at a time in shared memory.
//
// Bound on an H100: tensor-core flops (4 * B * H * T^2 * Dh for QK^T and PV,
// plus the second QK^T this design recomputes) at 989 TFLOP/s bf16; the bytes
// (qkv in, out) are small beside them at T = 1024. Design: one block per
// (64-query tile, head, image), four warps of 16 query rows each, wmma
// 16x16x16 bf16 tiles; K and V tiles share one shared-memory buffer. No
// pipelining of the tile loads yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int DH = 64;
constexpr int QT = 64;
constexpr int KT = 64;
constexpr int THREADS = 128;
constexpr int H_LD = DH + 8;  // bf16 tiles (Q, K/V, P)
constexpr int S_LD = KT + 4;  // fp32 score tile

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

// rows x 64 bf16 tile from global (row stride ld_g elements) into shared.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld_g,
                                          int tid) {
#pragma unroll
  for (int v = tid; v < 64 * DH / 8; v += THREADS) {
    const int r = v / (DH / 8);
    const int c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * H_LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld_g + c);
  }
}

__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const uint8_t* __restrict__ valid,
                         __nv_bfloat16* __restrict__ out, int T, int E,
                         float scale) {
  __shared__ __align__(128) __nv_bfloat16 Qs[QT * H_LD];
  __shared__ __align__(128) __nv_bfloat16 KVs[KT * H_LD];
  __shared__ __align__(128) float Ss[QT * S_LD];
  __shared__ __align__(128) __nv_bfloat16 Ps[QT * H_LD];
  __shared__ float kbias[KT];

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t ld = (size_t)3 * E;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld;
  const int row0 = warp * 16;

  load_tile(Qs, base + (size_t)q0 * ld + h * DH, ld, tid);

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.0f;
  }

  // S = Q_w K^T for this warp's 16 rows, scaled and biased, into Ss.
  auto scores = [&]() {
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
      srow[lane] = srow[lane] * scale + kbias[lane];
      srow[lane + 32] = srow[lane + 32] * scale + kbias[lane + 32];
    }
    __syncwarp();
  };

  auto load_keys = [&](int k0) {
    load_tile(KVs, base + (size_t)k0 * ld + E + h * DH, ld, tid);
    if (tid < KT) kbias[tid] = valid[(size_t)b * T + k0 + tid] ? 0.0f : -1e9f;
  };

  // pass 1: softmax statistics per query row
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores();
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

  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      __nv_bfloat16* prow = Ps + (row0 + r) * H_LD;
      prow[lane] = __float2bfloat16(expf(srow[lane] - m_run[r]) * inv_l[r]);
      prow[lane + 32] =
          __float2bfloat16(expf(srow[lane + 32] - m_run[r]) * inv_l[r]);
    }
    __syncthreads();  // every warp is done reading K from KVs
    load_tile(KVs, base + (size_t)k0 * ld + 2 * E + h * DH, ld, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + row0 * H_LD + kk * 16, H_LD);
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
        out + ((size_t)b * T + q0 + row0 + r) * E + h * DH;
    orow[lane] = __float2bfloat16(srow[lane]);
    orow[lane + 32] = __float2bfloat16(srow[lane + 32]);
  }
}

}  // namespace

// qkv: (B*T, 3E) bf16; valid: (B, T) uint8; out: (B*T, E) bf16.
// Requires Dh == 64 and T % 64 == 0.
extern "C" int acai_encoder_attention(const void* qkv, const void* valid,
                                      void* out, int B, int T, int H, int dh,
                                      float scale, void* stream) {
  if (dh != DH || T % QT != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(T / QT, H, B);
  encoder_attention_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out), T,
      H * DH, scale);
  return (int)cudaGetLastError();
}
