// K1 linear_bias_act: out = act(A @ W + bias), bf16 in, fp32 accumulate, bf16 out.
//
// Replaces: the qkv / out / cross-q / cross-out / ff1 / ff2 products inside the
// two Pallas bodies of the JAX package: ops/pallas_monolith.py `_kernel` (the
// `mat(...)` dots, bf16 mode) and ops/pallas_train_layer.py `_fwd_kernel`
// (`_dot(x, wqkv)`, `_dot(a_s, wo)`, the F-chunked ff1/ff2 dots).
//
// Layout: A (M, K) row-major, W (K, N) row-major (the JAX (in, out) kernel
// layout), bias (N,) fp32, out (M, N). K % 32 == 0, N % 64 == 0, any M.
//
// Bound on an H100: the encoder products (M = B*T, thousands of rows) are
// tensor-core bound (2MNK flops at 989 TFLOP/s bf16); the decode products
// (M = B <= 32) read the whole weight matrix for a handful of rows and are
// bound by the weight bytes at 3.35 TB/s. Design: one 64x64 output tile per
// block, four warps of 2x2 wmma 16x16x16 bf16 tiles, the K loop staged through
// shared memory with 16-byte loads. For skinny M the wrapper splits K across
// blockIdx.z so enough blocks stream the weights; each split writes an fp32
// partial and a second launch sums them in a fixed order (deterministic) and
// applies the epilogue. No cp.async/TMA pipelining and no wgmma yet.
//
// Epilogue act: 0 = none; 1 = exact-erf GELU on the fp32 sum (the encoder
// kernel's ff1); 2 = round the sum to bf16, then GELU (the decode monolith
// casts ff1 to the compute dtype before its GELU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float epilogue(float acc, float b, int act) {
  float u = acc + b;
  if (act == 1) return gelu_erf(u);
  if (act == 2) return gelu_erf(__bfloat162float(__float2bfloat16(u)));
  return u;
}

__global__ void __launch_bounds__(THREADS)
linear_kernel(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ W,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              float* __restrict__ partial, int M, int N, int K, int k_chunk,
              int act) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * A_LD + c) = val;
    }
#pragma unroll
    for (int v = tid; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * B_LD + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int m = m0 + r;
    if (m >= M) continue;
    const float v = Cs[r * C_LD + c];
    const size_t o = (size_t)m * N + n0 + c;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * M * N + o] = v;
    else
      out[o] = __float2bfloat16(epilogue(v, bias[n0 + c], act));
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, int splits,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int M, int N,
                              int act) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = __float2bfloat16(epilogue(s, bias[i % N], act));
}

}  // namespace

// splits == 1: one launch, epilogue in place. splits > 1: `partial` holds
// (splits, M, N) fp32 scratch; each z-slice covers k_chunk of K.
extern "C" int acai_linear_bias_act(const void* a, const void* w,
                                    const void* bias, void* out, void* partial,
                                    int M, int N, int K, int k_chunk,
                                    int splits, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  linear_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), part, M,
      N, K, k_chunk, act);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int blocks = (int)((total + 255) / 256);
    reduce_kernel<<<blocks, 256, 0, s>>>(part, splits,
                                         static_cast<const float*>(bias),
                                         static_cast<__nv_bfloat16*>(out), M, N,
                                         act);
  }
  return (int)cudaGetLastError();
}
