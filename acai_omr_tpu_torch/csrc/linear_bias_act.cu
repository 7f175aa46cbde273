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
// casts ff1 to the compute dtype before its GELU); 3 = the fp32 partial of a
// tensor-parallel row-parallel product: the bare fp32 sum written to an fp32
// `out`, no bias (may be null), no activation, no dropout (the bias comes
// after K15 tp_allreduce sums the ranks' partials).
//
// Training epilogues (`_fwd_kernel` with save=True and dropout on): with act 1
// and `gp` given, the kernel also writes GELU'(u) = 0.5 (1 + erf(u / sqrt 2))
// + u phi(u) from the same fp32 u, rounded (the backward's saved `gelu'`).
// With a DropSpec whose thresh is not 0, dropout (dropout.cuh) acts on the
// output after the bias, the activation and the rounding: the stacks' sites
// 0, 1, 3 (`sa`, `ca`, `ff`) and site 2 (`h1`). The epilogue works on four
// neighbouring columns at a time, one Philox call each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "dropout.cuh"
#include "func_attrs.cuh"

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

__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * expf(-0.5f * u * u) * 0.3989422804014327f;
}

struct Epilogue {
  const float* bias;
  __nv_bfloat16* out;
  __nv_bfloat16* gp;  // GELU' out, or nullptr
  int act;
  int N;
  DropSpec drop;
  float* out32;  // act 3: the fp32 sum goes here, nothing else is written
};

// Four neighbouring outputs (m, n .. n + 3) from their fp32 sums.
__device__ __forceinline__ void epilogue4(const Epilogue& e, const float acc[4],
                                          int m, int n) {
  if (e.out32 != nullptr) {
    *reinterpret_cast<float4*>(e.out32 + (size_t)m * e.N + n) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  float v[4], g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float u = acc[j] + e.bias[n + j];
    if (e.act == 1) {
      v[j] = gelu_erf(u);
      g[j] = gelu_grad(u);
    } else if (e.act == 2) {
      v[j] = gelu_erf(round_bf16(u));
    } else {
      v[j] = u;
    }
    v[j] = round_bf16(v[j]);
  }
  drop4(e.drop, m, n, v);
  const size_t o = (size_t)m * e.N + n;
  store4_bf16(e.out + o, v);
  if (e.gp != nullptr) store4_bf16(e.gp + o, g);
}

__global__ void __launch_bounds__(THREADS)
linear_kernel(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ W, Epilogue epi,
              float* __restrict__ partial, int M, int N, int K, int k_chunk) {
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

  for (int e = tid; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    const float4 v = *reinterpret_cast<const float4*>(Cs + r * C_LD + c);
    if (partial != nullptr) {
      *reinterpret_cast<float4*>(partial + (size_t)blockIdx.z * M * N +
                                 (size_t)m * N + n0 + c) = v;
    } else {
      const float acc[4] = {v.x, v.y, v.z, v.w};
      epilogue4(epi, acc, m, n0 + c);
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, int splits,
                              Epilogue epi, int M, int N) {
  const size_t total4 = (size_t)M * N / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int z = 0; z < splits; ++z) {
    const float4 v =
        *reinterpret_cast<const float4*>(partial + ((size_t)z * M * N + i * 4));
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  epilogue4(epi, acc, (int)(i * 4 / N), (int)(i * 4 % N));
}

}  // namespace

// splits == 1: one launch, epilogue in place. splits > 1: `partial` holds
// (splits, M, N) fp32 scratch; each z-slice covers k_chunk of K. `gp` may be
// null; drop_thresh == 0 switches dropout off (drop_t = rows per image).
// act == 3: `out` is (M, N) fp32 and `bias` may be null.
extern "C" int acai_linear_bias_act(const void* a, const void* w,
                                    const void* bias, void* out, void* gp,
                                    void* partial, int M, int N, int K,
                                    int k_chunk, int splits, int act,
                                    unsigned drop_thresh, float drop_scale,
                                    unsigned seed0, unsigned seed1,
                                    unsigned drop_stream, int drop_t,
                                    void* stream) {
  if (drop_thresh != 0u && drop_t <= 0) return (int)cudaErrorInvalidValue;
  if (act == 3 && (gp != nullptr || drop_thresh != 0u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const bool f32 = act == 3;
  const Epilogue epi{static_cast<const float*>(bias),
                     f32 ? nullptr : static_cast<__nv_bfloat16*>(out),
                     static_cast<__nv_bfloat16*>(gp), act, N,
                     DropSpec{drop_thresh, drop_scale, seed0, seed1,
                              drop_stream, drop_t > 0 ? drop_t : 1},
                     f32 ? static_cast<float*>(out) : nullptr};
  linear_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      epi, part, M, N, K, k_chunk);
  if (splits > 1) {
    const size_t total4 = (size_t)M * N / 4;
    const int blocks = (int)((total4 + 255) / 256);
    reduce_kernel<<<blocks, 256, 0, s>>>(part, splits, epi, M, N);
  }
  return (int)cudaGetLastError();
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("linear_bias_act", "", linear_kernel, THREADS, 0),
    ACAI_KERNEL("linear_bias_act", "", reduce_kernel, 256, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
