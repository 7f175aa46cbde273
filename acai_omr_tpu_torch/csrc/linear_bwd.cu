// K9 linear_bwd: the two backward products of y = x W + b, one source, two
// entry points.
//
//   dgrad: dX (M, K) = dY (M, N) W^T, W (K, N) row-major, fp32 accumulate,
//          rounded to bf16; then, as the caller asks: the forward's dropout
//          mask on it (site 2: `dh1`), a product with a saved bf16 tensor
//          rounded again (`du = round(dh1 * gelu')`), a bf16 sum with a
//          residual gradient (`dx2 = dz3 + round(.)`).
//   wgrad: dW (K, N) = X^T (K, R) dY (R, N) with an fp32 accumulator over ALL
//          rows, rounded to bf16 once, and db (N,) = colsum(dY) in fp32.
//
// Replaces: the `_dot_bt` products (dgrad) and the `_dot_tb` / `_acc` weight
// gradient folds with their bias sums (wgrad) of ops/pallas_train_layer.py
// `_bwd_kernel` in the JAX package. The TPU kernel keeps bf16 weight-gradient
// accumulators and adds one rounded partial per batch tile; here the sum over
// all rows stays fp32 and is rounded once (more accurate, and free of the
// tiling).
//
// Bound on an H100: tensor-core flops (2 M N K each) at 989 TFLOP/s bf16 at
// the training shapes (thousands of rows).
//
// Both run on the Hopper GEMM core (sm90_gemm.cuh): TMA into a
// shared-memory ring, wgmma from two consumer warpgroups, a producer warp,
// 128 x BN output tiles.
//
// wgrad: A = X^T and B = dY both MN-major (the descriptors' transpose bits:
// the transposed operand is read at the full rate, never transposed in
// memory). It contracts over the rows: when the output tiles alone are too
// few to fill the card's 132 SMs the wrapper's plan
// (ops/linear_bwd_kernel.py `row_split_plan`) splits the rows across
// blockIdx.z, each split writes an fp32 partial and a second launch sums them
// in a fixed order and rounds once. The bias sum is two small launches (slabs
// of 256 rows, then the slabs), fixed order, no atomics.
//
// dgrad: A = dY K-major, B = W^T read from W (K_out, N) as a K-major operand
// (boxes of BN rows of W by 64 contraction columns), BN from the wrapper's
// `dgrad_plan`. The contraction is never split: the epilogue (round, K10's
// mask keyed by row and output column, `* mul` rounded, `+ add`) runs on the
// whole fp32 sum, so its bits do not depend on the tiling and equal the
// pre-Hopper kernel's and the twin's mask for mask. Shape rule: TMA's
// (K_out and N multiples of 8, dY and W 16-byte aligned).
//
// The pre-Hopper kernels of both (one 64x64 output tile per block, four warps
// of 2x2 wmma 16x16x16 bf16 tiles, the contraction staged through shared
// memory in slabs of 32 with 16-byte loads, the transposed operand through a
// col-major fragment) stay as the core's yardsticks, launched only when the
// wrapper is asked for them (bn 64: `variant="wmma"`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "dropout.cuh"
#include "func_attrs.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int K_LD = BK + 8;  // tiles whose rows run along the contraction
constexpr int N_LD = BN + 8;  // tiles whose rows hold 64 output columns
constexpr int C_LD = BN + 4;
constexpr int SLAB = 256;
constexpr int CX = 32, CY = 8;

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void stage_out(float* Cs, FragC acc[2][2], int wm,
                                          int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
}

// dX tile (rows m0.., cols c0.. of K) = dY (M, N) W^T.
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const __nv_bfloat16* __restrict__ dY,
             const __nv_bfloat16* __restrict__ W,
             const __nv_bfloat16* __restrict__ mul,
             const __nv_bfloat16* __restrict__ add,
             __nv_bfloat16* __restrict__ out, int M, int N, int K,
             DropSpec drop) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * K_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * K_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(dY + (size_t)(m0 + r) * N + n0 + c);
      *reinterpret_cast<uint4*>(As + r * K_LD + c) = val;
      // W rows c0 .. c0 + 63 (output columns), contraction columns n0 ..
      *reinterpret_cast<uint4*>(Bs + r * K_LD + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(c0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * K_LD + kk, K_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * K_LD + kk, K_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  stage_out(Cs, acc, wm, wn);
  for (int e = tid; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    const float4 raw = *reinterpret_cast<const float4*>(Cs + r * C_LD + c);
    float v[4] = {round_bf16(raw.x), round_bf16(raw.y), round_bf16(raw.z),
                  round_bf16(raw.w)};
    drop4(drop, m, c0 + c, v);
    const size_t o = (size_t)m * K + c0 + c;
    if (mul != nullptr) {
      float f[4];
      load4_bf16(mul + o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = round_bf16(v[j] * f[j]);
    }
    if (add != nullptr) {
      float f[4];
      load4_bf16(add + o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += f[j];
    }
    store4_bf16(out + o, v);
  }
}

// The pre-Hopper wgrad (bn 64, kept as the yardstick of the core): dW tile
// (rows k0.. of K, cols n0.. of N) = X^T dY over rows
// [z * r_chunk, (z + 1) * r_chunk), 64x64 tiles of wmma, X^T through
// col-major fragments.
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __nv_bfloat16* __restrict__ X,
             const __nv_bfloat16* __restrict__ dY,
             __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
             int R, int K, int N, int r_chunk) {
  __shared__ __align__(128) __nv_bfloat16 As[BK * N_LD];  // X rows x 64 k-cols
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * N_LD];  // dY rows x 64 n-cols
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * r_chunk;
  const int r_end = min(R, r_begin + r_chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int v = tid; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * N_LD + c) =
          *reinterpret_cast<const uint4*>(X + (size_t)(r0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(Bs + r * N_LD + c) =
          *reinterpret_cast<const uint4*>(dY + (size_t)(r0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = X^T: element (i = k column, j = row) at As[(kk + j) * N_LD + i]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * N_LD + wm + 16 * i, N_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * N_LD + wn + 16 * j, N_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  stage_out(Cs, acc, wm, wn);
  for (int e = tid; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    const float4 raw = *reinterpret_cast<const float4*>(Cs + r * C_LD + c);
    const size_t o = (size_t)(k0 + r) * N + n0 + c;
    if (partial != nullptr) {
      *reinterpret_cast<float4*>(partial + (size_t)blockIdx.z * K * N + o) = raw;
    } else {
      const float v[4] = {raw.x, raw.y, raw.z, raw.w};
      store4_bf16(out + o, v);
    }
  }
}

// The epilogue of the core: dW rounded to bf16 (one range of rows), or the
// fp32 partial of row split blockIdx.z.
struct WgradEpilogue {
  __nv_bfloat16* out;
  float* partial;
  int K, N;
  __device__ __forceinline__ void operator()(const float v[4], int m,
                                             int n) const {
    const size_t o = (size_t)m * N + n;
    if (partial != nullptr)
      *reinterpret_cast<float4*>(partial + (size_t)blockIdx.z * K * N + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
      store4_bf16(out + o, v);
  }
};

__global__ void wgrad_reduce(const float* __restrict__ partial, int splits,
                             __nv_bfloat16* __restrict__ out, size_t total4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int z = 0; z < splits; ++z) {
    const float4 v =
        *reinterpret_cast<const float4*>(partial + ((size_t)z * total4 + i) * 4);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  store4_bf16(out + i * 4, acc);
}

// partial[(slab, col)] = sum of dY over the slab's rows.
__global__ void __launch_bounds__(CX * CY)
colsum_slabs(const __nv_bfloat16* __restrict__ dY, float* __restrict__ partial,
             int R, int N) {
  __shared__ float sh[CY][CX];
  const int tx = threadIdx.x % CX;
  const int ty = threadIdx.x / CX;
  const int col = blockIdx.x * CX + tx;
  const int r_end = min(R, (int)(blockIdx.y + 1) * SLAB);
  float a = 0.0f;
  if (col < N)
    for (int r = blockIdx.y * SLAB + ty; r < r_end; r += CY)
      a += __bfloat162float(dY[(size_t)r * N + col]);
  sh[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < N) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CY; ++i) s += sh[i][tx];
    partial[(size_t)blockIdx.y * N + col] = s;
  }
}

__global__ void colsum_final(const float* __restrict__ partial, int slabs,
                             float* __restrict__ db, int N) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  float s = 0.0f;
  for (int k = 0; k < slabs; ++k) s += partial[(size_t)k * N + col];
  db[col] = s;
}

// The epilogue of dgrad on the core: dX rounded to bf16, K10's mask keyed by
// (row, output column), then `* mul` rounded, then `+ add`; as dgrad_kernel.
struct DgradEpilogue {
  const __nv_bfloat16* mul;
  const __nv_bfloat16* add;
  __nv_bfloat16* out;
  int K;
  DropSpec drop;
  __device__ __forceinline__ void operator()(const float acc[4], int m,
                                             int c) const {
    float v[4] = {round_bf16(acc[0]), round_bf16(acc[1]), round_bf16(acc[2]),
                  round_bf16(acc[3])};
    drop4(drop, m, c, v);
    const size_t o = (size_t)m * K + c;
    if (mul != nullptr) {
      float f[4];
      load4_bf16(mul + o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = round_bf16(v[j] * f[j]);
    }
    if (add != nullptr) {
      float f[4];
      load4_bf16(add + o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += f[j];
    }
    store4_bf16(out + o, v);
  }
};

// dX (M, K) = dY (M, N) W^T on the Hopper core: dY and W both K-major.
int launch_dgrad_core(const void* dy, const void* w, const DgradEpilogue& epi,
                      int M, int N, int K, int bn, cudaStream_t s) {
  if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int rc = sm90::tensor_map(&ta, dy, M, N, sm90::box_rows(false, sm90::BM));
  if (rc == 0) rc = sm90::tensor_map(&tb, w, K, N, sm90::box_rows(false, bn));
  if (rc != 0) return rc;
  const int k_chunk = (N + sm90::BK - 1) / sm90::BK * sm90::BK;
  if (bn == 256)
    return sm90::launch<256, false, false>(ta, tb, M, K, N, k_chunk, 1, epi,
                                           s);
  if (bn == 128)
    return sm90::launch<128, false, false>(ta, tb, M, K, N, k_chunk, 1, epi,
                                           s);
  return (int)cudaErrorInvalidValue;
}

// dW (K, N) = X^T dY on the Hopper core: X and dY both MN-major.
int launch_core(const void* x, const void* dy, void* dw, float* part, int R,
                int K, int N, int r_chunk, int splits, int bn,
                cudaStream_t s) {
  if (K % 8 != 0 || N % 8 != 0 || r_chunk % sm90::BK != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int rc = sm90::tensor_map(&ta, x, R, K, sm90::box_rows(true, 0));
  if (rc == 0) rc = sm90::tensor_map(&tb, dy, R, N, sm90::box_rows(true, 0));
  if (rc != 0) return rc;
  const WgradEpilogue epi{static_cast<__nv_bfloat16*>(dw), part, K, N};
  if (bn == 256)
    return sm90::launch<256, true, true>(ta, tb, K, N, R, r_chunk, splits, epi,
                                         s);
  if (bn == 128)
    return sm90::launch<128, true, true>(ta, tb, K, N, R, r_chunk, splits, epi,
                                         s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dY (M, N), W (K, N), out (M, K) bf16; mul, add (M, K) bf16 or null.
// bn 128 or 256 (the Hopper core): K % 8 == 0, N % 8 == 0 (TMA's 16-byte
// row strides), dY and W 16-byte aligned. bn 64 (the wmma kernel):
// N % 32 == 0, K % 64 == 0.
extern "C" int acai_linear_dgrad(const void* dy, const void* w, const void* mul,
                                 const void* add, void* out, int M, int N,
                                 int K, int bn, unsigned drop_thresh,
                                 float drop_scale, unsigned seed0,
                                 unsigned seed1, unsigned drop_stream,
                                 int drop_t, void* stream) {
  if (drop_thresh != 0u && drop_t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d{drop_thresh, drop_scale, seed0, seed1, drop_stream,
                   drop_t > 0 ? drop_t : 1};
  if (bn != BN)
    return launch_dgrad_core(
        dy, w,
        DgradEpilogue{static_cast<const __nv_bfloat16*>(mul),
                      static_cast<const __nv_bfloat16*>(add),
                      static_cast<__nv_bfloat16*>(out), K, d},
        M, N, K, bn, s);
  if (N % BK != 0 || K % BN != 0) return (int)cudaErrorInvalidValue;
  dgrad_kernel<<<dim3(K / BN, (M + BM - 1) / BM), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(mul),
      static_cast<const __nv_bfloat16*>(add), static_cast<__nv_bfloat16*>(out),
      M, N, K, d);
  return (int)cudaGetLastError();
}

// X (R, K), dY (R, N) bf16 -> dW (K, N) bf16, db (N,) fp32. partial: (splits,
// K, N) fp32 scratch when splits > 1; db_partial: (ceil(R / 256), N) fp32
// scratch. bn 128 or 256 (the Hopper core): any R; r_chunk % 64 == 0;
// K % 8 == 0, N % 8 == 0 (TMA's 16-byte row strides), X and dY 16-byte
// aligned. bn 64 (the wmma kernel): R % 32 == 0, r_chunk % 32 == 0,
// K % 64 == 0, N % 64 == 0.
extern "C" int acai_linear_wgrad(const void* x, const void* dy, void* dw,
                                 void* db, void* partial, void* db_partial,
                                 int R, int K, int N, int r_chunk, int splits,
                                 int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  int rc = 0;
  if (bn == BN) {
    if (R % BK != 0 || r_chunk % BK != 0 || K % BM != 0 || N % BN != 0)
      return (int)cudaErrorInvalidValue;
    wgrad_kernel<<<dim3(N / BN, K / BM, splits), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dw),
        part, R, K, N, r_chunk);
    rc = (int)cudaGetLastError();
  } else {
    rc = launch_core(x, dy, dw, part, R, K, N, r_chunk, splits, bn, s);
  }
  if (rc != 0) return rc;
  if (splits > 1) {
    const size_t total4 = (size_t)K * N / 4;
    wgrad_reduce<<<(int)((total4 + 255) / 256), 256, 0, s>>>(
        part, splits, static_cast<__nv_bfloat16*>(dw), total4);
  }
  const int slabs = (R + SLAB - 1) / SLAB;
  colsum_slabs<<<dim3((N + CX - 1) / CX, slabs), CX * CY, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(db_partial), R,
      N);
  colsum_final<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(db_partial), slabs, static_cast<float*>(db), N);
  return (int)cudaGetLastError();
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("linear_dgrad", "wmma", dgrad_kernel, THREADS, 0),
    {"linear_dgrad|sm90|gemm_kernel<256,K,K>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<256, false, false, DgradEpilogue>),
     sm90::THREADS, sm90::Tile<256>::SMEM},
    {"linear_dgrad|sm90|gemm_kernel<128,K,K>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<128, false, false, DgradEpilogue>),
     sm90::THREADS, sm90::Tile<128>::SMEM},
    ACAI_KERNEL("linear_wgrad", "wmma", wgrad_kernel, THREADS, 0),
    {"linear_wgrad||gemm_kernel<256,MN,MN>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<256, true, true, WgradEpilogue>),
     sm90::THREADS, sm90::Tile<256>::SMEM},
    {"linear_wgrad||gemm_kernel<128,MN,MN>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<128, true, true, WgradEpilogue>),
     sm90::THREADS, sm90::Tile<128>::SMEM},
    ACAI_KERNEL("linear_wgrad", "", wgrad_reduce, 256, 0),
    ACAI_KERNEL("linear_wgrad", "", colsum_slabs, CX * CY, 0),
    ACAI_KERNEL("linear_wgrad", "", colsum_final, 256, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
