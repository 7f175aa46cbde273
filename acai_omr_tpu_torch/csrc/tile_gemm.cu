// K16 tile_gemm: C = op(A) @ op(B) over a grid of (BM, BN) output tiles, bf16
// operands, fp32 accumulation, bf16 or fp32 out.
//
// Replaces: the GEMM probes of the JAX package's tools/:
//   * tools/pallas_gemm_probe.py `make_mm` (kernel :26, pallas_call :39): a
//     bf16 x (m, k) @ w (k, n) on a grid of (m/bm, n/bn, k/bk) tiles, an fp32
//     scratch accumulator carried over the k axis, bf16 out;
//   * tools/mosaic_dot_forms_probe.py `make_kernel` (kernel :24, pallas_call
//     :37): one dot_general of bf16 operands with fp32 out in the three forms
//     the training backward needs. LAYOUT names them by how the operands are
//     stored, row-major:
//       NN  A (M, K), B (K, N)   A @ B     contract ((1,), (0,))  forward
//       NT  A (M, K), B (N, K)   A @ B^T   contract ((1,), (1,))  dgrad
//       TN  A (K, M), B (K, N)   A^T @ B   contract ((0,), (0,))  wgrad, S^T q
//
// On Hopper the grid's k axis becomes a loop inside the block: blocks run in
// parallel and in no order, so nothing is carried between them; the fp32 sum
// stays in registers. Shapes the tiles do not divide are refused, as the TPU
// kernel refuses them.
//
// Bound on an H100: at the training shapes (thousands of rows) the 2 M N K
// flops at 989 TFLOP/s bf16. Design: 2 to 8 warps, each owning a (BM/WARPS_M,
// BN/WARPS_N) sub-tile of 16x16x16 wmma fragments with fp32 accumulators;
// the BK-deep slabs of A and B staged in shared memory as they are stored
// (16-byte cp.async, two stages, so the next slab's loads overlap this slab's
// products). A transposed operand is never transposed in memory: it is read
// through a col-major fragment (ldmatrix.trans underneath). bf16 out goes
// through a 16x16 fp32 scratch per warp, 16-byte stores; fp32 out is stored
// from the fragments directly. No wgmma, no TMA, no persistent blocks: the
// first, simple form, whose rate against torch.matmul is what the probe
// measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

enum Layout { NN = 0, NT = 1, TN = 2 };
constexpr int PAD = 8;  // bf16 elements after every staged row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM_, int BN_, int BK_, int WARPS_M, int WARPS_N, int LAYOUT_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, LAYOUT = LAYOUT_;
  static constexpr int WARPS = WARPS_M * WARPS_N;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  // a staged slab as stored: A (BM, BK), or (BK, BM) for TN; B (BK, BN), or
  // (BN, BK) for NT
  static constexpr int A_ROWS = LAYOUT == TN ? BK : BM;
  static constexpr int A_COLS = LAYOUT == TN ? BM : BK;
  static constexpr int B_ROWS = LAYOUT == NT ? BN : BK;
  static constexpr int B_COLS = LAYOUT == NT ? BK : BN;
  static constexpr int A_LD = A_COLS + PAD, B_LD = B_COLS + PAD;
  static constexpr int STAGE = A_ROWS * A_LD + B_ROWS * B_LD;  // bf16 elements
  static constexpr size_t SMEM = 2 * STAGE * sizeof(__nv_bfloat16);
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile");
  static_assert(SMEM >= WARPS * 256 * sizeof(float), "epilogue scratch");
};

// rows x cols bf16 of a row-major matrix with leading dimension ld, into a
// staged slab with leading dimension sld, 16 bytes per cp.async
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int sld,
                                      const __nv_bfloat16* src, size_t ld) {
  constexpr int CHUNKS = ROWS * COLS / 8;
#pragma unroll
  for (int v = threadIdx.x; v < CHUNKS; v += THREADS) {
    const int r = v / (COLS / 8);
    const int c = (v % (COLS / 8)) * 8;
    cp_async16(dst + r * sld + c, src + r * ld + c);
  }
}

template <class C, bool OUT_F32>
__global__ void __launch_bounds__(C::THREADS)
tile_gemm_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, void* __restrict__ out,
                 int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               typename std::conditional<C::LAYOUT == TN, wmma::col_major,
                                                         wmma::row_major>::type>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               typename std::conditional<C::LAYOUT == NT, wmma::col_major,
                                                         wmma::row_major>::type>;

  const int n0 = blockIdx.x * C::BN;
  const int m0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / (C::BN / C::WN)) * C::WM;
  const int wn = (warp % (C::BN / C::WN)) * C::WN;

  auto load_slab = [&](int s, int k0) {
    __nv_bfloat16* as = smem + s * C::STAGE;
    __nv_bfloat16* bs = as + C::A_ROWS * C::A_LD;
    if (C::LAYOUT == TN)
      stage<C::A_ROWS, C::A_COLS, C::THREADS>(as, C::A_LD, A + (size_t)k0 * M + m0, M);
    else
      stage<C::A_ROWS, C::A_COLS, C::THREADS>(as, C::A_LD, A + (size_t)m0 * K + k0, K);
    if (C::LAYOUT == NT)
      stage<C::B_ROWS, C::B_COLS, C::THREADS>(bs, C::B_LD, B + (size_t)n0 * K + k0, K);
    else
      stage<C::B_ROWS, C::B_COLS, C::THREADS>(bs, C::B_LD, B + (size_t)k0 * N + n0, N);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kt_n = K / C::BK;
  load_slab(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    // the next slab goes into the stage the previous iteration read; the
    // barrier at the end of that iteration freed it
    if (kt + 1 < kt_n) load_slab((kt + 1) & 1, (kt + 1) * C::BK);
    cp_async_commit();  // an empty group on the last slab keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* as = smem + (kt & 1) * C::STAGE;
    const __nv_bfloat16* bs = as + C::A_ROWS * C::A_LD;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      FragA a[C::FM];
      FragB b[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i) {
        const int r = wm + 16 * i;
        if (C::LAYOUT == TN)
          wmma::load_matrix_sync(a[i], as + kk * C::A_LD + r, C::A_LD);
        else
          wmma::load_matrix_sync(a[i], as + r * C::A_LD + kk, C::A_LD);
      }
#pragma unroll
      for (int j = 0; j < C::FN; ++j) {
        const int c = wn + 16 * j;
        if (C::LAYOUT == NT)
          wmma::load_matrix_sync(b[j], bs + c * C::B_LD + kk, C::B_LD);
        else
          wmma::load_matrix_sync(b[j], bs + kk * C::B_LD + c, C::B_LD);
      }
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (OUT_F32) {
    float* c = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::store_matrix_sync(c + (size_t)(m0 + wm + 16 * i) * N + n0 + wn + 16 * j,
                                acc[i][j], N, wmma::mem_row_major);
    return;
  }
  // bf16 out: each fragment through this warp's 16x16 fp32 scratch (the
  // staging slabs are free after the last barrier), rounded once
  __syncthreads();
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(out);
  const int r = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scratch[r * 16 + cc + e]);
      *reinterpret_cast<uint4*>(c + (size_t)(m0 + wm + 16 * i + r) * N + n0 + wn +
                                16 * j + cc) = *reinterpret_cast<const uint4*>(v);
      __syncwarp();
    }
}

template <class C, bool OUT_F32>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           cudaStream_t s) {
  auto kernel = tile_gemm_kernel<C, OUT_F32>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(N / C::BN, M / C::BM), C::THREADS, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      out, M, N, K);
  return (int)cudaGetLastError();
}

// the compiled variants: warps as 2x2 for 64x64, else 8 warps
#define TILE_CASE(bm, bn, bk, wm, wn, layout, f32)                              \
  if (BM == bm && BN == bn && BK == bk && layout_ == layout && out_f32 == f32) \
    return launch<Cfg<bm, bn, bk, wm, wn, layout>, f32>(a, b, out, M, N, K, s);

}  // namespace

// a: (M, K) bf16, or (K, M) for TN; b: (K, N) bf16, or (N, K) for NT; out:
// (M, N) fp32 if out_f32 else bf16. BM | M, BN | N, BK | K, or the call is
// refused (cudaErrorInvalidValue), as is a variant that is not compiled.
extern "C" int acai_tile_gemm(const void* a, const void* b, void* out, int M,
                              int N, int K, int BM, int BN, int BK, int layout_,
                              int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the sweep: A @ B, bf16 out
  TILE_CASE(64, 64, 32, 2, 2, NN, false)
  TILE_CASE(64, 64, 64, 2, 2, NN, false)
  TILE_CASE(128, 64, 32, 4, 2, NN, false)
  TILE_CASE(128, 64, 64, 4, 2, NN, false)
  TILE_CASE(64, 128, 32, 2, 4, NN, false)
  TILE_CASE(64, 128, 64, 2, 4, NN, false)
  TILE_CASE(128, 128, 32, 2, 4, NN, false)
  TILE_CASE(128, 128, 64, 2, 4, NN, false)
  TILE_CASE(128, 256, 32, 2, 4, NN, false)
  TILE_CASE(128, 256, 64, 2, 4, NN, false)
  // the dot forms: fp32 out
  TILE_CASE(64, 64, 32, 2, 2, NN, true)
  TILE_CASE(64, 64, 32, 2, 2, NT, true)
  TILE_CASE(64, 64, 32, 2, 2, TN, true)
  TILE_CASE(128, 128, 32, 2, 4, NN, true)
  TILE_CASE(128, 128, 32, 2, 4, NT, true)
  TILE_CASE(128, 128, 32, 2, 4, TN, true)
  return (int)cudaErrorInvalidValue;
}
