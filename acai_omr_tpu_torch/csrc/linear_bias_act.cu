// K1 linear_bias_act: out = act(A @ W + bias), bf16 in, fp32 accumulate, bf16 out.
//
// Replaces: the qkv / out / cross-q / cross-out / ff1 / ff2 products inside the
// two Pallas bodies of the JAX package: ops/pallas_monolith.py `_kernel` (the
// `mat(...)` dots, bf16 mode) and ops/pallas_train_layer.py `_fwd_kernel`
// (`_dot(x, wqkv)`, `_dot(a_s, wo)`, the F-chunked ff1/ff2 dots).
//
// Layout: A (M, K) row-major, W (K, N) row-major (the JAX (in, out) kernel
// layout), bias (N,) fp32, out (M, N). Any M; K % 8 == 0, N % 8 == 0 (the
// wmma kernel: K % 32 == 0, N % 64 == 0).
//
// Bound on an H100: the encoder and training products (M = B*T, thousands of
// rows) are tensor-core bound (2MNK flops at 989 TFLOP/s bf16); the decode
// products (M = B <= 128) read the whole weight matrix for a handful of rows
// and are bound by the weight bytes at 3.35 TB/s. Three kernels, one
// epilogue; the wrapper's plan (ops/linear_kernel.py `gemm_plan`) picks one
// by M:
//
// * `acai_linear_bias_act_sm90`, the large-M products: the Hopper GEMM core
//   of sm90_gemm.cuh (TMA into a shared-memory ring, wgmma from two consumer
//   warpgroups, a producer warp; X K-major, W MN-major), 128 x BN tiles with
//   BN = 128 or 256, the epilogue below run on the staged fp32 tile.
// * `acai_linear_bias_act_skinny`, the decode rows (M <= 128): one launch
//   that keeps deep streams of W in flight. A block owns 64 output columns
//   and one range of K; a producer warp streams W boxes (64 rows x 64,
//   MN-major) and the x box beside each (the M rows rounded up to 8,
//   K-major) through a ring of four stages (32 KB of W in flight a block);
//   one consumer warpgroup per 64 rows runs wgmma m64n64k16. The K ranges
//   of one output tile are the blocks of one thread-block cluster (at most
//   8): each block stages its fp32 partial tile in its shared memory, and
//   after a cluster barrier the blocks share the tile's epilogue, each
//   output summing the partials from distributed shared memory in rank
//   order, so two runs give the same bits and no second launch sums them.
//   The plan (`skinny_plan`) gives each block at most a ring's depth of
//   k-steps and the grid about one block an SM. Measured on an H100: the
//   time is mostly a fixed cost (about 4.5 us for the smallest products),
//   not the weight stream; narrower tiles (32 columns), more blocks (a
//   16-block cluster) or deeper splits measured slower.
// * `acai_linear_bias_act`, the pre-Hopper kernel the decode rows took
//   before (kept as the yardstick, `variant="wmma"`): one 64x64 output tile
//   per block, four warps of 2x2 wmma 16x16x16 bf16 tiles, the K loop staged
//   through shared memory with 16-byte loads. Its plan (`split_plan`) splits
//   K across blockIdx.z; each split writes an fp32 partial and a second
//   launch sums them in a fixed order and applies the epilogue.
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
#include "sm90_cluster.cuh"
#include "sm90_gemm.cuh"

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

// The epilogue of the Hopper core: four staged fp32 sums at (m, n .. n + 3).
struct CoreEpilogue {
  Epilogue e;
  __device__ __forceinline__ void operator()(const float v[4], int m,
                                             int n) const {
    epilogue4(e, v, m, n);
  }
};

// ------------------------------------------------- the decode rows (skinny)

namespace skinny {

constexpr int BN = 64;        // output columns a block
constexpr int BK = 64;        // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;     // 32 KB of W in flight a block
constexpr int MAX_SPLIT = sm90::MAX_CLUSTER;
constexpr int X_ROWS = 64;    // a consumer warpgroup's rows
constexpr int W_BYTES = BK * BN * 2;
constexpr int C_LD = BN + 4;  // fp32 partial tile, 16-byte aligned rows

// The kernel for NWG consumer warpgroups of 64 rows (M <= 64 NWG). A stage
// holds the x box (up to 64 NWG rows x BK, K-major) and the W box (BK rows x
// BN, MN-major), both with 128-byte swizzle; once the block is done, the
// ring's bytes hold its fp32 partial tile (row stride C_LD).
template <int NWG>
struct Form {
  static constexpr int X_BYTES = X_ROWS * NWG * BK * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;  // consumers + producer warp
  static constexpr int C_BYTES = X_ROWS * NWG * C_LD * 4;
  static constexpr int smem(int stages) {
    return 1024 + (stages * STAGE > C_BYTES ? stages * STAGE : C_BYTES);
  }
  static_assert(1024 + STAGES * STAGE <= 227 * 1024, "past shared memory");
};

// Grid (split, ceil(N / BN)), one cluster of `split` blocks per BN output
// columns: block r of the cluster sums K over [r k_chunk, (r + 1) k_chunk).
// The partials meet in distributed shared memory, each summed in rank order;
// the cluster's blocks share the tile's epilogue.
template <int NWG>
__global__ void __launch_bounds__(Form<NWG>::THREADS)
    skinny_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, int M, int N, int K,
                  int k_chunk, int stages, int x_bytes, Epilogue epi) {
  using F = Form<NWG>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  float* ctile = reinterpret_cast<float*>(smem_raw + (ring - raw));

  const int rank = sm90::cluster_rank(), split = (int)gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int k_lo = rank * k_chunk;
  const int steps = max(0, (min(K, k_lo + k_chunk) - k_lo + BK - 1) / BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const int c = warp / 4, lt = threadIdx.x % 128;
  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        const uint32_t st = ring + s * F::STAGE, fs = sm90::smem_u32(&full[s]);
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / stages) & 1) ^ 1);
        sm90::mbar_expect_tx(fs, x_bytes + W_BYTES);
        sm90::tma_load(st, &tx, fs, k_lo + i * BK, 0);
        sm90::tma_load(st + F::X_BYTES, &tw, fs, n0, k_lo + i * BK);
      }
    }
    __syncwarp();
  } else {
    for (int i = 0; i < steps; ++i) {
      const int s = i % stages;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / stages) & 1);
      const uint32_t a = ring + s * F::STAGE + c * X_ROWS * BK * 2;
      const uint32_t w = ring + s * F::STAGE + F::X_BYTES;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_n64<0, 1>(acc, sm90::step_desc<false>(a, kk),
                              sm90::step_desc<true>(w, kk));
      sm90::wgmma_commit();
      sm90::fence_acc(acc);
      sm90::wgmma_wait<1>();
      if (i > 0 && lt == 0)
        sm90::mbar_arrive(sm90::smem_u32(&empty[(i - 1) % stages]));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
  }
  // every load has landed and every wgmma has retired: the ring is free
  __syncthreads();
  if (warp < 4 * NWG) {
    const int row = c * X_ROWS + (lt / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(ctile + row * C_LD + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(ctile + (row + 8) * C_LD + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  sm90::cluster_sync();  // every block's partial tile is staged
  // this block's share of the tile's outputs, four columns at a time: the
  // partials summed in rank order (the same order whichever block sums)
  constexpr int G = BN / 4;
  for (int e = rank * F::THREADS + threadIdx.x; e < M * G;
       e += split * F::THREADS) {
    const int r = e / G, col = (e % G) * 4, n = n0 + col;
    if (n >= N) continue;
    const int off = r * C_LD + col;
    float4 v = sm90::load_peer4(ctile + off, 0);
    for (int q = 1; q < split; ++q) {
      const float4 u = sm90::load_peer4(ctile + off, q);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float f[4] = {v.x, v.y, v.z, v.w};
    epilogue4(epi, f, r, n);
  }
  sm90::cluster_sync();  // no block leaves while another reads its partials
}

template <int NWG>
int launch(const void* x, const void* w, int M, int N, int K, int k_chunk,
           int split, const Epilogue& epi, cudaStream_t s) {
  using F = Form<NWG>;
  if (k_chunk <= 0 || k_chunk % BK != 0 || split < 1 || split > MAX_SPLIT ||
      (long long)k_chunk * (split - 1) >= K)
    return (int)cudaErrorInvalidValue;
  // x's box: its M rows rounded up to 8; the stage keeps room for 64 NWG
  // rows, and the rows past the box (stale bytes) only reach accumulator
  // rows that are never read
  const int x_rows = (M + 7) / 8 * 8;
  CUtensorMap tx, tw;
  int rc = sm90::tensor_map(&tx, x, M, K, x_rows, 0, BK);
  if (rc == 0) rc = sm90::tensor_map(&tw, w, K, N, BK, 0, BN);
  if (rc != 0) return rc;
  const int stages = k_chunk / BK < STAGES ? k_chunk / BK : STAGES;
  const auto kernel = skinny_kernel<NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::smem(STAGES));
  if (err != cudaSuccess) return (int)err;
  return sm90::launch_cluster(kernel, dim3(split, (N + BN - 1) / BN, 1),
                              F::THREADS, F::smem(stages), split, s, tx, tw, M,
                              N, K, k_chunk, stages, x_rows * BK * 2, epi);
}

}  // namespace skinny

Epilogue make_epilogue(const void* bias, void* out, void* gp, int act, int N,
                       unsigned drop_thresh, float drop_scale, unsigned seed0,
                       unsigned seed1, unsigned drop_stream, int drop_t) {
  const bool f32 = act == 3;
  return Epilogue{static_cast<const float*>(bias),
                  f32 ? nullptr : static_cast<__nv_bfloat16*>(out),
                  static_cast<__nv_bfloat16*>(gp), act, N,
                  DropSpec{drop_thresh, drop_scale, seed0, seed1, drop_stream,
                           drop_t > 0 ? drop_t : 1},
                  f32 ? static_cast<float*>(out) : nullptr};
}

int check_args(int act, const void* gp, unsigned drop_thresh, int drop_t) {
  if (drop_thresh != 0u && drop_t <= 0) return (int)cudaErrorInvalidValue;
  if (act == 3 && (gp != nullptr || drop_thresh != 0u))
    return (int)cudaErrorInvalidValue;
  return 0;
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
  if (const int rc = check_args(act, gp, drop_thresh, drop_t)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const Epilogue epi =
      make_epilogue(bias, out, gp, act, N, drop_thresh, drop_scale, seed0,
                    seed1, drop_stream, drop_t);
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

// The large-M products on the Hopper core (sm90_gemm.cuh): A = x (M, K),
// W (K, N), any M, K % 8 == 0, N % 8 == 0 (TMA's 16-byte row strides), x and
// W 16-byte aligned; the arguments and epilogues of acai_linear_bias_act
// above; bn: 128 or 256.
extern "C" int acai_linear_bias_act_sm90(const void* a, const void* w,
                                         const void* bias, void* out, void* gp,
                                         int M, int N, int K, int bn, int act,
                                         unsigned drop_thresh, float drop_scale,
                                         unsigned seed0, unsigned seed1,
                                         unsigned drop_stream, int drop_t,
                                         void* stream) {
  if (const int rc = check_args(act, gp, drop_thresh, drop_t)) return rc;
  if (N % 8 != 0 || K % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int rc = sm90::tensor_map(&ta, a, M, K, sm90::box_rows(false, sm90::BM));
  if (rc == 0) rc = sm90::tensor_map(&tb, w, K, N, sm90::box_rows(true, 0));
  if (rc != 0) return rc;
  const CoreEpilogue epi{make_epilogue(bias, out, gp, act, N, drop_thresh,
                                       drop_scale, seed0, seed1, drop_stream,
                                       drop_t)};
  const int k_chunk = (K + sm90::BK - 1) / sm90::BK * sm90::BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return sm90::launch<256, false, true>(ta, tb, M, N, K, k_chunk, 1, epi, s);
  if (bn == 128)
    return sm90::launch<128, false, true>(ta, tb, M, N, K, k_chunk, 1, epi, s);
  return (int)cudaErrorInvalidValue;
}

// The decode rows (M <= 128) in one launch: x (M, K), W (K, N), K % 8 == 0,
// N % 8 == 0, x and W 16-byte aligned (TMA's rules); the arguments and
// epilogues of acai_linear_bias_act above. K split in `split` (<= 8, one
// cluster) ranges of k_chunk (a multiple of 64), none empty.
extern "C" int acai_linear_bias_act_skinny(
    const void* a, const void* w, const void* bias, void* out, void* gp, int M,
    int N, int K, int k_chunk, int split, int act, unsigned drop_thresh,
    float drop_scale, unsigned seed0, unsigned seed1, unsigned drop_stream,
    int drop_t, void* stream) {
  if (const int rc = check_args(act, gp, drop_thresh, drop_t)) return rc;
  if (M < 1 || M > 128 || N % 8 != 0 || K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Epilogue epi = make_epilogue(bias, out, gp, act, N, drop_thresh,
                                     drop_scale, seed0, seed1, drop_stream,
                                     drop_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M > 64 ? skinny::launch<2>(a, w, M, N, K, k_chunk, split, epi, s)
                : skinny::launch<1>(a, w, M, N, K, k_chunk, split, epi, s);
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    {"linear_bias_act|skinny|skinny_kernel<1>",
     reinterpret_cast<const void*>(skinny::skinny_kernel<1>),
     skinny::Form<1>::THREADS, skinny::Form<1>::smem(skinny::STAGES)},
    {"linear_bias_act|skinny|skinny_kernel<2>",
     reinterpret_cast<const void*>(skinny::skinny_kernel<2>),
     skinny::Form<2>::THREADS, skinny::Form<2>::smem(skinny::STAGES)},
    ACAI_KERNEL("linear_bias_act", "wmma", linear_kernel, THREADS, 0),
    ACAI_KERNEL("linear_bias_act", "wmma", reduce_kernel, 256, 0),
    {"linear_bias_act|sm90|gemm_kernel<256,K,MN>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<256, false, true, CoreEpilogue>),
     sm90::THREADS, sm90::Tile<256>::SMEM},
    {"linear_bias_act|sm90|gemm_kernel<128,K,MN>",
     reinterpret_cast<const void*>(
         sm90::gemm_kernel<128, false, true, CoreEpilogue>),
     sm90::THREADS, sm90::Tile<128>::SMEM},
};
ACAI_EXPORT_RESOURCES(kResources)
