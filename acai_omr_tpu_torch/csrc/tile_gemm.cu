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
// flops at 989 TFLOP/s bf16. Reaching it takes wgmma fed by TMA, and a tile's
// fixed cost (the ring's fill, the epilogue and its stores: about 10 us a
// tile on the core of sm90_gemm.cuh, PERF.md section 7) hidden behind the
// next tile's work. Design (`tg::persistent_kernel`, on the core's building
// blocks):
//
// * Operands by TMA, one CUtensorMap each, each read as stored: a K-major
//   operand (NN's and NT's A, NT's B) in boxes of BK columns x its tile's
//   rows, swizzled across BK * 2 bytes (128 at BK = 64, 64 at BK = 32); an
//   MN-major operand (NN's and TN's B, TN's A) in boxes of 64 M or N columns
//   x BK rows of K, swizzled across 128 bytes, read by wgmma with its
//   transpose bit (LBO: one box; SBO: eight K rows). No operand is
//   transposed in memory, so the three layouts stream alike.
// * Warp specialisation: one producer warp (its first lane issues the loads)
//   feeds a ring of stages with full / empty mbarrier pairs (as many blocks
//   an SM as a six-stage ring allows, then as many stages as they leave room
//   for beside the output staging, up to eight); BM / 64 consumer
//   warpgroups each run wgmma m64nBNk16 on 64 rows of the tile, the sums in
//   fp32 registers, one wgmma group in flight as in the core; no wgmma is
//   issued under a condition (ptxas serializes them there, C7520).
// * Persistent blocks: G = min(tiles, the blocks an SM holds x 132) blocks;
//   block b takes tiles b, b + G, b + 2G, ... of an order grouped along M
//   (GROUP_M = 8 tile rows walked down before the next column of tiles), so
//   the tiles in flight at once share a few B column panels and A row
//   panels in L2 (ops/probe_kernels.py `tile_gemm_schedule` writes the same
//   order). The producer runs ahead into the next tile's stages while the
//   consumers finish this one.
// * Epilogue: each consumer warpgroup writes its 64 rows, rounded to the out
//   type, into its own staging buffer (boxes of 64 rows x 128 bytes,
//   128-byte swizzle: conflict-free bf16 pairs, two wavefronts for fp32
//   pairs), then TMA stores write them to C. The store is waited for
//   (`cp.async.bulk.wait_group.read`) only before the buffer is written
//   again, a tile later: it overlaps the next tile's mainloop.
// The kernel it replaced (`tile_gemm_kernel`: 16x16x16 wmma fragments, a
// two-stage cp.async slab, one tile a block, transposed operands through
// col-major fragments) stays as `variant="wmma"`, the yardstick timed in
// turns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "func_attrs.cuh"
#include "sm90_gemm.cuh"

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

}  // namespace

namespace tg {  // K16's persistent kernel

constexpr int MIN_STAGES = 6;  // the ring that sets the blocks an SM
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 227 * 1024;  // a block's shared memory
constexpr int SM_SMEM = 228 * 1024;     // an SM's, 1 KB of it per block kept
constexpr int STATIC_SMEM = 256;        // room for the static mbarriers
constexpr int GROUP_M = 8;              // tile rows walked down per column
constexpr int ROWS = 64;                // a consumer warpgroup's rows
constexpr int OUT_BOX = ROWS * 128;     // a store box: 64 rows x 128 bytes

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int BM_, int BN_, int BK_, int LAYOUT_, bool F32_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, LAYOUT = LAYOUT_;
  static constexpr bool F32 = F32_;
  static constexpr bool A_MN = LAYOUT == TN, B_MN = LAYOUT != NT;
  static constexpr int CONSUMERS = BM / ROWS;
  static constexpr int THREADS = 128 * CONSUMERS + 32;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ESIZE = F32 ? 4 : 2;
  static constexpr int OUT_COLS = 128 / ESIZE;     // columns a store box
  static constexpr int OUT_BOXES = BN / OUT_COLS;  // a consumer's boxes
  static constexpr int HALF_OUT = OUT_BOXES * OUT_BOX;
  static constexpr int OUT_BYTES = CONSUMERS * HALF_OUT;
  // the blocks an SM holds at a ring of MIN_STAGES (one where that does not
  // fit), then as many stages as those blocks leave room for beside the
  // staging, up to MAX_STAGES; the same arithmetic as ops/probe_kernels.py
  // `tile_gemm_smem`
  static constexpr int BLOCKS = cmax(
      1, SM_SMEM / (MIN_STAGES * STAGE + OUT_BYTES + 1024 + STATIC_SMEM + 1024));
  static constexpr int ROOM = cmin(SMEM_LIMIT - STATIC_SMEM,
                                   SM_SMEM / BLOCKS - STATIC_SMEM - 1024);
  static constexpr int STAGES =
      cmin(MAX_STAGES, (ROOM - OUT_BYTES - 1024) / STAGE);
  static constexpr int SMEM = STAGES * STAGE + OUT_BYTES + 1024;
  static constexpr int MIN_BLOCKS = SM_SMEM / (SMEM + STATIC_SMEM + 1024);
  static_assert(BM % ROWS == 0 && BN % 64 == 0 && (BK == 32 || BK == 64),
                "tile");
  static_assert(STAGES >= 2 && MIN_BLOCKS == BLOCKS, "shared memory");
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
};

// k16 step kk of an operand's tile in a stage. MN-major: boxes of 64 M or N
// columns x BK K rows, 128-byte swizzle (+16 K rows a step; LBO: the next
// box; SBO: eight K rows). K-major: rows of BK, swizzled across BK * 2 bytes
// (+32 bytes a step; SBO: eight rows).
template <bool MN, int BK>
__device__ __forceinline__ uint64_t desc(uint32_t addr, int kk) {
  if constexpr (MN)
    return sm90::smem_desc(addr + kk * 2048, ROWS * BK * 2, 1024, 128);
  else
    return sm90::smem_desc(addr + kk * 32, 16, 8 * BK * 2, BK * 2);
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 256)
    sm90::wgmma_n256<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    sm90::wgmma_n128<TA, TB>(d, da, db);
  else
    sm90::wgmma_n64<TA, TB>(d, da, db);
}

// Tile i's (row, column) of tiles: groups of GROUP_M tile rows, each walked
// down its rows before the next column (ops/probe_kernels.py
// `tile_gemm_tile`).
__device__ __forceinline__ void tile_of(int i, int mtn, int ntn, int& mt,
                                        int& nt) {
  const int per_group = GROUP_M * ntn;
  const int g = i / per_group, first = g * GROUP_M;
  const int gm = min(GROUP_M, mtn - first);
  const int r = i - g * per_group;
  mt = first + r % gm;
  nt = r / gm;
}

// Stage `dst`: the boxes of K block k of tile (m0, n0), completing on `bar`.
template <class C>
__device__ __forceinline__ void load_stage(uint32_t dst, uint32_t bar,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb, int m0,
                                           int n0, int k) {
  constexpr int MN_BOX = ROWS * C::BK * 2;
  sm90::mbar_expect_tx(bar, C::STAGE);
  if constexpr (C::A_MN) {
#pragma unroll
    for (int j = 0; j < C::BM / ROWS; ++j)
      sm90::tma_load(dst + j * MN_BOX, ta, bar, m0 + j * ROWS, k);
  } else {
    sm90::tma_load(dst, ta, bar, k, m0);
  }
  const uint32_t db = dst + C::A_BYTES;
  if constexpr (C::B_MN) {
#pragma unroll
    for (int j = 0; j < C::BN / 64; ++j)
      sm90::tma_load(db + j * MN_BOX, tb, bar, n0 + j * 64, k);
  } else {
    sm90::tma_load(db, tb, bar, k, n0);
  }
}

// Grid: G persistent blocks, 1 <= G <= the tiles. ta / tb: the operands'
// maps as stored; tc: the (M, N) output's map, boxes of 64 rows x 128 bytes.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    persistent_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc, int M, int N,
                      int K) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t stage_out = ring + C::STAGES * C::STAGE;
  const int mtn = M / C::BM, ntn = N / C::BN, tiles = mtn * ntn;
  const int steps = K / C::BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::CONSUMERS) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, nt;
        tile_of(tile, mtn, ntn, mt, nt);
        for (int i = 0; i < steps; ++i, ++it) {
          const int s = it % C::STAGES;
          sm90::mbar_wait(sm90::smem_u32(&empty[s]),
                          ((it / C::STAGES) & 1) ^ 1);
          load_stage<C>(ring + s * C::STAGE, sm90::smem_u32(&full[s]), &ta,
                        &tb, mt * C::BM, nt * C::BN, i * C::BK);
        }
      }
    }
    return;
  }

  const int c = warp / 4;          // this warpgroup's 64 rows of the tile
  const int lt = threadIdx.x % 128;
  const int lane = lt % 32;
  const int row = (lt / 32) * 16 + lane / 4;  // and row + 8
  const uint32_t half = stage_out + c * C::HALF_OUT;
  unsigned char* half_p = smem_raw + (half - raw);
  constexpr int PER_CHUNK = 16 / C::ESIZE;  // out elements a 16-byte chunk
  float acc[C::BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    tile_of(tile, mtn, ntn, mt, nt);
#pragma unroll
    for (int j = 0; j < C::BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < steps; ++i, ++it) {
      const int s = it % C::STAGES;
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (it / C::STAGES) & 1);
      const uint32_t a = ring + s * C::STAGE + c * ROWS * C::BK * 2;
      const uint32_t b = ring + s * C::STAGE + C::A_BYTES;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        mma<C::BN, C::A_MN ? 1 : 0, C::B_MN ? 1 : 0>(
            acc, desc<C::A_MN, C::BK>(a, kk), desc<C::B_MN, C::BK>(b, kk));
      sm90::wgmma_commit();
      sm90::fence_acc(acc);
      sm90::wgmma_wait<1>();
      // the group before this one has retired: its stage is free
      if (i > 0 && lt == 0)
        sm90::mbar_arrive(sm90::smem_u32(&empty[(it - 1) % C::STAGES]));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
    if (lt == 0)
      sm90::mbar_arrive(sm90::smem_u32(&empty[(it - 1) % C::STAGES]));

    // the previous tile's stores have read the staging buffer
    if (lt == 0) sm90::store_wait_read<0>();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const int cib = col % C::OUT_COLS;
      unsigned char* box = half_p + (col / C::OUT_COLS) * OUT_BOX +
                           (cib % PER_CHUNK) * C::ESIZE;
      const int chunk = cib / PER_CHUNK;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int r = row + 8 * h8;
        unsigned char* p = box + r * 128 + ((chunk ^ (r & 7)) << 4);
        const float x = acc[4 * j + 2 * h8], y = acc[4 * j + 2 * h8 + 1];
        if constexpr (C::F32)
          *reinterpret_cast<float2*>(p) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    if (lt == 0) {
#pragma unroll
      for (int bx = 0; bx < C::OUT_BOXES; ++bx)
        sm90::tma_store(&tc, half + bx * OUT_BOX, nt * C::BN + bx * C::OUT_COLS,
                        mt * C::BM + c * ROWS);
      sm90::store_commit();
    }
  }
  if (lt == 0) sm90::store_wait_all();
}

template <class C>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           int blocks, cudaStream_t s) {
  CUtensorMap ta = {}, tb = {}, tc = {};
  int rc = C::A_MN ? sm90::tensor_map(&ta, a, K, M, C::BK, 0, 64)
                   : sm90::tensor_map(&ta, a, M, K, C::BM, 0, C::BK);
  if (rc == 0)
    rc = C::B_MN ? sm90::tensor_map(&tb, b, K, N, C::BK, 0, 64)
                 : sm90::tensor_map(&tb, b, N, K, C::BN, 0, C::BK);
  if (rc == 0)
    rc = sm90::encode_map(
        &tc, out, M, N, N, ROWS, C::OUT_COLS, CU_TENSOR_MAP_SWIZZLE_128B,
        C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        C::ESIZE);
  if (rc != 0) return rc;
  const auto kernel = persistent_kernel<C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, C::THREADS, C::SMEM, s>>>(ta, tb, tc, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace tg

// the compiled variants of both kernels: (tile, layout, out); the wmma
// kernel's warps as 2x2 for 64x64, else 8 warps
#define TILE_VARIANTS(X)             \
  X(64, 64, 32, 2, 2, NN, false, "nn 64x64x32 bfloat16")     \
  X(64, 64, 64, 2, 2, NN, false, "nn 64x64x64 bfloat16")     \
  X(128, 64, 32, 4, 2, NN, false, "nn 128x64x32 bfloat16")    \
  X(128, 64, 64, 4, 2, NN, false, "nn 128x64x64 bfloat16")    \
  X(64, 128, 32, 2, 4, NN, false, "nn 64x128x32 bfloat16")    \
  X(64, 128, 64, 2, 4, NN, false, "nn 64x128x64 bfloat16")    \
  X(128, 128, 32, 2, 4, NN, false, "nn 128x128x32 bfloat16")   \
  X(128, 128, 64, 2, 4, NN, false, "nn 128x128x64 bfloat16")   \
  X(128, 256, 32, 2, 4, NN, false, "nn 128x256x32 bfloat16")   \
  X(128, 256, 64, 2, 4, NN, false, "nn 128x256x64 bfloat16")   \
  X(64, 64, 32, 2, 2, NN, true, "nn 64x64x32 float32")      \
  X(64, 64, 32, 2, 2, NT, true, "nt 64x64x32 float32")      \
  X(64, 64, 32, 2, 2, TN, true, "tn 64x64x32 float32")      \
  X(128, 128, 32, 2, 4, NN, true, "nn 128x128x32 float32")    \
  X(128, 128, 32, 2, 4, NT, true, "nt 128x128x32 float32")    \
  X(128, 128, 32, 2, 4, TN, true, "tn 128x128x32 float32")

// a: (M, K) bf16, or (K, M) for TN; b: (K, N) bf16, or (N, K) for NT; out:
// (M, N) fp32 if out_f32 else bf16. BM | M, BN | N, BK | K, or the call is
// refused (cudaErrorInvalidValue), as is a variant that is not compiled. The
// wmma kernel it replaced, one tile a block.
extern "C" int acai_tile_gemm(const void* a, const void* b, void* out, int M,
                              int N, int K, int BM, int BN, int BK, int layout_,
                              int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WMMA_CASE(bm, bn, bk, wm, wn, layout, f32, name)                            \
  if (BM == bm && BN == bn && BK == bk && layout_ == layout && out_f32 == f32) \
    return launch<Cfg<bm, bn, bk, wm, wn, layout>, f32>(a, b, out, M, N, K, s);
  TILE_VARIANTS(WMMA_CASE)
#undef WMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// K16's persistent kernel: the same arguments, and `blocks` persistent
// blocks (1 .. the tiles; ops/probe_kernels.py `tile_gemm_blocks`). a, b and
// out 16-byte aligned, their rows multiples of 16 bytes.
extern "C" int acai_tile_gemm_persistent(const void* a, const void* b,
                                         void* out, int M, int N, int K,
                                         int BM, int BN, int BK, int layout_,
                                         int out_f32, int blocks,
                                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK ||
      blocks <= 0 || (long long)blocks > (long long)(M / BM) * (N / BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PERSISTENT_CASE(bm, bn, bk, wm, wn, layout, f32, name)                      \
  if (BM == bm && BN == bn && BK == bk && layout_ == layout && out_f32 == f32) \
    return tg::launch<tg::Cfg<bm, bn, bk, layout, f32>>(a, b, out, M, N, K,    \
                                                       blocks, s);
  TILE_VARIANTS(PERSISTENT_CASE)
#undef PERSISTENT_CASE
  return (int)cudaErrorInvalidValue;
}

// The resource rows (csrc/func_attrs.cuh) of the persistent kernel's
// variants, keyed as ops/probe_kernels.py counts their launches.
#define PERSISTENT_ROW(bm, bn, bk, wm, wn, layout, f32, name)                   \
  AcaiKernelEntry{"tile_gemm|" name "|persistent_kernel",                     \
                  reinterpret_cast<const void*>(                              \
                      &tg::persistent_kernel<tg::Cfg<bm, bn, bk, layout, f32>>), \
                  tg::Cfg<bm, bn, bk, layout, f32>::THREADS,                  \
                  tg::Cfg<bm, bn, bk, layout, f32>::SMEM},
static const AcaiKernelEntry kResources[] = {TILE_VARIANTS(PERSISTENT_ROW)};
#undef PERSISTENT_ROW
ACAI_EXPORT_RESOURCES(kResources)
