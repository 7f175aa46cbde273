// K5 quant_linear_bias_act: the W8A8 product of the int8 decode step,
//   out = act(((int8(x) @ w8) * row_scale) * col_scale + bias).
//
// Replaces: `_qdot` of ops/pallas_monolith.py in the JAX package, at the six
// `mat(...)` sites of `_kernel` in W8A8 mode (qkv, self out, cross q, cross
// out, ff1, ff2): per-row max-abs quantization of the activations over the
// whole contraction axis (fp32 scale max(amax, 1e-8) / 127, x / scale rounded
// half to even, no clip), an int8 x int8 product with int32 accumulation, and
// the dequantization (float(acc) * row_scale) * col_scale in that order, then
// bias and epilogue.
//
// Layout: x (M, K) bf16 row-major; weights K-packed four at a time,
// (K/4, N, 4) int8, i.e. one 32-bit word per (k/4, n) holding w[k..k+3][n];
// col_scale and bias (N,) fp32; out (M, N) bf16. K % 128 == 0, N % 128 == 0,
// any M (tiles of 32 rows).
//
// Bound on an H100: decode rows (M = B <= 32, or B * beams) read the whole
// weight matrix for a handful of rows, so the K*N weight bytes at 3.35 TB/s
// bound it; the int8 operations are far below the card's rate.
//
// Epilogue act: 0 = none; 1 = exact-erf GELU on the fp32 sum; 2 = round the
// sum to bf16, then GELU (the decode monolith casts ff1 to the compute dtype
// before its GELU); 3 = the dequantized fp32 partial of a tensor-parallel
// row-parallel product, (float(acc) * row_scale) * col_scale written to an
// fp32 `out` without the bias (`_qdot` under ACAI_TP_W8A8; K15 tp_allreduce
// sums the ranks' partials and adds the bias).
//
// K14 quant4_linear_bias_act: the W4A8 product, the same function with int4
// weights in [-7, 7].
//
// Replaces: `unpack_int4` and the W4A8 branch of `_kernel` in
// ops/pallas_monolith.py of the JAX package, which unpacks a layer's six
// nibble-packed matrices once into int8 VMEM scratch (through an identity
// matmul) and then runs `_qdot` as above; the weights come from
// `prepack(quantize_weights="int4")` (one bf16-rounded max-abs / 7 scale per
// output column).
//
// Layout: weights K-packed eight rows a word, (K/8, N) int32; byte j of the
// word of rows k..k+7 holds q[k+j] + 8 in its low nibble and q[k+4+j] + 8 in
// its high nibble, so (w & 0x0F0F0F0F) - 0x08080808 (per byte) holds rows
// k..k+3 and ((w >> 4) & 0x0F0F0F0F) - 0x08080808 rows k+4..k+7.
//
// Bound on an H100: the K*N/2 packed weight bytes at 3.35 TB/s at decode
// rows (M <= 32), a quarter of K1's bytes.
//
// Design of both (`quant8_cluster<BN>` for K5, `quant4_cluster` for K14: one
// launch, no scratch in device memory; one body, `cluster_body`, templated
// on the weight format), on the model of K1's skinny kernel: a block owns BN
// output columns (K5: 64 or 128, `quant8_plan`; K14: 64), up to 32
// activation rows and one range of K; the K ranges of an output tile are the
// blocks of one thread-block cluster (at most 8, `quant8_plan` /
// `quant4_plan` in ops/quant_linear_kernel.py).
// * Thread 0 issues every load of the block by TMA at once: its K range of
//   the x rows (boxes of 32 rows x 128 k, rows past M zero) and the weight
//   boxes (word rows x 32 columns, 128-byte swizzle, BN / 32 a stage)
//   through a ring of up to 8 stages.
// * Each row's partial max-abs over the block's range (a warp a row, from
//   shared memory) meets the other blocks' through distributed shared
//   memory (max is order-free), so every block quantizes its range with the
//   row's scale over all of K, fp32 max(amax, 1e-8) / 127 (x times the
//   scale's reciprocal, the division itself only near a half-integer, where
//   the two could round apart), into int8 rows laid out in the tensor cores'
//   fragment order, a warp a row.
// * The product: `mma.sync` m16n8k32 s8 x s8 -> s32, eight warps, an 8-column
//   tile each per 64 columns. Only the B fragment differs between the
//   formats. K5: a (K/4, N) word is already a B register (four k of one
//   column); a thread takes the two words of its column whose k groups its
//   A registers hold. K14: the two nibble halves of two packed words,
//   unpacked in registers. Inside a 32-deep step the 4-k groups of the
//   int8 rows are permuted (an integer sum is the same in any order) so that
//   a thread's two A registers of a row are one eight-byte load.
// * The exact int32 partial tiles meet through distributed shared memory
//   after a cluster barrier; the blocks share the tile's epilogue, summing
//   the ranks' partials in rank order.
// The result equals the function above and the plain twins bit for bit.
//
// The form both replaced (kept as the yardstick, `variant="simt"`): three
// launches (a row quantizer writing int8 rows and scales to device memory; a
// product kernel, one output column a thread, one coalesced weight word a
// thread per 4 k (K5) or 8 k (K14) at stride N, `__dp4a` against the int8
// tile broadcast from shared memory; with K split across blockIdx.z a third
// launch summing the int32 partials and applying the epilogue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "func_attrs.cuh"
#include "sm90_cluster.cuh"

namespace {

constexpr int BM = 32;       // activation rows per block
constexpr int BN = 128;      // output columns per block, one per thread
constexpr int KSTAGE = 128;  // k values staged in shared memory at a time
constexpr int THREADS = 128;
constexpr int QTHREADS = 256;

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// (float(acc) * rs) * cs + b without fused multiply-adds, so the result is
// the plain PyTorch twin's bit for bit
__device__ __forceinline__ float epilogue(int acc, float rs, float cs,
                                          const float* bias, int n, int act) {
  const float p = __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
  if (act == 3) return p;
  float u = __fadd_rn(p, bias[n]);
  if (act == 1) return gelu_erf(u);
  if (act == 2) return gelu_erf(__bfloat162float(__float2bfloat16(u)));
  return u;
}

__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int K,
                     int8_t* __restrict__ x8, float* __restrict__ row_scale) {
  __shared__ float red[QTHREADS / 32];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xr = x + (size_t)m * K;
  float amax = 0.0f;
  for (int k = tid; k < K; k += QTHREADS)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) red[tid / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float rs = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (tid == 0) row_scale[m] = rs;
  for (int k = tid; k < K; k += QTHREADS)
    x8[(size_t)m * K + k] =
        (int8_t)__float2int_rn(__fdiv_rn(__bfloat162float(xr[k]), rs));
}

// kInt4 = false: K5, w holds (K/4, N) words of four int8 weights.
// kInt4 = true: K14, w holds (K/8, N) words of eight packed int4 weights.
template <bool kInt4>
__global__ void __launch_bounds__(THREADS)
quant_linear_kernel(const int8_t* __restrict__ x8,
                    const uint32_t* __restrict__ w,
                    const float* __restrict__ row_scale,
                    const float* __restrict__ col_scale,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ out32,
                    int* __restrict__ partial, int M, int N, int K, int k_chunk,
                    int act) {
  __shared__ __align__(16) int32_t xs[BM][KSTAGE / 4];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * BN + tid;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  int acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += KSTAGE) {
    // 32 rows x 128 int8 = 1024 words: eight per thread
    for (int v = tid; v < BM * (KSTAGE / 4); v += THREADS) {
      const int r = v / (KSTAGE / 4);
      const int c = v % (KSTAGE / 4);
      int32_t val = 0;
      if (m0 + r < M)
        val = *reinterpret_cast<const int32_t*>(x8 + (size_t)(m0 + r) * K + k0 +
                                                4 * c);
      xs[r][c] = val;
    }
    __syncthreads();
    if constexpr (kInt4) {
      const uint32_t* wp = w + (size_t)(k0 / 8) * N + n;
#pragma unroll 4
      for (int c = 0; c < KSTAGE / 8; ++c) {
        const uint32_t wv = wp[(size_t)c * N];
        const int lo = (int)__vsub4(wv & 0x0F0F0F0Fu, 0x08080808u);
        const int hi = (int)__vsub4((wv >> 4) & 0x0F0F0F0Fu, 0x08080808u);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          acc[r] = __dp4a(xs[r][2 * c], lo, acc[r]);
          acc[r] = __dp4a(xs[r][2 * c + 1], hi, acc[r]);
        }
      }
    } else {
      const uint32_t* wp = w + (size_t)(k0 / 4) * N + n;
#pragma unroll 8
      for (int c = 0; c < KSTAGE / 4; ++c) {
        const int wv = (int)wp[(size_t)c * N];
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = __dp4a(xs[r][c], wv, acc[r]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    const size_t o = (size_t)m * N + n;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * M * N + o] = acc[r];
    else if (out32 != nullptr)
      out32[o] = epilogue(acc[r], row_scale[m], col_scale[n], bias, n, act);
    else
      out[o] = __float2bfloat16(
          epilogue(acc[r], row_scale[m], col_scale[n], bias, n, act));
  }
}

__global__ void reduce_kernel(const int* __restrict__ partial, int splits,
                              const float* __restrict__ row_scale,
                              const float* __restrict__ col_scale,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ out32, int M, int N,
                              int act) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  const int n = (int)(i % N);
  const float v = epilogue(s, row_scale[i / N], col_scale[n], bias, n, act);
  if (out32 != nullptr)
    out32[i] = v;
  else
    out[i] = __float2bfloat16(v);
}

// Row quantizer, product kernel, and (split K) the reduce, on one stream.
template <bool kInt4>
int launch_quant_linear(const void* x, const void* w,
                        const void* col_scale, const void* bias, void* out,
                        void* x8, void* row_scale, void* partial, int M, int N,
                        int K, int k_chunk, int splits, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out16 = act == 3 ? nullptr : static_cast<__nv_bfloat16*>(out);
  float* out32 = act == 3 ? static_cast<float*>(out) : nullptr;
  quantize_rows_kernel<<<M, QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), K, static_cast<int8_t*>(x8),
      static_cast<float*>(row_scale));
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  int* part = splits > 1 ? static_cast<int*>(partial) : nullptr;
  quant_linear_kernel<kInt4><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x8), static_cast<const uint32_t*>(w),
      static_cast<const float*>(row_scale),
      static_cast<const float*>(col_scale), static_cast<const float*>(bias),
      out16, out32, part, M, N, K, k_chunk, act);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int blocks = (int)((total + 255) / 256);
    reduce_kernel<<<blocks, 256, 0, s>>>(
        part, splits, static_cast<const float*>(row_scale),
        static_cast<const float*>(col_scale), static_cast<const float*>(bias),
        out16, out32, M, N, act);
  }
  return (int)cudaGetLastError();
}


// ------------------------------ the cluster kernel of K5 and K14 (one launch)

namespace qc {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;              // columns a TMA box: 128 bytes, swizzled
constexpr int KSTEP = 128;           // k a stage
constexpr int ROWS = 32;             // activation rows a block
constexpr int X_BOX_BYTES = ROWS * KSTEP * 2;  // an x box: 32 rows x 128 k
constexpr int STAGES = 8;
constexpr int MAX_CHUNK = 1024;      // k a block
// the dynamic shared memory a block may take: the card's 227 KB less 1 KB
// for the kernel's static shared memory (barriers, row statistics)
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;

// The int8 rows' stride: k_chunk + 32 bytes, so the eight-byte fragment
// loads of four rows fall in four different bank groups.
__device__ __forceinline__ int x8_stride(int k_chunk) { return k_chunk + 32; }

// 4-k groups and their slots inside a 32-deep step of an int8 row: group u
// lies in slot swap01(u) (bits 0 and 1 swapped; its own inverse), so that a
// thread's a0 / a2 fragments (slots 2t and 2t + 1) are one eight-byte load.
__device__ __forceinline__ int swap01(int u) {
  return ((u & 1) << 1) | ((u >> 1) & 1) | (u & 4);
}

// Where k (within a block's range) of an int8 row lies.
__device__ __forceinline__ int x8_offset(int k) {
  return (k & ~31) + 4 * swap01((k & 31) >> 2) + (k & 3);
}

// rint(x / rs) rounded half to even, as the division would give it, from
// x * (1 / rs): for |x / rs| <= 127 the product and the correctly rounded
// quotient lie less than 2^-15 apart, so their rounding to an integer can
// differ only within 2^-14 of a half-integer, where the division is taken.
__device__ __forceinline__ int round_quotient(float x, float rs, float inv) {
  const float y = __fmul_rn(x, inv);
  if (fabsf(fabsf(y - truncf(y)) - 0.5f) < 0x1p-14f)
    return __float2int_rn(__fdiv_rn(x, rs));
  return __float2int_rn(y);
}

// A word of a 128-byte-swizzled box of 32 columns: row r, column c.
__device__ __forceinline__ uint32_t box_word(const unsigned char* box, int r,
                                             int c) {
  return *reinterpret_cast<const uint32_t*>(
      box + r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4);
}

__device__ __forceinline__ uint32_t nibbles(uint32_t w, int high) {
  return __vsub4((high ? w >> 4 : w) & 0x0F0F0F0Fu, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The weight formats: word rows a 128-k stage, and a thread's B fragment
// (b0 for the mma's first k group of the thread, b1 for its second) of
// column c of a box in the 32-deep step kb. A thread (t = lane % 4) holds in
// its A registers the groups of slots 2t and 2t + 1, i.e. groups
// swap01(2t) and swap01(2t + 1); with SWAP_ODD the odd threads give the
// mma the second of them first.
//
// K14: (K/8, N) int32 words of packed nibbles; word row p holds groups 2p
// (low nibbles) and 2p + 1 (high nibbles), so a thread's groups are the low
// (t even) or high (t odd) nibbles of word rows 2 (t >> 1) and + 1.
struct W4 {
  static constexpr int PROWS = KSTEP / 8;
  static constexpr bool SWAP_ODD = false;
  static __device__ __forceinline__ void frag(const unsigned char* box,
                                              int kb, int t, int c,
                                              uint32_t& b0, uint32_t& b1) {
    const int pr = kb * 4 + 2 * (t >> 1);
    b0 = nibbles(box_word(box, pr, c), t & 1);
    b1 = nibbles(box_word(box, pr + 1, c), t & 1);
  }
};

// K5: (K/4, N) words of four int8 weights, one word row a group: the word
// is the B register as it stands. SWAP_ODD makes the eight word rows a
// warp reads at once (groups 0, 3, 4, 7 for b0, then 2, 1, 6, 5 for b1)
// fall in eight different 16-byte chunks of the swizzled box for the warp's
// two column quads: no bank conflict.
struct W8 {
  static constexpr int PROWS = KSTEP / 4;
  static constexpr bool SWAP_ODD = true;
  static __device__ __forceinline__ void frag(const unsigned char* box,
                                              int kb, int t, int c,
                                              uint32_t& b0, uint32_t& b1) {
    const int odd = t & 1;
    b0 = box_word(box, kb * 8 + swap01(2 * t + odd), c);
    b1 = box_word(box, kb * 8 + swap01(2 * t + 1 - odd), c);
  }
};

// A block's shared memory beside its ring: the ring's 1 KB alignment, the
// bf16 rows, the int8 rows, the int32 partial tile (BN + 4 a row).
constexpr int fixed_bytes(int k_chunk, int bn) {
  return 1024 + ROWS * k_chunk * 2 + ROWS * (k_chunk + 32) +
         ROWS * (bn + 4) * 4;
}

// The tiles of a block of BN columns of format W.
template <class W, int BN>
struct Tile {
  static constexpr int BOX_BYTES = W::PROWS * SUB * 4;
  static constexpr int STAGE_BYTES = BN / SUB * BOX_BYTES;
  static constexpr int NT = BN / (8 * WARPS);  // 8-column tiles a warp
  static constexpr int PLD = BN + 4;  // int32 partial tile, 16-byte rows
  static constexpr int SMEM_FULL =
      fixed_bytes(MAX_CHUNK, BN) + STAGES * STAGE_BYTES;
  static constexpr int SMEM_MAX =
      SMEM_FULL < SMEM_LIMIT ? SMEM_FULL : SMEM_LIMIT;
};

// Grid (split, N / BN, ceil(M / ROWS)), one cluster of `split` blocks per
// (BN columns, 32 rows): block r of the cluster sums K over
// [r k_chunk, (r + 1) k_chunk).
template <class W, int BN>
__device__ __forceinline__ void cluster_body(
    const CUtensorMap* tw, const CUtensorMap* tx,
    const float* __restrict__ col_scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out16, float* __restrict__ out32, int M,
    int N, int K, int k_chunk, int stages, int act) {
  using T = Tile<W, BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t x_full;
  __shared__ float amax_s[ROWS];
  __shared__ float rs_s[ROWS], inv_s[ROWS];

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* base = smem_raw + (ring - raw);
  const int rank = sm90::cluster_rank(), split = (int)gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * ROWS;
  const int mr = min(ROWS, M - m0);
  const int k_lo = rank * k_chunk;
  const int kn = min(K, k_lo + k_chunk) - k_lo;  // > 0: ranges none empty
  const int steps = kn / KSTEP;
  const int xs = x8_stride(k_chunk);
  __nv_bfloat16* xb =
      reinterpret_cast<__nv_bfloat16*>(base + stages * T::STAGE_BYTES);
  int8_t* x8 = reinterpret_cast<int8_t*>(xb + ROWS * k_chunk);
  int* part = reinterpret_cast<int*>(x8 + ROWS * xs);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  auto fetch = [&](int i) {
    const int s = i % stages;
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, T::STAGE_BYTES);
    const int row = k_lo / (KSTEP / W::PROWS) + i * W::PROWS;
#pragma unroll
    for (int j = 0; j < BN / SUB; ++j)
      sm90::tma_load(ring + s * T::STAGE_BYTES + j * T::BOX_BYTES, tw, bar,
                     n0 + j * SUB, row);
  };
  // thread 0 starts every load: this block's K range of the rows (one box
  // of 32 rows x 128 k a step, rows past M zero) and the first stages of
  // weights
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    sm90::mbar_init(sm90::smem_u32(&x_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm90::mbar_expect_tx(sm90::smem_u32(&x_full), steps * X_BOX_BYTES);
    for (int i = 0; i < steps; ++i)
      sm90::tma_load(sm90::smem_u32(xb) + i * X_BOX_BYTES, tx,
                     sm90::smem_u32(&x_full), k_lo + i * KSTEP, m0);
    for (int i = 0; i < min(stages, steps); ++i) fetch(i);
  }
  __syncthreads();  // the barriers are initialised
  sm90::mbar_wait(sm90::smem_u32(&x_full), 0);
  // x row r, k at (k / 128) * X_BOX + r * 128 + k % 128 of the staging
  auto xs_at = [&](int r, int k) {
    return xb + (k / KSTEP) * (ROWS * KSTEP) + r * KSTEP + k % KSTEP;
  };
  // each row's partial max-abs, a warp a row, by shuffles
  const int vecs = kn / 8;  // 16-byte vectors a row (a multiple of 16)
  for (int r = warp; r < mr; r += WARPS) {
    float a = 0.0f;
    for (int c = lane; c < vecs; c += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(xs_at(r, 8 * c));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a = fmaxf(a, fmaxf(fabsf(sm90::bf16_lo(w[j])),
                           fabsf(sm90::bf16_hi(w[j]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) amax_s[r] = a;
  }
  sm90::cluster_sync();  // every block's partial maxima are published
  if (tid < mr) {
    float p[sm90::MAX_CLUSTER];
    sm90::load_peers(&amax_s[tid], split, p);
    float a = p[0];
#pragma unroll
    for (int q = 1; q < sm90::MAX_CLUSTER; ++q)
      if (q < split) a = fmaxf(a, p[q]);
    const float rs = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
    rs_s[tid] = rs;
    inv_s[tid] = __frcp_rn(rs);
  }
  __syncthreads();
  // the int8 rows (x / scale rounded half to even, no clip: |x| / scale is
  // at most 127), in fragment order; rows past M of a 16-row tile are zero
  // (a warp a row, 8 k a lane)
  const int mtiles = (mr + 15) / 16;
  for (int r = warp; r < mtiles * 16; r += WARPS) {
    int8_t* dst = x8 + r * xs;
    const bool real = r < mr;
    const float rs = real ? rs_s[r] : 1.0f, inv = real ? inv_s[r] : 1.0f;
    for (int c = lane; c < kn / 8; c += 32) {
      uint32_t packed[2] = {0u, 0u};
      if (real) {
        const uint4 v = *reinterpret_cast<const uint4*>(xs_at(r, 8 * c));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lo = round_quotient(sm90::bf16_lo(w[j]), rs, inv) & 0xff;
          const int hi = round_quotient(sm90::bf16_hi(w[j]), rs, inv) & 0xff;
          packed[j / 2] |= (uint32_t)(lo | hi << 8) << (16 * (j % 2));
        }
      }
      *reinterpret_cast<uint32_t*>(dst + x8_offset(8 * c)) = packed[0];
      *reinterpret_cast<uint32_t*>(dst + x8_offset(8 * c + 4)) = packed[1];
    }
  }
  __syncthreads();

  // the product: warp w on the 8-column tiles [64 j + 8 w, 64 j + 8 w + 8)
  const int g = lane / 4, t = lane % 4;
  const bool swap = W::SWAP_ODD && (t & 1);
  int acc[2][T::NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0;
  const bool refill = stages < steps;
  for (int i = 0; i < steps; ++i) {
    const int s = i % stages;
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / stages) & 1);
    const unsigned char* slot = base + s * T::STAGE_BYTES;
#pragma unroll
    for (int kb = 0; kb < KSTEP / 32; ++kb) {
      const int kx = i * KSTEP + kb * 32 + 8 * t;
      uint2 a[2][2];  // rows g and g + 8 of each 16-row tile
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mtiles) {
          a[mt][0] =
              *reinterpret_cast<const uint2*>(x8 + (mt * 16 + g) * xs + kx);
          a[mt][1] = *reinterpret_cast<const uint2*>(
              x8 + (mt * 16 + g + 8) * xs + kx);
        }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = j * 8 * WARPS + warp * 8 + g;
        uint32_t b0, b1;
        W::frag(slot + col / SUB * T::BOX_BYTES, kb, t, col % SUB, b0, b1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mtiles)
            mma_s8(acc[mt][j], swap ? a[mt][0].y : a[mt][0].x,
                   swap ? a[mt][1].y : a[mt][1].x,
                   swap ? a[mt][0].x : a[mt][0].y,
                   swap ? a[mt][1].x : a[mt][1].y, b0, b1);
      }
    }
    if (refill) {
      __syncthreads();  // the slot is free
      if (tid == 0 && i + stages < steps) fetch(i + stages);
    }
  }
  // the block's int32 partial tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    if (mt < mtiles) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int c2 = j * 8 * WARPS + warp * 8 + 2 * t, row = mt * 16 + g;
        *reinterpret_cast<int2*>(part + row * T::PLD + c2) =
            make_int2(acc[mt][j][0], acc[mt][j][1]);
        *reinterpret_cast<int2*>(part + (row + 8) * T::PLD + c2) =
            make_int2(acc[mt][j][2], acc[mt][j][3]);
      }
    }
  sm90::cluster_sync();  // every block's partial tile is staged
  // this block's share of the tile's outputs, four columns at a time: the
  // exact partials of every rank, then the epilogue in the twin's order
  constexpr int G = BN / 4;
  for (int e = rank * THREADS + tid; e < mr * G; e += split * THREADS) {
    const int r = e / G, c = (e % G) * 4;
    int4 u[sm90::MAX_CLUSTER];  // every load in flight before the sum
#pragma unroll
    for (int q = 0; q < sm90::MAX_CLUSTER; ++q)
      if (q < split) u[q] = sm90::load_peer_int4(part + r * T::PLD + c, q);
    int4 v = u[0];
#pragma unroll
    for (int q = 1; q < sm90::MAX_CLUSTER; ++q)
      if (q < split) {
        v.x += u[q].x;
        v.y += u[q].y;
        v.z += u[q].z;
        v.w += u[q].w;
      }
    const int s4[4] = {v.x, v.y, v.z, v.w};
    const float rs = rs_s[r];
    const size_t o = (size_t)(m0 + r) * N + n0 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = epilogue(s4[j], rs, col_scale[n0 + c + j], bias,
                               n0 + c + j, act);
      if (out32 != nullptr)
        out32[o + j] = y;
      else
        out16[o + j] = __float2bfloat16(y);
    }
  }
  sm90::cluster_sync();  // no block leaves while another reads its partials
}

// K14 (W4A8), 64 columns a block.
__global__ void __launch_bounds__(THREADS)
    quant4_cluster(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out16,
                   float* __restrict__ out32, int M, int N, int K,
                   int k_chunk, int stages, int act) {
  cluster_body<W4, 64>(&tw, &tx, col_scale, bias, out16, out32, M, N, K,
                       k_chunk, stages, act);
}

// K5 (W8A8), BN (64 or 128) columns a block.
template <int BN>
__global__ void __launch_bounds__(THREADS)
    quant8_cluster(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out16,
                   float* __restrict__ out32, int M, int N, int K,
                   int k_chunk, int stages, int act) {
  cluster_body<W8, BN>(&tw, &tx, col_scale, bias, out16, out32, M, N, K,
                       k_chunk, stages, act);
}

template <class W, int BN, class Kernel>
int launch(Kernel kernel, const void* x, const void* w, const void* col_scale,
           const void* bias, void* out, int M, int N, int K, int k_chunk,
           int split, int act, cudaStream_t s) {
  using T = Tile<W, BN>;
  if (M < 1 || N % BN != 0 || K % KSTEP != 0 || k_chunk <= 0 ||
      k_chunk % KSTEP != 0 || k_chunk > MAX_CHUNK || split < 1 ||
      split > sm90::MAX_CLUSTER || (long long)k_chunk * (split - 1) >= K ||
      (long long)k_chunk * split < K || (act != 3 && bias == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  int rc = sm90::encode_map(&tw, w, (long long)K / KSTEP * W::PROWS, N, N,
                            W::PROWS, SUB, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_DATA_TYPE_INT32, 4);
  if (rc == 0)
    rc = sm90::encode_map(&tx, x, M, K, K, ROWS, KSTEP,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  // every k-step of the block in flight where the shared memory holds them
  const int stages =
      std::min({STAGES, k_chunk / KSTEP,
                (SMEM_LIMIT - fixed_bytes(k_chunk, BN)) / T::STAGE_BYTES});
  const int smem = fixed_bytes(k_chunk, BN) + stages * T::STAGE_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const bool f32 = act == 3;
  return sm90::launch_cluster(
      kernel, dim3(split, N / BN, (M + ROWS - 1) / ROWS), THREADS, smem,
      split, s, tw, tx, static_cast<const float*>(col_scale),
      static_cast<const float*>(bias),
      f32 ? nullptr : static_cast<__nv_bfloat16*>(out),
      f32 ? static_cast<float*>(out) : nullptr, M, N, K, k_chunk, stages, act);
}

}  // namespace qc

}  // namespace

// The three-launch form (`variant="simt"`). x8 (M, K) int8 and row_scale
// (M,) fp32 are scratch the wrapper allocates. splits == 1: two launches,
// epilogue in the product kernel. splits > 1: `partial` holds (splits, M, N)
// int32 scratch; each z-slice covers k_chunk (a multiple of 128) of K and a
// third launch reduces. act == 3: `out` is (M, N) fp32 and `bias` may be
// null.
extern "C" int acai_quant_linear_bias_act(const void* x, const void* w4,
                                          const void* col_scale,
                                          const void* bias, void* out,
                                          void* x8, void* row_scale,
                                          void* partial, int M, int N, int K,
                                          int k_chunk, int splits, int act,
                                          void* stream) {
  return launch_quant_linear<false>(
      x, w4, col_scale, bias, out, x8, row_scale,
      partial, M, N, K, k_chunk, splits, act, stream);
}

// K14's three-launch form: as above with (K/8, N) int32 words of packed
// int4 weights.
extern "C" int acai_quant4_linear_bias_act(const void* x, const void* w8k,
                                           const void* col_scale,
                                           const void* bias, void* out,
                                           void* x8, void* row_scale,
                                           void* partial, int M, int N, int K,
                                           int k_chunk, int splits, int act,
                                           void* stream) {
  return launch_quant_linear<true>(
      x, w8k, col_scale, bias, out, x8, row_scale,
      partial, M, N, K, k_chunk, splits, act, stream);
}

// K5 in one launch (`quant8_cluster<bn>`): x (M, K) bf16, 16-byte aligned;
// (K/4, N, 4) int8 weights, 16-byte aligned; K % 128 == 0, N % bn == 0, bn
// 64 or 128; K split in `split` (<= 8, one cluster) ranges of k_chunk (a
// multiple of 128, at most 1024), none empty. act == 3: `out` is (M, N)
// fp32 and `bias` is null.
extern "C" int acai_quant_linear_bias_act_cluster(
    const void* x, const void* w4, const void* col_scale, const void* bias,
    void* out, int M, int N, int K, int k_chunk, int split, int bn, int act,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return qc::launch<qc::W8, 64>(qc::quant8_cluster<64>, x, w4, col_scale,
                                  bias, out, M, N, K, k_chunk, split, act, s);
  if (bn == 128)
    return qc::launch<qc::W8, 128>(qc::quant8_cluster<128>, x, w4, col_scale,
                                   bias, out, M, N, K, k_chunk, split, act, s);
  return (int)cudaErrorInvalidValue;
}

// K14 in one launch (`quant4_cluster`): as above with (K/8, N) int32 words
// of packed int4 weights and 64 columns a block (N % 64 == 0).
extern "C" int acai_quant4_linear_bias_act_cluster(
    const void* x, const void* w8k, const void* col_scale, const void* bias,
    void* out, int M, int N, int K, int k_chunk, int split, int act,
    void* stream) {
  return qc::launch<qc::W4, 64>(qc::quant4_cluster, x, w8k, col_scale, bias,
                                out, M, N, K, k_chunk, split, act,
                                static_cast<cudaStream_t>(stream));
}

// The resource report (func_attrs.cuh): the cluster kernels, which every
// `split{s}` launch runs, at their largest dynamic shared memory; the
// kernels of the three-launch forms (`simt`).
static const AcaiKernelEntry kResources[] = {
    {"quant_linear_bias_act|split|quant8_cluster<64>",
     reinterpret_cast<const void*>(&qc::quant8_cluster<64>), qc::THREADS,
     qc::Tile<qc::W8, 64>::SMEM_MAX},
    {"quant_linear_bias_act|split|quant8_cluster<128>",
     reinterpret_cast<const void*>(&qc::quant8_cluster<128>), qc::THREADS,
     qc::Tile<qc::W8, 128>::SMEM_MAX},
    {"quant4_linear_bias_act|split|quant4_cluster",
     reinterpret_cast<const void*>(&qc::quant4_cluster), qc::THREADS,
     qc::Tile<qc::W4, 64>::SMEM_MAX},
    ACAI_KERNEL("quant4_linear_bias_act", "simt", quant_linear_kernel<true>,
                THREADS, 0),
    ACAI_KERNEL("quant_linear_bias_act", "simt", quant_linear_kernel<false>,
                THREADS, 0),
    ACAI_KERNEL("quant_linear_bias_act", "simt", quantize_rows_kernel,
                QTHREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
