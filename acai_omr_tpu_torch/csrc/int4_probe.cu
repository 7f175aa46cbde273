// K20 int4_delivery_gemm and K21 int4_unpack: the int4 delivery and unpack
// schemes of the W4A8 decode product, one template each.
//
// K20 replaces tools/int4_probe.py `run_variant` (:96, pallas_call :112) and
// `time_variant` (:130, pallas_call :147) of the JAX package: out (bt, cout)
// int32 = x (bt, cin) int8 @ W (cin, cout), W's rows 0..cin/2 the int4 values
// `lo`, the rest `hi`, exact. The schemes keep the TPU tool's names and say
// how W reaches the dot on Hopper:
//   i8ref     full int8 weights in K5's K-packed layout (cin/4, cout, 4): a
//             word is four k of one column, a B register as it stands;
//   s4dot     K14's layout (cin/8, cout) int32, eight K rows to a word,
//             unpacked in registers into the B registers (K14's single k
//             permutation, applied to the x rows too);
//   s4conv    the same words widened to int8 into shared memory by the block
//             first (the TPU's astype(int8) before the dot), i8ref's layout,
//             then read as i8ref reads its weights;
//   i8shift   the TPU's bytes (cin/2, cout) int8 holding (hi << 4) | (lo + 8);
//             a thread loads one 32-bit word (four columns) of four rows,
//             transposes the 4x4 bytes with __byte_perm and unpacks with
//             per-byte shifts and masks into a lo and a hi B register of each
//             of its four columns; x[:, :cin/2] dots lo, x[:, cin/2:] hi;
//   f32unpack the same bytes, each unpacked through fp32 floor(b / 16).
// Bound: the weight bytes (2 MiB at 1024 -> 4096 in int4, 4 MiB in int8)
// over 3.35 TB/s; the products are 67 MOP, far below the int8 peak, so what
// the design has to beat is a fixed cost, not the stream.
//
// Design (`strip_kernel`, one launch, no memset, no atomics): a block owns
// a strip of 32 output columns over the whole contraction (cout / 32 blocks:
// 128 at 1024 -> 4096). Its threads issue every 16-byte piece of the strip
// at once with cp.async, in stages of 256 k: the x rows' two 128-k boxes
// (rows padded with zeros to R = 8, 16 or 32) and the weight rows (i8ref 64
// word rows, the int4 words 32, the bytes 128 rows x 32 columns), laid out
// in shared memory as a 128-byte-swizzled TMA box would be (the bytes'
// 32-byte rows plain); one wait, one barrier; where the strip is deeper
// than 8 stages or 96 KB, rounds of that many. (TMA boxes on one mbarrier a
// stage read no faster on the card, and need a tensor map each call.) The
// products run on the tensor cores, `mma.sync` m16n8k32 s8 x s8 -> s32, a
// warp a 32-deep k-step of each stage over the strip's four 8-column tiles
// and R / 16 row tiles (R = 8: the tile's upper rows are zero registers),
// two stages at a time into two accumulator sets so that their loads and
// products overlap. An integer sum is the same in any order, so each format
// picks the k order of its B registers and the x rows follow it: i8ref and
// s4conv K5's (bank-conflict free on the swizzled layout), s4dot K14's, the
// byte formats the order their transposed words come in (rotated by the
// thread's quad index, so the four rows a warp reads at once fall in
// distinct banks), and their output columns 4 g + j so that a thread's word
// is its four columns. The eight warps' int32 tiles are added in shared
// memory. Where the strips alone cannot fill the card and a strip is deep
// (cout = 1024 at cin = 4096), the contraction is split across a
// thread-block cluster of up to 8 blocks (ops/int4_probe_kernels.strip_plan),
// whose exact tiles meet through distributed shared memory in rank order.
// What sets its time on the card (PERF.md section 6): the rate at which one
// SM's loads of its strip and of x's rows arrive, and a fixed cost of the
// launch and the epilogue, not the weight bytes' bound.
//
// The form it replaced (`int4_gemm_kernel`, kept as the yardstick, variant
// "atomic"): 128 threads, one column (word layouts) or four (byte layouts)
// a thread, one 32-bit weight load a row, `__dp4a`; the contraction split
// over blockIdx.y so that about 264 blocks stream the weights, the splits'
// int32 sums added with integer atomics into an output the wrapper zeroes
// first (two device kernels a call); x's columns of the split staged in
// shared memory, rows padded with zeros to R (8, 16 or 32).
//
// K21 replaces tools/unpack_probe.py `run` (:112, pallas_call :124) and its
// five kernels (`KERNELS` :108): packed (half, cols) int8 -> (2 half, cols)
// int8, lo rows then hi rows, `reps` times in the kernel with a carried
// perturbation as the TPU's fori_loop has. Bound per unpack: 2 MiB in, 4 MiB
// out at the tool's (512, 4096); with the output in L2 across the reps, what
// a rep costs is the scheme's arithmetic and its stores.
//
// The word-wide kernels (`unpack_words_kernel`, `unpack_eyedot_mma_kernel`):
// a grid sized to the card (ops/int4_probe_kernels.unpack_plan) in which a
// thread owns four 16-byte pieces of the packed block (64 bytes), the four
// loads issued before any arithmetic, rounds of four where the block is
// larger than one pass of the grid; every scheme works on whole 32-bit words
// in the arithmetic its name says:
//   i32    four bytes at once with shifts and masks: lo = s((b & 0x0F0F0F0F)
//          ^ 0x08080808), hi = s((b >> 4) & 0x0F0F0F0F), s(n) = n + (n &
//          0x08080808) * 0x1E spreading each nibble's sign over its byte;
//   i16    16-bit PTX on the word's two halves, two bytes each: lo = ((h &
//          0x0F0F) + 0x7878) ^ 0x8080, hi = (((h >> 4) & 0x0F0F) + 0x7878) ^
//          0x7878 (no sum carries out of its byte);
//   i8div  byte lanes: floor(b / 16) as a per-byte arithmetic shift (the
//          high nibble shifted down, the byte's sign filled above it), lo = b
//          - (16 hi + 8) by __vsub4;
//   f32    each byte sign-extended to 32 bits by prmt, made fp32 exactly
//          through the exponent field (an integer add and an fp32 subtract,
//          as cvt runs at a quarter of the fp32 rate), hi = floorf(b / 16),
//          lo = b - 16 hi - 8 in fp32, both back through the exponent field
//          and gathered into words by prmt;
//   eyedot the identity product on the tensor cores, `mma.sync` m16n8k16 s8
//          -> s32: a warp a 16 x 128 tile, lane (g, t) loading rows 4t ..
//          4t + 3 of column group G(g) = 4 (g & 1) + g / 2 (16 bytes), a 4 x
//          4 byte transpose by prmt making each word four K rows of one
//          column (B registers straight from the loads), a constant identity
//          A fragment; the accumulators are the bytes again, lane (g, t)
//          holding rows g, g + 8 of column groups t and 4 + t, so a warp's
//          store writes whole sectors; floored as f32 does, in registers; no
//          shared memory and no __syncwarp a rep.
// What stays from the kernels they replace: the reps loop with its carried
// perturbation (__vadd4 of carry x 0x01010101 on the packed words, carry =
// the rep's first lo word AND a kernel argument that is 0 at run time, which
// the compiler cannot prove zero), the stores by st.global from inline asm
// (so no rep folds, is hoisted or merged), lo rows then hi rows.
//
// The forms they replaced (`unpack_kernel`, `unpack_eyedot_kernel`, kept as
// the yardstick, variant "bytewise"): a thread one 16-byte piece (eyedot: a
// warp a 16 x 16 tile through wmma and shared memory, 8 bytes a lane) in a
// single wave, one load in flight, each byte extracted, unpacked by the
// scheme's arithmetic on it alone (f32: float convert and floorf; i32: int32
// shifts; i16: int16 shifts in 16-bit PTX; i8div: C division on int8
// corrected to floor division) and repacked by shift-or; eyedot's tile, its
// fragments and its int32 accumulator through shared memory every rep.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "func_attrs.cuh"
#include "sm90_cluster.cuh"

namespace {

enum GemmScheme { I8REF = 0, S4DOT = 1, S4CONV = 2, I8SHIFT = 3, F32UNPACK = 4 };
enum UnpackScheme { U_F32 = 0, U_I32 = 1, U_I16 = 2, U_I8DIV = 3, U_EYEDOT = 4 };

constexpr int THREADS = 128;
constexpr int UNIT = 64;  // x columns per contraction unit

// bytes (hi << 4) | (lo + 8), four to a word, unpacked with shifts and masks
__device__ __forceinline__ void unpack_shift(uint32_t b, int& lo, int& hi) {
  lo = (int)__vsub4(b & 0x0F0F0F0Fu, 0x08080808u);
  const uint32_t h = (b >> 4) & 0x0F0F0F0Fu;       // the high nibble, unsigned
  hi = (int)__vsub4(h ^ 0x08080808u, 0x08080808u);  // sign-extended
}

// the same bytes through fp32: hi = floor(b / 16), lo = b - 16 hi - 8
__device__ __forceinline__ void unpack_float(uint32_t b, int& lo, int& hi) {
  uint32_t l = 0, h = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = (float)(int8_t)(b >> (8 * j));
    const float fh = floorf(v * 0.0625f);
    const float fl = v - 16.0f * fh - 8.0f;
    h |= ((uint32_t)__float2int_rz(fh) & 0xFFu) << (8 * j);
    l |= ((uint32_t)__float2int_rz(fl) & 0xFFu) << (8 * j);
  }
  lo = (int)l;
  hi = (int)h;
}

// a[i] holds four columns of row i; c[j] gets four rows of column j
__device__ __forceinline__ void transpose4x4(const uint32_t a[4], uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <int S, int R>
__global__ void __launch_bounds__(THREADS)
int4_gemm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ w,
                 int* __restrict__ out, int BT, int CIN, int COUT,
                 int chunk_units, int atomic) {
  extern __shared__ int xs[];  // (R, W) words of x
  const int tid = threadIdx.x;
  const int u0 = blockIdx.y * chunk_units;
  const int W = chunk_units * (UNIT / 4);
  const int HW = W / 2;
  const int half = CIN / 2;
  for (int v = tid; v < R * W; v += THREADS) {
    const int r = v / W, c = v % W;
    int col;
    if constexpr (S >= I8SHIFT)  // the split's lo columns, then its hi columns
      col = c < HW ? u0 * (UNIT / 2) + 4 * c
                   : half + u0 * (UNIT / 2) + 4 * (c - HW);
    else
      col = u0 * UNIT + 4 * c;
    xs[v] = r < BT ? *reinterpret_cast<const int*>(x + (size_t)r * CIN + col)
                   : 0;
  }
  __syncthreads();

  if constexpr (S <= S4CONV) {
    const int n = blockIdx.x * THREADS + tid;
    int acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0;
    if constexpr (S == I8REF) {
      const uint32_t* wp = w + (size_t)(u0 * (UNIT / 4)) * COUT + n;
#pragma unroll 4
      for (int c = 0; c < W; ++c) {
        const int wv = (int)wp[(size_t)c * COUT];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = __dp4a(xs[r * W + c], wv, acc[r]);
      }
    } else if constexpr (S == S4DOT) {
      const uint32_t* wp = w + (size_t)(u0 * (UNIT / 8)) * COUT + n;
#pragma unroll 4
      for (int c = 0; c < W / 2; ++c) {
        const uint32_t wv = wp[(size_t)c * COUT];
        const int lo = (int)__vsub4(wv & 0x0F0F0F0Fu, 0x08080808u);
        const int hi = (int)__vsub4((wv >> 4) & 0x0F0F0F0Fu, 0x08080808u);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = __dp4a(xs[r * W + 2 * c], lo, acc[r]);
          acc[r] = __dp4a(xs[r * W + 2 * c + 1], hi, acc[r]);
        }
      }
    } else {  // S4CONV: one unit of 64 K rows widened into shared memory
      __shared__ int ws[UNIT / 4][THREADS];
      const uint32_t* wp = w + (size_t)(u0 * (UNIT / 8)) * COUT + n;
      for (int u = 0; u < chunk_units; ++u) {
#pragma unroll
        for (int c = 0; c < UNIT / 8; ++c) {
          const uint32_t wv = wp[(size_t)(u * (UNIT / 8) + c) * COUT];
          ws[2 * c][tid] = (int)__vsub4(wv & 0x0F0F0F0Fu, 0x08080808u);
          ws[2 * c + 1][tid] = (int)__vsub4((wv >> 4) & 0x0F0F0F0Fu, 0x08080808u);
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < UNIT / 4; ++c) {
          const int wv = ws[c][tid];
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = __dp4a(xs[r * W + u * (UNIT / 4) + c], wv, acc[r]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= BT) break;
      int* o = out + (size_t)r * COUT + n;
      if (atomic) atomicAdd(o, acc[r]);
      else *o = acc[r];
    }
  } else {
    const int n4 = (blockIdx.x * THREADS + tid) * 4;  // four output columns
    const int q4 = COUT / 4;
    const uint32_t* wb = w + (size_t)(u0 * (UNIT / 2)) * q4 + n4 / 4;
    int acc[4][R];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[j][r] = 0;
#pragma unroll 2
    for (int q = 0; q < HW; ++q) {  // four pair rows (lo and hi) at a time
      uint32_t b[4], col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = wb[(size_t)(4 * q + i) * q4];
      transpose4x4(b, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int lo, hi;
        if constexpr (S == I8SHIFT) unpack_shift(col[j], lo, hi);
        else unpack_float(col[j], lo, hi);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[j][r] = __dp4a(xs[r * W + q], lo, acc[j][r]);
          acc[j][r] = __dp4a(xs[r * W + HW + q], hi, acc[j][r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= BT) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int* o = out + (size_t)r * COUT + n4 + j;
        if (atomic) atomicAdd(o, acc[j][r]);
        else *o = acc[j][r];
      }
    }
  }
}

template <int S, int R>
int launch_gemm(const void* x, const void* w, void* out, int bt, int cin,
                int cout, int splits, cudaStream_t s) {
  const int cols = S >= I8SHIFT ? 4 * THREADS : THREADS;
  const int chunk_units = cin / UNIT / splits;
  const dim3 grid(cout / cols, splits);
  const size_t smem = (size_t)R * chunk_units * UNIT;
  int4_gemm_kernel<S, R><<<grid, THREADS, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int*>(out), bt, cin, cout, chunk_units, splits > 1);
  return (int)cudaGetLastError();
}

template <int S>
int launch_gemm_rows(const void* x, const void* w, void* out, int bt, int cin,
                     int cout, int splits, cudaStream_t s) {
  if (bt <= 8) return launch_gemm<S, 8>(x, w, out, bt, cin, cout, splits, s);
  if (bt <= 16) return launch_gemm<S, 16>(x, w, out, bt, cin, cout, splits, s);
  return launch_gemm<S, 32>(x, w, out, bt, cin, cout, splits, s);
}

// ---------------------------------------------------------------------------
// K20: the strip kernel
// ---------------------------------------------------------------------------

namespace dg {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 32;         // output columns a block: one strip
constexpr int KS = 256;        // k a stage: eight 32-deep k-steps, one a warp
constexpr int XBOX = 128;      // k (bytes) of an x box: 128-byte swizzle
constexpr int MAX_SLOTS = 8;
constexpr int RING_BUDGET = 96 * 1024;  // two blocks an SM where it holds
constexpr int WIDE_BYTES = KS / 4 * BN * 4;  // s4conv's widened stage

// bytes of a stage's weight box
__host__ __device__ constexpr int w_stage_bytes(int scheme) {
  return scheme == I8REF ? KS / 4 * BN * 4
         : scheme >= I8SHIFT ? KS / 2 * BN
                             : KS / 8 * BN * 4;
}

// bytes of a stage: two x boxes of R rows x 128 k, the weight box (each a
// multiple of 1 KB, so every box keeps the swizzle's 1 KB alignment)
__host__ __device__ constexpr int stage_bytes(int scheme, int rows) {
  return 2 * rows * XBOX + w_stage_bytes(scheme);
}

// the ring's stages a launch holds: every stage of the strip where the
// budget allows, at most MAX_SLOTS, at least one
__host__ __device__ constexpr int ring_slots(int scheme, int rows,
                                             int stages) {
  const int fit = RING_BUDGET / stage_bytes(scheme, rows);
  const int n = stages < MAX_SLOTS ? stages : MAX_SLOTS;
  return n < fit ? n : (fit > 1 ? fit : 1);
}

// the dynamic shared memory of a launch with `slots` stages: the 1 KB
// alignment, the slots (the warps' int32 tiles reuse them), s4conv's
// widened stages
__host__ __device__ constexpr int dyn_bytes(int scheme, int rows, int slots) {
  return 1024 +
         (slots * stage_bytes(scheme, rows) > WARPS * rows * BN * 4
              ? slots * stage_bytes(scheme, rows)
              : WARPS * rows * BN * 4) +
         (scheme == S4CONV ? slots * WIDE_BYTES : 0);
}

// 4-k groups of a 32-deep step (K5's permutation): bits 0 and 1 swapped
__device__ __forceinline__ int swap01(int u) {
  return ((u & 1) << 1) | ((u >> 1) & 1) | (u & 4);
}

// word c of row r of a 128-byte-swizzled box of 32 words a row
__device__ __forceinline__ uint32_t* box_word(unsigned char* box, int r,
                                              int c) {
  return reinterpret_cast<uint32_t*>(box + r * 128 +
                                     (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
}

// bytes k .. k + 3 (k % 4 == 0) of row r of a 128-byte-swizzled x box
__device__ __forceinline__ uint32_t x_word(const unsigned char* box, int r,
                                           int k) {
  return *reinterpret_cast<const uint32_t*>(
      box + r * 128 + (((k >> 4) ^ (r & 7)) << 4) + (k & 15));
}

__device__ __forceinline__ uint32_t nibbles(uint32_t w, int high) {
  return __vsub4((high ? w >> 4 : w) & 0x0F0F0F0Fu, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 16-byte piece of global memory into shared memory, asynchronously
// (the thread's current cp.async group); zeros where `valid` is false.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
          sm90::smem_u32(dst)),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}

// Grid (split, cout / 32): block (r, y) sums k in [r k_chunk, (r + 1)
// k_chunk) of columns [32 y, 32 y + 32); with split > 1 the split is one
// cluster. R: x rows a stage (bt padded with zeros), 8, 16 or 32.
template <int S, int R>
__global__ void __launch_bounds__(THREADS)
    strip_kernel(const int8_t* __restrict__ x, const unsigned char* __restrict__ w,
                 int* __restrict__ out, int bt, int cin, int cout,
                 int k_chunk, int slots) {
  constexpr bool BYTES = S >= I8SHIFT;
  constexpr int MT = R == 32 ? 2 : 1;  // 16-row tiles
  constexpr int XB = R * XBOX;         // bytes of an x box
  constexpr int STAGE = stage_bytes(S, R);
  constexpr int WROW = BYTES ? BN : BN * 4;      // bytes of a weight row
  constexpr int WROWS = w_stage_bytes(S) / WROW;  // weight rows a stage
  constexpr int XPIECES = 2 * R * (XBOX / 16);    // 16-byte pieces a stage
  constexpr int PIECES = XPIECES + WROWS * (WROW / 16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tile[R * BN];  // the block's sum, read by its cluster

  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int k_lo = rank * k_chunk;
  const int stages = (k_chunk + KS - 1) / KS;
  const int w_rows = BYTES ? cin / 2 : cin / (S == I8REF ? 4 : 8);
  unsigned char* wide =
      base + max(slots * STAGE, WARPS * R * BN * 4);  // s4conv only

  // every 16-byte piece of stage i into slot sl, laid out as a 128-byte
  // swizzled box would be (the byte layouts' 32-byte weight rows plain)
  auto fetch = [&](int i, int slot) {
    unsigned char* dst = base + slot * STAGE;
    for (int v = tid; v < PIECES; v += THREADS) {
      if (v < XPIECES) {  // x: box b, row r, piece p
        const int b = v / (R * 8), r = (v / 8) % R, p = v % 8;
        const int col = BYTES ? (b ? cin / 2 : 0) + k_lo / 2 + i * (KS / 2)
                              : k_lo + i * KS + b * XBOX;
        const int k = col + 16 * p;
        const bool ok = r < bt && k < cin;
        copy16(dst + b * XB + r * 128 + ((p ^ (r & 7)) << 4),
               ok ? x + (size_t)r * cin + k : x, ok);
      } else {  // the weights: row q of the stage, piece p
        const int u = v - XPIECES, q = u / (WROW / 16), p = u % (WROW / 16);
        const int row = (BYTES ? k_lo / 2 + i * (KS / 2)
                               : (k_lo + i * KS) / (S == I8REF ? 4 : 8)) + q;
        const bool ok = row < w_rows;
        unsigned char* to = dst + 2 * XB + q * WROW +
                            (BYTES ? 16 * p : ((p ^ (q & 7)) << 4));
        copy16(to, ok ? w + ((size_t)row * cout + n0) * (WROW / BN) + 16 * p
                      : w, ok);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // two accumulator sets, even and odd stages, so that a warp's k-steps of
  // consecutive stages overlap; added at the end (integers: any order)
  int acc[2][MT][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][m][j][e] = 0;
  // the thread's two 4-k groups of a step (word formats): K5's order for the
  // int8 words, K14's for the nibbles
  const int odd = (S == S4DOT) ? 0 : (t & 1);
  const int p0 = swap01(2 * t + odd), p1 = swap01(2 * t + 1 - odd);

  // warp w's k-step (k 32 w .. 32 w + 31) of the stage in slot `sl`
  auto step = [&](int sl, int (&c)[MT][4][4]) {
    const unsigned char* st = base + sl * STAGE;
    const unsigned char* xa = st;
    const unsigned char* xb = st + XB;
    const unsigned char* wbox = st + 2 * XB;
    uint32_t a[MT][4];
    if constexpr (BYTES) {
      // packed rows pr .. pr + 3 of the stage: the lo k of x's first box,
      // the hi k of its second, bytes in the order the rotated loads give
      const int pr = 16 * warp + 4 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = 16 * m + g;
        const uint32_t lo0 = x_word(xa, r, pr), hi0 = x_word(xb, r, pr);
        a[m][0] = __funnelshift_r(lo0, lo0, 8 * t);
        a[m][2] = __funnelshift_r(hi0, hi0, 8 * t);
        if constexpr (R > 8) {
          const uint32_t lo1 = x_word(xa, r + 8, pr), hi1 = x_word(xb, r + 8, pr);
          a[m][1] = __funnelshift_r(lo1, lo1, 8 * t);
          a[m][3] = __funnelshift_r(hi1, hi1, 8 * t);
        } else {
          a[m][1] = a[m][3] = 0u;
        }
      }
      // row pr + ((q + t) & 3), columns 4 g .. 4 g + 3 (32 bytes a row)
      uint32_t wv[4], col[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const uint32_t*>(
            wbox + (pr + ((q + t) & 3)) * BN + 4 * g);
      transpose4x4(wv, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column 4 g + j
        int lo, hi;
        if constexpr (S == I8SHIFT) unpack_shift(col[j], lo, hi);
        else unpack_float(col[j], lo, hi);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_s8(c[m][j], a[m][0], a[m][1], a[m][2], a[m][3], (uint32_t)lo,
                 (uint32_t)hi);
      }
    } else {
      const int ks = 32 * warp;  // the step's k within the stage
      const unsigned char* xs = ks < XBOX ? xa : xb;
      const int kx = ks % XBOX;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = 16 * m + g;
        a[m][0] = x_word(xs, r, kx + 4 * p0);
        a[m][2] = x_word(xs, r, kx + 4 * p1);
        a[m][1] = R > 8 ? x_word(xs, r + 8, kx + 4 * p0) : 0u;
        a[m][3] = R > 8 ? x_word(xs, r + 8, kx + 4 * p1) : 0u;
      }
      // s4conv reads the stage widened to int8 words
      unsigned char* wb = S == S4CONV ? wide + sl * WIDE_BYTES
                                      : const_cast<unsigned char*>(wbox);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column 8 j + g
        const int cc = 8 * j + g;
        uint32_t b0, b1;
        if constexpr (S == S4DOT) {
          const int pw = 4 * warp + 2 * (t >> 1);
          b0 = nibbles(*box_word(wb, pw, cc), t & 1);
          b1 = nibbles(*box_word(wb, pw + 1, cc), t & 1);
        } else {
          b0 = *box_word(wb, 8 * warp + p0, cc);
          b1 = *box_word(wb, 8 * warp + p1, cc);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_s8(c[m][j], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
      }
    }
  };

  // every stage of the strip in flight at once where the slots hold them,
  // else `slots` stages a round; a warp's k-steps of the round's stages two
  // at a time, one accumulator set each
  for (int i0 = 0; i0 < stages; i0 += slots) {
    const int n_st = min(slots, stages - i0);
    for (int sl = 0; sl < n_st; ++sl) fetch(i0 + sl, sl);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if constexpr (S == S4CONV) {  // widen the round's words into int8 words
      for (int v = tid; v < n_st * (KS / 8) * BN; v += THREADS) {
        const int q = v / ((KS / 8) * BN), r = (v / BN) % (KS / 8),
                  c = v % BN;
        const uint32_t wv = *box_word(base + q * STAGE + 2 * XB, r, c);
        *box_word(wide + q * WIDE_BYTES, 2 * r, c) = nibbles(wv, 0);
        *box_word(wide + q * WIDE_BYTES, 2 * r + 1, c) = nibbles(wv, 1);
      }
      __syncthreads();
    }
    // every stage is whole but for the strip's last one
    const int whole = i0 + n_st < stages || k_chunk % KS == 0 ? n_st
                                                               : n_st - 1;
    int sl = 0;
#pragma unroll 1
    for (; sl + 1 < whole; sl += 2) {
      step(sl, acc[0]);
      step(sl + 1, acc[1]);
    }
    if (sl < whole) step(sl++, acc[0]);
    if (sl < n_st && warp < (k_chunk % KS) / 32) step(sl, acc[1]);
    __syncthreads();  // the slots are free for the next round
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][m][j][e] += acc[1][m][j][e];

  // the warps' tiles into shared memory (the ring's bytes), then added
  int* part = reinterpret_cast<int*>(base);  // (WARPS, R, 32)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = BYTES ? 8 * t + j : 8 * j + 2 * t;  // n-slot 2t
      const int c1 = BYTES ? 8 * t + 4 + j : 8 * j + 2 * t + 1;
      int* p = part + (warp * R + 16 * m + g) * BN;
      p[c0] = acc[0][m][j][0];
      p[c1] = acc[0][m][j][1];
      if constexpr (R > 8) {
        p[8 * BN + c0] = acc[0][m][j][2];
        p[8 * BN + c1] = acc[0][m][j][3];
      }
    }
  __syncthreads();
  for (int e = tid; e < R * BN; e += THREADS) {
    int v = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += part[wi * R * BN + e];
    if (split == 1) {
      if (e / BN < bt) out[(size_t)(e / BN) * cout + n0 + e % BN] = v;
    } else {
      tile[e] = v;
    }
  }
  if (split == 1) return;
  sm90::cluster_sync();  // every block's tile is staged
  for (int e = rank * THREADS + tid; e < bt * BN; e += split * THREADS) {
    int u[sm90::MAX_CLUSTER];
    sm90::load_peers(&tile[e], split, u);
    int v = u[0];
#pragma unroll
    for (int q = 1; q < sm90::MAX_CLUSTER; ++q)
      if (q < split) v += u[q];
    out[(size_t)(e / BN) * cout + n0 + e % BN] = v;
  }
  sm90::cluster_sync();  // no block leaves while another reads its tile
}

template <int S, int R>
int launch_strip(const void* x, const void* w, void* out, int bt, int cin,
                 int cout, int split, cudaStream_t st) {
  if (bt < 1 || bt > R || cin <= 0 || cin % 64 != 0 || cout % BN != 0 ||
      split < 1 || split > sm90::MAX_CLUSTER || cin % (64 * split) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int k_chunk = cin / split;
  const int stages = (k_chunk + KS - 1) / KS;
  const int slots = ring_slots(S, R, stages);
  const int dyn = dyn_bytes(S, R, slots);
  const auto kernel = strip_kernel<S, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(split, cout / BN);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const unsigned char* wp = static_cast<const unsigned char*>(w);
  if (split == 1) {
    kernel<<<grid, THREADS, dyn, st>>>(xp, wp, static_cast<int*>(out), bt,
                                      cin, cout, k_chunk, slots);
    return (int)cudaGetLastError();
  }
  return sm90::launch_cluster(kernel, grid, THREADS, (size_t)dyn, split, st,
                              xp, wp, static_cast<int*>(out), bt, cin, cout,
                              k_chunk, slots);
}

template <int S>
int launch_strip_rows(const void* x, const void* w, void* out, int bt,
                      int cin, int cout, int split, cudaStream_t st) {
  if (bt <= 8) return launch_strip<S, 8>(x, w, out, bt, cin, cout, split, st);
  if (bt <= 16) return launch_strip<S, 16>(x, w, out, bt, cin, cout, split, st);
  return launch_strip<S, 32>(x, w, out, bt, cin, cout, split, st);
}

}  // namespace dg

// ---------------------------------------------------------------------------
// K21
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st_v4(void* p, uint32_t a, uint32_t b,
                                      uint32_t c, uint32_t d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(a),
               "r"(b), "r"(c), "r"(d));
}

__device__ __forceinline__ void st_v2(void* p, uint32_t a, uint32_t b) {
  asm volatile("st.global.v2.b32 [%0], {%1, %2};" ::"l"(p), "r"(a), "r"(b));
}

__device__ __forceinline__ int16_t shr16(int16_t v) {
  int16_t r;
  asm("shr.s16 %0, %1, 4;" : "=h"(r) : "h"(v));
  return r;
}

__device__ __forceinline__ int16_t lo16(int16_t v, int16_t h) {
  int16_t t, r;
  asm("shl.b16 %0, %1, 4;" : "=h"(t) : "h"(h));
  asm("sub.s16 %0, %1, %2;" : "=h"(r) : "h"(v), "h"(t));
  asm("sub.s16 %0, %1, 8;" : "=h"(t) : "h"(r));
  return t;
}

// one byte of packed value v -> (lo, hi) by scheme S
template <int S>
__device__ __forceinline__ void unpack_byte(int8_t v, uint32_t& lo,
                                            uint32_t& hi) {
  if constexpr (S == U_F32) {
    const float b = (float)v;
    const float fh = floorf(b * 0.0625f);
    const float fl = b - 16.0f * fh - 8.0f;
    hi = (uint32_t)__float2int_rz(fh) & 0xFFu;
    lo = (uint32_t)__float2int_rz(fl) & 0xFFu;
  } else if constexpr (S == U_I32) {
    const int b = v;
    const int h = b >> 4;
    hi = (uint32_t)h & 0xFFu;
    lo = (uint32_t)((b - (h << 4)) - 8) & 0xFFu;
  } else if constexpr (S == U_I16) {
    const int16_t b = v;
    const int16_t h = shr16(b);
    hi = (uint32_t)(uint16_t)h & 0xFFu;
    lo = (uint32_t)(uint16_t)lo16(b, h) & 0xFFu;
  } else {  // U_I8DIV: C division truncates; floor division corrects it
    int8_t h = (int8_t)(v / (int8_t)16);
    if (v % (int8_t)16 != 0 && v < 0) h = (int8_t)(h - 1);
    const int8_t l = (int8_t)((int8_t)(v - (int8_t)(16 * h)) - (int8_t)8);
    hi = (uint32_t)(uint8_t)h;
    lo = (uint32_t)(uint8_t)l;
  }
}

template <int S>
__device__ __forceinline__ void unpack_word(uint32_t b, uint32_t& lo,
                                            uint32_t& hi) {
  lo = 0;
  hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t l, h;
    unpack_byte<S>((int8_t)(b >> (8 * j)), l, h);
    lo |= l << (8 * j);
    hi |= h << (8 * j);
  }
}

template <int S>
__global__ void __launch_bounds__(256)
unpack_kernel(const uint4* __restrict__ w, int8_t* __restrict__ out,
              int half, int vec_cols, int reps, uint32_t zero) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)half * vec_cols;
  if (i >= n) return;
  const uint4 b0 = w[i];
  uint4* lo_out = reinterpret_cast<uint4*>(out) + i;
  uint4* hi_out = lo_out + n;
  uint32_t carry = 0;
  for (int r = 0; r < reps; ++r) {
    const uint32_t c4 = carry * 0x01010101u;  // w + carry, per byte
    uint32_t l0, l1, l2, l3, h0, h1, h2, h3;
    unpack_word<S>(__vadd4(b0.x, c4), l0, h0);
    unpack_word<S>(__vadd4(b0.y, c4), l1, h1);
    unpack_word<S>(__vadd4(b0.z, c4), l2, h2);
    unpack_word<S>(__vadd4(b0.w, c4), l3, h3);
    st_v4(lo_out, l0, l1, l2, l3);
    st_v4(hi_out, h0, h1, h2, h3);
    carry = l0 & zero;
  }
}

using namespace nvcuda;

// one warp per 16x16 packed tile; lane l holds row l / 2, eight bytes
__global__ void __launch_bounds__(128)
unpack_eyedot_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ out,
                     int half, int cols, int reps, uint32_t zero) {
  __shared__ __align__(32) int8_t eye_s[16 * 16];
  __shared__ __align__(32) int8_t tile_s[4][16 * 16];
  __shared__ __align__(32) int acc_s[4][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int v = threadIdx.x; v < 256; v += blockDim.x)
    eye_s[v] = (int8_t)(v / 16 == v % 16);
  __syncthreads();
  const int tiles_n = cols / 16;
  const int tile = blockIdx.x * 4 + warp;
  if (tile >= (half / 16) * tiles_n) return;
  const int row = (tile / tiles_n) * 16 + lane / 2;
  const int col = (tile % tiles_n) * 16 + (lane % 2) * 8;
  const uint2 b0 =
      *reinterpret_cast<const uint2*>(w + (size_t)row * cols + col);
  int8_t* lo_p = out + (size_t)row * cols + col;
  int8_t* hi_p = lo_p + (size_t)half * cols;
  int8_t* ts = tile_s[warp];
  int* as = acc_s[warp];
  const int off = (lane / 2) * 16 + (lane % 2) * 8;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> ea;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
  wmma::load_matrix_sync(ea, eye_s, 16);
  uint32_t carry = 0;
  for (int r = 0; r < reps; ++r) {
    const uint32_t c4 = carry * 0x01010101u;
    *reinterpret_cast<uint2*>(ts + off) =
        make_uint2(__vadd4(b0.x, c4), __vadd4(b0.y, c4));
    __syncwarp();
    wmma::load_matrix_sync(fb, ts, 16);
    wmma::fill_fragment(fc, 0);
    wmma::mma_sync(fc, ea, fb, fc);
    wmma::store_matrix_sync(as, fc, 16, wmma::mem_row_major);
    __syncwarp();
    uint32_t lo[2] = {0, 0}, hi[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = (float)as[off + j];
      const float fh = floorf(b * 0.0625f);
      const float fl = b - 16.0f * fh - 8.0f;
      hi[j / 4] |= ((uint32_t)__float2int_rz(fh) & 0xFFu) << (8 * (j % 4));
      lo[j / 4] |= ((uint32_t)__float2int_rz(fl) & 0xFFu) << (8 * (j % 4));
    }
    st_v2(lo_p, lo[0], lo[1]);
    st_v2(hi_p, hi[0], hi[1]);
    carry = lo[0] & zero;
    __syncwarp();  // the next rep overwrites ts and as
  }
}

// ---------------------------------------------------------------------------
// K21, word-wide
// ---------------------------------------------------------------------------

constexpr int UNPACK_THREADS = 128;
constexpr int UNPACK_VEC = 4;  // 16-byte pieces a thread loads at once
// (the grid: at most four blocks an SM, so at most 128 registers a thread;
// eyedot's accumulators take more, three blocks an SM hold the tool's grid)

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// the low bytes of four words gathered into one word, r0's lowest
__device__ __forceinline__ uint32_t gather_low_bytes(uint32_t r0, uint32_t r1,
                                                     uint32_t r2, uint32_t r3) {
  return prmt(prmt(r0, r1, 0x0040u), prmt(r2, r3, 0x0040u), 0x5410u);
}

// fp32 of a small integer (|i| < 2^22) through the exponent field, minus 8
constexpr float MAGIC = 12582912.0f;  // 1.5 x 2^23: its bits 0x4B400000
__device__ __forceinline__ float f32_minus8(int i) {
  return __int_as_float(i + 0x4B400000) - (MAGIC + 8.0f);
}

// hi = floor(b / 16), lo = b - 16 hi - 8 from v8 = b - 8, in fp32; each
// returned in the low byte of its word (fp32 + 1.5 x 2^23: the integer's
// two's complement in the low mantissa bits)
__device__ __forceinline__ void floor_unpack(float v8, uint32_t& lo,
                                             uint32_t& hi) {
  const float fh = floorf(fmaf(v8, 0.0625f, 0.5f));  // (b - 8) / 16 + 1/2
  const float fl = fmaf(-16.0f, fh, v8);
  hi = __float_as_uint(fh + MAGIC);
  lo = __float_as_uint(fl + MAGIC);
}

// the 16-bit halves of the i16 scheme, two bytes each
__device__ __forceinline__ uint16_t i16_lo(uint16_t h) {
  uint16_t r;
  asm("{\n\t.reg .b16 t;\n\t"
      "and.b16 t, %1, 0x0F0F;\n\t"
      "add.u16 t, t, 0x7878;\n\t"
      "xor.b16 %0, t, 0x8080;\n\t}"
      : "=h"(r)
      : "h"(h));
  return r;
}

__device__ __forceinline__ uint16_t i16_hi(uint16_t h) {
  uint16_t r;
  asm("{\n\t.reg .b16 t;\n\t"
      "shr.u16 t, %1, 4;\n\t"
      "and.b16 t, t, 0x0F0F;\n\t"
      "add.u16 t, t, 0x7878;\n\t"
      "xor.b16 %0, t, 0x7878;\n\t}"
      : "=h"(r)
      : "h"(h));
  return r;
}

// one packed word b -> (lo, hi) words by scheme S, four bytes at once
template <int S>
__device__ __forceinline__ void unpack_wide(uint32_t b, uint32_t& lo,
                                            uint32_t& hi) {
  if constexpr (S == U_I32) {
    // each nibble's sign over its byte: n | (sign x 0xF0), the bits disjoint
    const uint32_t nl = (b & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t nh = (b >> 4) & 0x0F0F0F0Fu;
    lo = nl + (nl & 0x08080808u) * 0x1Eu;
    hi = nh + (nh & 0x08080808u) * 0x1Eu;
  } else if constexpr (S == U_I16) {
    uint16_t h0, h1;
    asm("mov.b32 {%0, %1}, %2;" : "=h"(h0), "=h"(h1) : "r"(b));
    asm("mov.b32 %0, {%1, %2};" : "=r"(lo) : "h"(i16_lo(h0)), "h"(i16_lo(h1)));
    asm("mov.b32 %0, {%1, %2};" : "=r"(hi) : "h"(i16_hi(h0)), "h"(i16_hi(h1)));
  } else if constexpr (S == U_I8DIV) {
    // floor(b / 16) a byte: the high nibble down, the byte's sign above it
    const uint32_t neg = (b >> 7) & 0x01010101u;
    hi = ((b >> 4) & 0x0F0F0F0Fu) + neg * 0xF0u;
    lo = __vsub4(b, ((hi << 4) & 0xF0F0F0F0u) | 0x08080808u);
  } else {  // U_F32: byte j sign-extended by prmt (selector nibbles 8 | j)
    uint32_t l[4], h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t sel = 0x8880u | (0x1111u * (uint32_t)j);
      floor_unpack(f32_minus8((int)prmt(b, 0u, sel)), l[j], h[j]);
    }
    lo = gather_low_bytes(l[0], l[1], l[2], l[3]);
    hi = gather_low_bytes(h[0], h[1], h[2], h[3]);
  }
}

// n 16-byte pieces; thread g of the grid owns pieces g + (4 r + j) x (the
// grid's threads), j = 0..3, for rounds r = 0 .. rounds - 1: its four loads
// of a round issued before any arithmetic, then the reps
template <int S>
__global__ void __launch_bounds__(UNPACK_THREADS, 4)
unpack_words_kernel(const uint4* __restrict__ w, int8_t* __restrict__ out,
                    long long n, int rounds, int reps, uint32_t zero) {
  const long long threads = (long long)gridDim.x * UNPACK_THREADS;
  const long long g = (long long)blockIdx.x * UNPACK_THREADS + threadIdx.x;
  uint4* lo_out = reinterpret_cast<uint4*>(out);
  uint4* hi_out = lo_out + n;
  for (int r = 0; r < rounds; ++r) {
    const long long k0 = g + (long long)r * UNPACK_VEC * threads;
    if (k0 >= n) return;
    // the pieces of this round below n: a prefix of the four
    const int live = (int)min((long long)UNPACK_VEC,
                              (n - 1 - k0) / threads + 1);
    uint4 b[UNPACK_VEC];
#pragma unroll
    for (int j = 0; j < UNPACK_VEC; ++j)
      b[j] = j < live ? __ldg(w + k0 + j * threads) : make_uint4(0, 0, 0, 0);
    uint32_t carry = 0;
    for (int rep = 0; rep < reps; ++rep) {
      const uint32_t c4 = carry * 0x01010101u;  // w + carry, per byte
      uint32_t first = 0;
#pragma unroll
      for (int j = 0; j < UNPACK_VEC; ++j) {
        if (j < live) {
          uint32_t l0, l1, l2, l3, h0, h1, h2, h3;
          unpack_wide<S>(__vadd4(b[j].x, c4), l0, h0);
          unpack_wide<S>(__vadd4(b[j].y, c4), l1, h1);
          unpack_wide<S>(__vadd4(b[j].z, c4), l2, h2);
          unpack_wide<S>(__vadd4(b[j].w, c4), l3, h3);
          st_v4(lo_out + k0 + j * threads, l0, l1, l2, l3);
          st_v4(hi_out + k0 + j * threads, h0, h1, h2, h3);
          if (j == 0) first = l0;
        }
      }
      carry = first & zero;
    }
  }
}

__device__ __forceinline__ void mma_s8_m16n8k16(int (&d)[4], uint32_t a0,
                                                uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%7, %8, %9, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0), "r"(0), "r"(0), "r"(0));
}

constexpr int EYE_COLS = 128;  // packed columns of a warp's tile

// a warp a tile of 16 packed rows x 128 columns (at a ragged right edge
// fewer groups of 16); warp w of the grid takes tiles w + r x (the grid's
// warps), r < rounds. Lane (g, t) = (lane / 4, lane % 4) loads column group
// G(g) = 4 (g & 1) + g / 2, so that the accumulators' n-slots 2t and 2t + 1
// are column groups t and 4 + t: each store instruction of the warp writes
// 64 contiguous bytes of a row, whole 32-byte sectors.
__global__ void __launch_bounds__(UNPACK_THREADS, 3)
unpack_eyedot_mma_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ out,
                         int half, int cols, int rounds, int reps,
                         uint32_t zero) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warps = gridDim.x * (UNPACK_THREADS / 32);
  const int wid = blockIdx.x * (UNPACK_THREADS / 32) + threadIdx.x / 32;
  const int tiles_n = (cols + EYE_COLS - 1) / EYE_COLS;
  const int tiles = (half / 16) * tiles_n;
  // the identity's A fragment: a0 row g, a1 row g + 8, columns 4t .. 4t + 3
  uint32_t a0 = 0, a1 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a0 |= (uint32_t)(g == 4 * t + i) << (8 * i);
    a1 |= (uint32_t)(g + 8 == 4 * t + i) << (8 * i);
  }
  for (int r = 0; r < rounds; ++r) {
    const int tile = wid + r * warps;
    if (tile >= tiles) return;
    const int r0 = (tile / tiles_n) * 16, c0 = (tile % tiles_n) * EYE_COLS;
    const int groups = min(EYE_COLS, cols - c0) / 16;
    // rows r0 + 4t + i, bytes c0 + 16 G(g) .. + 15: four loads, then b[v][j]
    // = K rows 4t .. 4t + 3 of column c0 + 16 G(g) + 4v + j
    const int gg = 4 * (g & 1) + g / 2;
    uint4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = gg < groups
                 ? __ldg(reinterpret_cast<const uint4*>(
                       w + (size_t)(r0 + 4 * t + i) * cols + c0 + 16 * gg))
                 : make_uint4(0, 0, 0, 0);
    uint32_t b[4][4];
    {
      const uint32_t w0[4] = {q[0].x, q[1].x, q[2].x, q[3].x};
      const uint32_t w1[4] = {q[0].y, q[1].y, q[2].y, q[3].y};
      const uint32_t w2[4] = {q[0].z, q[1].z, q[2].z, q[3].z};
      const uint32_t w3[4] = {q[0].w, q[1].w, q[2].w, q[3].w};
      transpose4x4(w0, b[0]);
      transpose4x4(w1, b[1]);
      transpose4x4(w2, b[2]);
      transpose4x4(w3, b[3]);
    }
    // lane (g, t)'s outputs: rows r0 + g (k = 0, 1) and r0 + g + 8 (k = 2,
    // 3), column groups t (k even: n-slot 2t) and 4 + t (k odd: 2t + 1)
    const bool left = t < groups, right = 4 + t < groups;
    int8_t* lo_p = out + (size_t)(r0 + g) * cols + c0 + 16 * t;
    const size_t down = (size_t)8 * cols, hi_off = (size_t)half * cols;
    uint32_t carry = 0;
    for (int rep = 0; rep < reps; ++rep) {
      const uint32_t c4 = carry * 0x01010101u;
      uint32_t lo[4][4], hi[4][4];  // [k][v]
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        int d[4][4];  // [j][k]
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8_m16n8k16(d[j], a0, a1, __vadd4(b[v][j], c4));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t l[4], h[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            floor_unpack(f32_minus8(d[j][k]), l[j], h[j]);
          lo[k][v] = gather_low_bytes(l[0], l[1], l[2], l[3]);
          hi[k][v] = gather_low_bytes(h[0], h[1], h[2], h[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k % 2 == 0 ? left : right) {
          int8_t* p = lo_p + (k / 2) * down + (k % 2) * 64;
          st_v4(p, lo[k][0], lo[k][1], lo[k][2], lo[k][3]);
          st_v4(p + hi_off, hi[k][0], hi[k][1], hi[k][2], hi[k][3]);
        }
      }
      carry = lo[0][0] & zero;
    }
  }
}

}  // namespace

// K20, the strip kernel: x (bt, cin) int8; w: i8ref (cin/4, cout, 4) int8,
// s4dot / s4conv (cin/8, cout) int32, i8shift / f32unpack (cin/2, cout)
// int8; both 16-byte aligned; out (bt, cout) int32, written whole. bt <=
// 32, cin % (64 split) == 0, cout % 32 == 0, split 1 (an ordinary launch)
// or 2..8 (one cluster a strip). One device kernel.
extern "C" int acai_int4_delivery_gemm_strip(const void* x, const void* w,
                                             void* out, int scheme, int bt,
                                             int cin, int cout, int split,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case I8REF: return dg::launch_strip_rows<I8REF>(x, w, out, bt, cin, cout, split, s);
    case S4DOT: return dg::launch_strip_rows<S4DOT>(x, w, out, bt, cin, cout, split, s);
    case S4CONV: return dg::launch_strip_rows<S4CONV>(x, w, out, bt, cin, cout, split, s);
    case I8SHIFT: return dg::launch_strip_rows<I8SHIFT>(x, w, out, bt, cin, cout, split, s);
    case F32UNPACK: return dg::launch_strip_rows<F32UNPACK>(x, w, out, bt, cin, cout, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K20's replaced form (variant "atomic"). x (bt, cin) int8; w as above; out
// (bt, cout) int32, zeroed by the caller when splits > 1. The wrapper checks
// bt <= 32, cin % (64 splits) == 0, cout % 128 (words) or % 512 (bytes) ==
// 0 and the staged x within 48 KB.
extern "C" int acai_int4_delivery_gemm(const void* x, const void* w, void* out,
                                       int scheme, int bt, int cin, int cout,
                                       int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case I8REF: return launch_gemm_rows<I8REF>(x, w, out, bt, cin, cout, splits, s);
    case S4DOT: return launch_gemm_rows<S4DOT>(x, w, out, bt, cin, cout, splits, s);
    case S4CONV: return launch_gemm_rows<S4CONV>(x, w, out, bt, cin, cout, splits, s);
    case I8SHIFT: return launch_gemm_rows<I8SHIFT>(x, w, out, bt, cin, cout, splits, s);
    case F32UNPACK: return launch_gemm_rows<F32UNPACK>(x, w, out, bt, cin, cout, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K21, word-wide: packed (half, cols) int8 -> out (2 half, cols) int8,
// both 16-byte aligned; half % 16 == 0, cols % 16 == 0, reps >= 1; `blocks`
// and `rounds` from ops/int4_probe_kernels.unpack_plan (eyedot: rounds of a
// 16 x 128 tile a warp; else of four 16-byte pieces a thread).
extern "C" int acai_int4_unpack(const void* packed, void* out, int scheme,
                                int half, int cols, int blocks, int rounds,
                                int reps, void* stream) {
  if (half % 16 != 0 || cols % 16 != 0 || half < 16 || cols < 16 ||
      blocks < 1 || rounds < 1 || reps < 1 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t zero = 0;  // a run-time 0: the kernels cannot fold it
  const int8_t* p = static_cast<const int8_t*>(packed);
  int8_t* o = static_cast<int8_t*>(out);
  if (scheme == U_EYEDOT) {
    unpack_eyedot_mma_kernel<<<blocks, UNPACK_THREADS, 0, s>>>(
        p, o, half, cols, rounds, reps, zero);
    return (int)cudaGetLastError();
  }
  const long long n = (long long)half * (cols / 16);
  const uint4* w = reinterpret_cast<const uint4*>(p);
  switch (scheme) {
    case U_F32: unpack_words_kernel<U_F32><<<blocks, UNPACK_THREADS, 0, s>>>(w, o, n, rounds, reps, zero); break;
    case U_I32: unpack_words_kernel<U_I32><<<blocks, UNPACK_THREADS, 0, s>>>(w, o, n, rounds, reps, zero); break;
    case U_I16: unpack_words_kernel<U_I16><<<blocks, UNPACK_THREADS, 0, s>>>(w, o, n, rounds, reps, zero); break;
    case U_I8DIV: unpack_words_kernel<U_I8DIV><<<blocks, UNPACK_THREADS, 0, s>>>(w, o, n, rounds, reps, zero); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K21's replaced forms (variant "bytewise"). packed (half, cols) int8 ->
// out (2 half, cols) int8; half % 16 == 0, cols % 16 == 0, reps >= 1.
extern "C" int acai_int4_unpack_bytewise(const void* packed, void* out,
                                         int scheme, int half, int cols,
                                         int reps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t zero = 0;  // a run-time 0: the kernels cannot fold it
  if (scheme == U_EYEDOT) {
    const int tiles = (half / 16) * (cols / 16);
    unpack_eyedot_kernel<<<(tiles + 3) / 4, 128, 0, s>>>(
        static_cast<const int8_t*>(packed), static_cast<int8_t*>(out), half,
        cols, reps, zero);
    return (int)cudaGetLastError();
  }
  const size_t n = (size_t)half * (cols / 16);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const uint4* w = static_cast<const uint4*>(packed);
  int8_t* o = static_cast<int8_t*>(out);
  switch (scheme) {
    case U_F32: unpack_kernel<U_F32><<<blocks, 256, 0, s>>>(w, o, half, cols / 16, reps, zero); break;
    case U_I32: unpack_kernel<U_I32><<<blocks, 256, 0, s>>>(w, o, half, cols / 16, reps, zero); break;
    case U_I16: unpack_kernel<U_I16><<<blocks, 256, 0, s>>>(w, o, half, cols / 16, reps, zero); break;
    case U_I8DIV: unpack_kernel<U_I8DIV><<<blocks, 256, 0, s>>>(w, o, half, cols / 16, reps, zero); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The resource report (func_attrs.cuh): K20's strip kernel per scheme and
// row tile at its largest dynamic shared memory (the ring's budget, the
// widened stage), the atomic kernel it replaced at the tool's shape (8
// rows, one 64-k unit of x a split); K21's word-wide kernels and the
// bytewise kernels they replaced.
#define K20_STRIP(S, R, NAME)                                                \
  AcaiKernelEntry {                                                          \
    "int4_delivery_gemm|" NAME "|strip_kernel<" #S "," #R ">",              \
        reinterpret_cast<const void*>(&dg::strip_kernel<S, R>), dg::THREADS, \
        dg::dyn_bytes(S, R, dg::ring_slots(S, R, 1 << 20))                   \
  }
#define K20_ATOMIC(S, NAME)                                                  \
  AcaiKernelEntry {                                                          \
    "int4_delivery_gemm|" NAME " atomic|int4_gemm_kernel<" #S ",8>",        \
        reinterpret_cast<const void*>(&int4_gemm_kernel<S, 8>), THREADS,     \
        8 * UNIT                                                             \
  }
static const AcaiKernelEntry kResources[] = {
    K20_STRIP(I8REF, 8, "i8ref"),         K20_STRIP(I8REF, 32, "i8ref"),
    K20_STRIP(S4DOT, 8, "s4dot"),         K20_STRIP(S4DOT, 32, "s4dot"),
    K20_STRIP(S4CONV, 8, "s4conv"),       K20_STRIP(S4CONV, 32, "s4conv"),
    K20_STRIP(I8SHIFT, 8, "i8shift"),     K20_STRIP(I8SHIFT, 32, "i8shift"),
    K20_STRIP(F32UNPACK, 8, "f32unpack"), K20_STRIP(F32UNPACK, 32, "f32unpack"),
    K20_ATOMIC(I8REF, "i8ref"),           K20_ATOMIC(S4DOT, "s4dot"),
    K20_ATOMIC(S4CONV, "s4conv"),         K20_ATOMIC(I8SHIFT, "i8shift"),
    K20_ATOMIC(F32UNPACK, "f32unpack"),
    ACAI_KERNEL("int4_unpack", "f32", unpack_words_kernel<U_F32>,
                UNPACK_THREADS, 0),
    ACAI_KERNEL("int4_unpack", "i32", unpack_words_kernel<U_I32>,
                UNPACK_THREADS, 0),
    ACAI_KERNEL("int4_unpack", "i16", unpack_words_kernel<U_I16>,
                UNPACK_THREADS, 0),
    ACAI_KERNEL("int4_unpack", "i8div", unpack_words_kernel<U_I8DIV>,
                UNPACK_THREADS, 0),
    ACAI_KERNEL("int4_unpack", "eyedot", unpack_eyedot_mma_kernel,
                UNPACK_THREADS, 0),
    ACAI_KERNEL("int4_unpack", "f32 bytewise", unpack_kernel<U_F32>, 256, 0),
    ACAI_KERNEL("int4_unpack", "i32 bytewise", unpack_kernel<U_I32>, 256, 0),
    ACAI_KERNEL("int4_unpack", "i16 bytewise", unpack_kernel<U_I16>, 256, 0),
    ACAI_KERNEL("int4_unpack", "i8div bytewise", unpack_kernel<U_I8DIV>, 256,
                0),
    ACAI_KERNEL("int4_unpack", "eyedot bytewise", unpack_eyedot_kernel, 128,
                0),
};
ACAI_EXPORT_RESOURCES(kResources)
