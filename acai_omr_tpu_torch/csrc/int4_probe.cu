// K20 int4_delivery_gemm and K21 int4_unpack: the int4 delivery and unpack
// schemes of the W4A8 decode product, one template each.
//
// K20 replaces tools/int4_probe.py `run_variant` (:96, pallas_call :112) and
// `time_variant` (:130, pallas_call :147) of the JAX package: out (bt, cout)
// int32 = x (bt, cin) int8 @ W (cin, cout), W's rows 0..cin/2 the int4 values
// `lo`, the rest `hi`, exact. The schemes keep the TPU tool's names and say
// how W reaches the dot on Hopper:
//   i8ref     full int8 weights in K5's K-packed layout (cin/4, cout, 4),
//             one 32-bit load a column is one __dp4a operand;
//   s4dot     K14's layout (cin/8, cout) int32, eight K rows to a word,
//             unpacked in registers into the two __dp4a operands;
//   s4conv    the same words widened to int8 into shared memory by the block
//             first (the TPU's astype(int8) before the dot), then dotted from
//             shared memory;
//   i8shift   the TPU's bytes (cin/2, cout) int8 holding (hi << 4) | (lo + 8);
//             a thread loads one 32-bit word (four columns) of four rows,
//             transposes the 4x4 bytes with __byte_perm and unpacks with
//             per-byte shifts and masks; x[:, :cin/2] dots lo, x[:, cin/2:] hi;
//   f32unpack the same bytes, each unpacked through fp32 floor(b / 16).
// Bound: the weight bytes (2 MiB at 1024 -> 4096 in int4, 4 MiB in int8)
// over 3.35 TB/s; the products are 67 MOP, far below the int8 peak. Design:
// 128 threads, one column (word layouts) or four (byte layouts) a thread;
// the contraction is split over blockIdx.y so that about 264 blocks stream
// the weights, and the splits add their int32 sums with integer atomics,
// exact in any order. x's columns of the split are staged in shared memory,
// rows padded with zeros to R (8, 16 or 32).
//
// K21 replaces tools/unpack_probe.py `run` (:112, pallas_call :124) and its
// five kernels (`KERNELS` :108): packed (half, cols) int8 -> (2 half, cols)
// int8, lo rows then hi rows, `reps` times in the kernel with a carried
// perturbation as the TPU's fori_loop has. Schemes: f32 (float convert and
// floorf), i32 (int32 shifts), i16 (int16 shifts, 16-bit PTX), i8div (C
// division on int8 corrected to floor division), eyedot (a 16x16 int8
// identity times the packed tile on the tensor cores through wmma with int32
// accumulation, then fp32 floor math; the tiles off the diagonal of the TPU's
// full identity product add zeros and are not computed). A thread holds its
// 16 packed bytes (eyedot: 8) in registers across the reps, as the TPU holds
// them in VMEM; every rep stores its 32 output bytes with st.global from
// inline asm, so no rep's stores are merged, and the carry is the rep's first
// lo word AND a kernel argument that is 0 at run time, which the compiler
// cannot prove zero: no rep folds or hoists. Bound per unpack: 2 MiB in, 4
// MiB out.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace

// K20. x (bt, cin) int8; w: i8ref (cin/4, cout, 4) int8, s4dot / s4conv
// (cin/8, cout) int32, i8shift / f32unpack (cin/2, cout) int8; out (bt, cout)
// int32, zeroed by the caller when splits > 1. The wrapper checks bt <= 32,
// cin % (64 splits) == 0, cout % 128 (words) or % 512 (bytes) == 0 and the
// staged x within 48 KB.
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

// K21. packed (half, cols) int8 -> out (2 half, cols) int8; half % 16 == 0,
// cols % 16 == 0, reps >= 1.
extern "C" int acai_int4_unpack(const void* packed, void* out, int scheme,
                                int half, int cols, int reps, void* stream) {
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
