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
// bound it; the int8 operations are far below the card's rate. Design: three
// launches. (1) one block per row finds the row's max, writes the fp32 scale
// and the int8 row. (2) each block owns 128 output columns (one per thread,
// so a warp's weight loads are one coalesced 128-byte line per k/4) and a
// chunk of K; the int8 activation tile (32 rows x 128 k) sits in shared
// memory and is read as broadcast 32-bit words, one `__dp4a` per row and
// word. K is split across blockIdx.z so that about two waves of blocks stream
// the weights; the int32 partial sums are exact, so their order is free.
// (3) sums the partials and applies the epilogue (skipped when K is not
// split). No tensor cores, no cp.async/TMA pipelining yet.
//
// Epilogue act: 0 = none; 1 = exact-erf GELU on the fp32 sum; 2 = round the
// sum to bf16, then GELU (the decode monolith casts ff1 to the compute dtype
// before its GELU); 3 = the dequantized fp32 partial of a tensor-parallel
// row-parallel product, (float(acc) * row_scale) * col_scale written to an
// fp32 `out` without the bias (`_qdot` under ACAI_TP_W8A8; K15 tp_allreduce
// sums the ranks' partials and adds the bias).
//
// K14 quant4_linear_bias_act (second entry point): the W4A8 product, the
// same function with int4 weights in [-7, 7].
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
// its high nibble. Nothing is staged in device memory: each thread loads one
// coalesced word per 8 k and forms the two `__dp4a` operands in registers
// (mask, then a per-byte subtraction of 8), against the activation words of
// k..k+3 and k+4..k+7.
//
// Bound on an H100: half of K5's, the K*N/2 packed weight bytes at 3.35 TB/s
// at decode rows. The design is K5's (row quantizer, split-K plan, reduce and
// epilogue kernels shared); only the product kernel's inner loop differs, two
// `__dp4a` and the unpack per word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// x8 (M, K) int8 and row_scale (M,) fp32 are scratch the wrapper allocates.
// splits == 1: two launches, epilogue in the product kernel. splits > 1:
// `partial` holds (splits, M, N) int32 scratch; each z-slice covers k_chunk
// (a multiple of 128) of K and a third launch reduces. act == 3: `out` is
// (M, N) fp32 and `bias` may be null.
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

// K14: as above with (K/8, N) int32 words of packed int4 weights.
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
