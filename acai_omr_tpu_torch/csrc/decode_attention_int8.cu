// K6 decode_attention_int8: single-token attention of one decode step over
// int8 KV caches, with the fresh token's quantized append.
//
// Replaces, in ops/pallas_monolith.py of the JAX package: `_quant_rows` (the
// per-head max-abs quantizer), the int8 branches of `_attend_all` and
// `_attend_shared`, and the quantized cache append of `_kernel`.
//
// Quantizer (per row and head): s = bf16(max(amax, 1e-8) / 127),
// xq = clip(rint(x / s), -127, 127): the scale is rounded to bf16 BEFORE
// quantizing, division not reciprocal, round half to even.
//
// Self mode (pos >= 0): q, k, v are the three E-wide column blocks of one
// (B, 3E) bf16 qkv row and are each quantized per head. The block for (row b,
// head h) writes the int8 k/v head slices into the (B, T, E) int8 caches at
// `pos` and their scales into the (B, T, H) bf16 scale tensors, then attends
// over cache positions [0, pos) plus the fresh token:
//   logit_t = (float(<qq, kq_t>) * ks_t) * (qs * scale)       cached keys
//   lc      = sum((qq*qs) * (kq*ks)) * scale                  fresh token
//   m = max(max_t logit_t, lc),  w_t = exp(logit_t - m),  wc = exp(lc - m)
//   wv_t = w_t * vs_t,  ws = max(max_t wv_t, 1e-30) / 127,  wq_t = rint(wv_t / ws)
//   out = (float(sum_t wq_t * vq_t) * ws + wc * (vq*vs)) / (sum_t w_t + wc).
// The softmax weights are quantized, not rounded to bf16; both integer
// products are exact. Cross mode (pos < 0): q (B, E) is quantized per head and
// attends over all n_keys memory rows with the additive fp32 bias; no fresh
// token. With mem_group = G > 1 the memory, its scales and its bias hold B / G
// rows and batch row b reads row b / G (each of the G rows' blocks reads the
// shared rows itself: once per row, not once per group).
//
// Bound on an H100: the int8 K/V bytes of the keys read (2 * B * n_keys * E)
// plus their bf16 scales, at 3.35 TB/s. Design: one block per (row, head).
// Warp 0 quantizes the head slices and appends. A key row's head slice is
// Dh / 4 32-bit words: Dh / 4 lanes take one word each (one `__dp4a` against
// the packed query), so a warp covers 128 / Dh key rows per pass. Logits,
// then w*vs, then the integer weights live in shared memory (one word per
// key: T and M up to 8192 fit the 48 KB default); the PV pass multiplies the
// integer weight into the four sign-extended bytes of each V word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Max-abs int8 quantization of one head slice held by one warp, element
// d = lane + 32 * p in xq[p]. Returns the bf16-rounded scale.
template <int PER>
__device__ __forceinline__ float quantize_head(const __nv_bfloat16* x, int lane,
                                               float (&xq)[PER]) {
  float v[PER];
  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    v[p] = __bfloat162float(x[lane + 32 * p]);
    amax = fmaxf(amax, fabsf(v[p]));
  }
  amax = warp_max(amax);
  const float s = __bfloat162float(
      __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)));
#pragma unroll
  for (int p = 0; p < PER; ++p)
    xq[p] = fminf(fmaxf(rintf(__fdiv_rn(v[p], s)), -127.0f), 127.0f);
  return s;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
decode_attention_int8_kernel(const __nv_bfloat16* __restrict__ q, int q_stride,
                             int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                             __nv_bfloat16* __restrict__ ksc,
                             __nv_bfloat16* __restrict__ vsc, int T, int E,
                             int H, int n_keys, const float* __restrict__ bias,
                             int pos, int mem_group, float scale,
                             __nv_bfloat16* __restrict__ out) {
  constexpr int PER = DH / 32;  // elements per lane in the quantizer
  constexpr int LPR = DH / 4;   // lanes per key row, one 32-bit word each
  constexpr int RPW = 32 / LPR; // key rows per warp pass
  extern __shared__ float logits[];  // n_keys words: logits, w*vs, int weights
  __shared__ int red[WARPS][DH];
  __shared__ float scratch[2][WARPS];
  __shared__ __align__(4) int8_t q8[DH];
  __shared__ float v_fresh[DH];
  __shared__ float head_scalars[2];  // q scale, fresh logit

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bm = b / mem_group;  // row of the caches / memory and the bias
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool fresh = pos >= 0;
  const size_t head = (size_t)h * DH;

  if (warp == 0) {
    const __nv_bfloat16* row = q + (size_t)b * q_stride + head;
    float qq[PER];
    const float qs = quantize_head<PER>(row, lane, qq);
#pragma unroll
    for (int p = 0; p < PER; ++p) q8[lane + 32 * p] = (int8_t)(int)qq[p];
    float lc = -FLT_MAX;
    if (fresh) {
      float kq[PER], vq[PER];
      const float ks = quantize_head<PER>(row + E, lane, kq);
      const float vs = quantize_head<PER>(row + 2 * E, lane, vq);
      const size_t slot = ((size_t)b * T + pos) * E + head;
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int d = lane + 32 * p;
        kc[slot + d] = (int8_t)(int)kq[p];
        vc[slot + d] = (int8_t)(int)vq[p];
        v_fresh[d] = __fmul_rn(vq[p], vs);
        s += __fmul_rn(__fmul_rn(qq[p], qs), __fmul_rn(kq[p], ks));
      }
      lc = __fmul_rn(warp_sum(s), scale);
      if (lane == 0) {
        ksc[((size_t)b * T + pos) * H + h] = __float2bfloat16_rn(ks);
        vsc[((size_t)b * T + pos) * H + h] = __float2bfloat16_rn(vs);
      }
    }
    if (lane == 0) {
      head_scalars[0] = qs;
      head_scalars[1] = lc;
    }
  }
  __syncthreads();
  const float q_scale = __fmul_rn(head_scalars[0], scale);
  const float lc = head_scalars[1];
  const int sub = lane % LPR;
  const int32_t qw = reinterpret_cast<const int32_t*>(q8)[sub];

  // logits over the cache / memory rows
  for (int t0 = warp * RPW; t0 < n_keys; t0 += WARPS * RPW) {
    const int t = t0 + lane / LPR;
    int dot = 0;
    if (t < n_keys) {
      const int32_t kw = *reinterpret_cast<const int32_t*>(
          kc + ((size_t)bm * T + t) * E + head + 4 * sub);
      dot = __dp4a(kw, qw, 0);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    if (t < n_keys && sub == 0) {
      const float ks = __bfloat162float(ksc[((size_t)bm * T + t) * H + h]);
      float l = __fmul_rn(__fmul_rn(__int2float_rn(dot), ks), q_scale);
      if (bias != nullptr) l = __fadd_rn(l, bias[(size_t)bm * T + t]);
      logits[t] = l;
    }
  }
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) mx = fmaxf(mx, logits[t]);
  mx = warp_max(mx);
  if (lane == 0) scratch[0][warp] = mx;
  __syncthreads();
  mx = scratch[0][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, scratch[0][w]);
  if (fresh) mx = fmaxf(mx, lc);
  __syncthreads();

  // w = exp(logit - m); the denominator sums w, the V product takes w * vs
  float sum = 0.0f;
  float wv_max = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float w = expf(logits[t] - mx);
    const float wv =
        __fmul_rn(w, __bfloat162float(vsc[((size_t)bm * T + t) * H + h]));
    logits[t] = wv;
    sum += w;
    wv_max = fmaxf(wv_max, wv);
  }
  sum = warp_sum(sum);
  wv_max = warp_max(wv_max);
  if (lane == 0) {
    scratch[0][warp] = sum;
    scratch[1][warp] = wv_max;
  }
  __syncthreads();
  float denom = 0.0f;
  wv_max = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    denom += scratch[0][w];
    wv_max = fmaxf(wv_max, scratch[1][w]);
  }
  const float wc = fresh ? expf(lc - mx) : 0.0f;
  denom += wc;
  const float ws = __fdiv_rn(fmaxf(wv_max, 1e-30f), 127.0f);
  int* wq = reinterpret_cast<int*>(logits);
  for (int t = tid; t < n_keys; t += THREADS)
    wq[t] = __float2int_rn(__fdiv_rn(logits[t], ws));
  __syncthreads();

  // integer PV: each lane owns four output dims (one V word per key row)
  int acc[4] = {0, 0, 0, 0};
  for (int t0 = warp * RPW; t0 < n_keys; t0 += WARPS * RPW) {
    const int t = t0 + lane / LPR;
    if (t < n_keys) {
      const int w = wq[t];
      const int32_t vw = *reinterpret_cast<const int32_t*>(
          vc + ((size_t)bm * T + t) * E + head + 4 * sub);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += w * (int)(int8_t)(vw >> (8 * j));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
    if (lane < LPR) red[warp][4 * lane + j] = acc[j];
  }
  __syncthreads();

  if (tid < DH) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][tid];
    float o = __fmul_rn(__int2float_rn(s), ws);
    if (fresh) o = __fadd_rn(o, __fmul_rn(wc, v_fresh[tid]));
    out[(size_t)b * E + head + tid] = __float2bfloat16(__fdiv_rn(o, denom));
  }
}

}  // namespace

// q: (B, q_stride) bf16 with head h's query at columns [h*Dh, (h+1)*Dh); in
// self mode (pos >= 0) the fresh k/v follow at +E and +2E of the same row,
// n_keys == pos, bias is null and mem_group is 1. Cross mode (pos < 0):
// n_keys == T, kc/vc (B / mem_group, T, E) int8, ksc/vsc (B / mem_group, T, H)
// bf16, bias (B / mem_group, T) fp32. out: (B, E) bf16.
extern "C" int acai_decode_attention_int8(const void* q, int q_stride, void* kc,
                                          void* vc, void* ksc, void* vsc, int B,
                                          int H, int dh, int T, int n_keys,
                                          const void* bias, int pos,
                                          int mem_group, float scale, void* out,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * dh;
  dim3 grid(H, B);
  const size_t smem = (size_t)(n_keys > 0 ? n_keys : 1) * sizeof(float);
#define ACAI_LAUNCH(D)                                                         \
  decode_attention_int8_kernel<D><<<grid, THREADS, smem, s>>>(                 \
      static_cast<const __nv_bfloat16*>(q), q_stride,                          \
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),                      \
      static_cast<__nv_bfloat16*>(ksc), static_cast<__nv_bfloat16*>(vsc), T,   \
      E, H, n_keys, static_cast<const float*>(bias), pos, mem_group, scale,    \
      static_cast<__nv_bfloat16*>(out))
  switch (dh) {
    case 32: ACAI_LAUNCH(32); break;
    case 64: ACAI_LAUNCH(64); break;
    case 128: ACAI_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ACAI_LAUNCH
  return (int)cudaGetLastError();
}
