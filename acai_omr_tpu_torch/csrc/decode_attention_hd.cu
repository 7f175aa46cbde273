// K11 decode_attention_hd: single-query attention of the per-op decode step
// over a lane-major (B, H, Dh, T) cache in the compute dtype.
//
// Replaces: ops/pallas_decode.py `_kernel` (the bf16 branch of
// `decode_attention`, pallas_call at :382) of the JAX package. For each
// (row b, head h):
//   logit_t = (<q, k_t> * scale) + bias_t             q, k, v read as fp32
//   m = max_t logit_t,  w_t = exp(logit_t - m)         unnormalised weights
//   out = (sum_t w_t * v_t) / (sum_t w_t)              divide after the V sum
// and the result is rounded to bf16 once. bias (B, T) fp32 is additive
// (0 valid / -1e9 padding) or absent. Only the first n_keys positions are
// read: the caller passes n_keys = pos + 1 for the self-attention, where every
// later position carries the -1e9 bias and so a weight of exactly 0 in fp32.
//
// Bound on an H100: the bytes of the K and V planes read
// (2 * B * H * Dh * n_keys * 2) at 3.35 TB/s; a few flops per byte. Design:
// one block per (row, head) reads its (Dh, T) row-major planes. Logits: the
// threads walk T (neighbouring threads on neighbouring keys, one coalesced
// load per head-dim row), the query in shared memory; the logits stay in
// shared memory; fp32 block reductions give the max and the sum. PV: one warp
// per head-dim row walks the same row of V along T and reduces over its
// lanes. No TMA, no vector loads yet: the first, simple form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int THREADS = 256;
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

// every thread gets the block's max / sum; `red` is reused after the return
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
decode_attention_hd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kT,
                           const __nv_bfloat16* __restrict__ vT,
                           const float* __restrict__ bias, int H, int Dh,
                           int T, int n_keys, float scale,
                           __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;       // [Dh]
  float* w = smem + Dh;   // [n_keys] logits, then weights
  __shared__ float red[WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t row = (size_t)b * H + h;
  const __nv_bfloat16* kp = kT + row * Dh * T;
  const __nv_bfloat16* vp = vT + row * Dh * T;

  for (int d = tid; d < Dh; d += THREADS) qs[d] = __bfloat162float(q[row * Dh + d]);
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s += qs[d] * __bfloat162float(kp[(size_t)d * T + t]);
    s = s * scale;
    if (bias != nullptr) s = s + bias[(size_t)b * T + t];
    w[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, red);

  float sum = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float e = expf(w[t] - mx);
    w[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its barrier also publishes w

  for (int d = warp; d < Dh; d += WARPS) {
    const __nv_bfloat16* vr = vp + (size_t)d * T;
    float acc = 0.0f;
    for (int t = lane; t < n_keys; t += 32) acc += w[t] * __bfloat162float(vr[t]);
    acc = warp_sum(acc);
    if (lane == 0) out[row * Dh + d] = __float2bfloat16(acc / sum);
  }
}

}  // namespace

// q: (B, H, Dh) bf16; kT/vT: (B, H, Dh, T) bf16; bias: (B, T) fp32 or null;
// 1 <= n_keys <= T; out: (B, H, Dh) bf16.
extern "C" int acai_decode_attention_hd(const void* q, const void* kT,
                                        const void* vT, const void* bias,
                                        int B, int H, int Dh, int T,
                                        int n_keys, float scale, void* out,
                                        void* stream) {
  const size_t smem = (size_t)(Dh + n_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_hd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention_hd_kernel<<<dim3(H, B), THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(vT), static_cast<const float*>(bias),
      H, Dh, T, n_keys, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
