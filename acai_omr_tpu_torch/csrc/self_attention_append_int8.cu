// K13 self_attention_append_int8: the int8 self-attention of the per-op
// decode step with the fresh token's quantized append, in place.
//
// Replaces: ops/pallas_decode.py `_self_attn_append_kernel` (wrapper
// `self_attention_append_int8` :205, pallas_call at :259) of the JAX package.
// For each (row b, head h) of layer l:
//   1. quantize the fresh k and v head rows: s = max(amax, 1e-8) / 127 in fp32
//      (not rounded), xq = clip(rint(x / s), -127, 127) (division, round half
//      to even), and write xq into column `pos` of the (L, B, H, Dh, T) int8
//      caches and s into column `pos` of the (L, B, H, T) fp32 scales;
//   2. attend over the cached positions t < pos (later ones masked out, not
//      biased) plus the fresh token, analytically from its quantized values:
//        logit_t = (<q, k_t> * scale) * ks_t,  lc = <q, kq * ksc> * scale
//        m = max(max_t logit_t, lc),  w_t = exp(logit_t - m),  wc = exp(lc - m)
//        out = (sum_t (w_t * vs_t) * v_t + wc * (vq * vsc)) / (sum_t w_t + wc)
//      pos = 0 attends to the fresh token alone. Output bf16, rounded once.
// The TPU kernel's 128-lane write-back tile and row tiling are VMEM artefacts
// and are not carried over: only the one column is written.
//
// Bound on an H100: the int8 K and V bytes of positions [0, pos)
// (2 * B * H * Dh * pos) plus their fp32 scales, at 3.35 TB/s. Design: as K11
// (csrc/decode_attention_hd.cu): one block per (row, head), the fresh head
// rows quantized by block reductions, threads along T for the logits, one warp
// per head-dim row for the V sum. A block writes only column `pos` of its own
// (row, head) planes and reads only columns < pos, so blocks never race.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float QMAX = 127.0f;

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
self_attention_append_int8_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k_new,
                                  const __nv_bfloat16* __restrict__ v_new,
                                  int8_t* __restrict__ kc,
                                  int8_t* __restrict__ vc,
                                  float* __restrict__ ks,
                                  float* __restrict__ vs, int H, int Dh,
                                  int T, int pos, float scale,
                                  __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;           // [Dh]
  float* kq = smem + Dh;      // [Dh] quantized fresh k (integer values)
  float* vq = smem + 2 * Dh;  // [Dh] quantized fresh v
  float* w = smem + 3 * Dh;   // [pos] logits, then weights
  __shared__ float red[WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t row = (size_t)b * H + h;  // caches and scales already at layer l
  int8_t* kp = kc + row * Dh * T;
  int8_t* vp = vc + row * Dh * T;
  float* ksr = ks + row * T;
  float* vsr = vs + row * T;

  float ka = 0.0f, va = 0.0f;
  for (int d = tid; d < Dh; d += THREADS) {
    qs[d] = __bfloat162float(q[row * Dh + d]);
    kq[d] = __bfloat162float(k_new[row * Dh + d]);
    vq[d] = __bfloat162float(v_new[row * Dh + d]);
    ka = fmaxf(ka, fabsf(kq[d]));
    va = fmaxf(va, fabsf(vq[d]));
  }
  const float ksc = fmaxf(block_max(ka, red), 1e-8f) / QMAX;
  const float vsc = fmaxf(block_max(va, red), 1e-8f) / QMAX;

  // quantize and append column `pos`; the fresh logit from kq * ksc
  float lc = 0.0f;
  for (int d = tid; d < Dh; d += THREADS) {
    const float kr = fminf(fmaxf(rintf(kq[d] / ksc), -QMAX), QMAX);
    const float vr = fminf(fmaxf(rintf(vq[d] / vsc), -QMAX), QMAX);
    kq[d] = kr;
    vq[d] = vr;
    kp[(size_t)d * T + pos] = (int8_t)kr;
    vp[(size_t)d * T + pos] = (int8_t)vr;
    lc += qs[d] * (kr * ksc);
  }
  if (tid == 0) {
    ksr[pos] = ksc;
    vsr[pos] = vsc;
  }
  lc = block_sum(lc, red) * scale;  // its barrier also publishes vq

  float mx = -FLT_MAX;
  for (int t = tid; t < pos; t += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s += qs[d] * (float)kp[(size_t)d * T + t];
    s = (s * scale) * ksr[t];
    w[t] = s;
    mx = fmaxf(mx, s);
  }
  const float m = fmaxf(block_max(mx, red), lc);

  float sum = 0.0f;
  for (int t = tid; t < pos; t += THREADS) {
    const float e = expf(w[t] - m);
    sum += e;
    w[t] = e * vsr[t];
  }
  const float wc = expf(lc - m);
  const float denom = block_sum(sum, red) + wc;

  for (int d = warp; d < Dh; d += WARPS) {
    const int8_t* vr = vp + (size_t)d * T;
    float acc = 0.0f;
    for (int t = lane; t < pos; t += 32) acc += w[t] * (float)vr[t];
    acc = warp_sum(acc);
    if (lane == 0)
      out[row * Dh + d] = __float2bfloat16((acc + wc * (vq[d] * vsc)) / denom);
  }
}

}  // namespace

// q, k_new, v_new: (B, H, Dh) bf16; kc/vc: (L, B, H, Dh, T) int8 and ks/vs:
// (L, B, H, T) fp32, column `pos` of layer `layer` written in place;
// 0 <= pos < T; out: (B, H, Dh) bf16.
extern "C" int acai_self_attention_append_int8(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    void* ks, void* vs, int layer, int B, int H, int Dh, int T, int pos,
    float scale, void* out, void* stream) {
  const size_t smem = (size_t)(3 * Dh + (pos > 0 ? pos : 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        self_attention_append_int8_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  self_attention_append_int8_kernel<<<dim3(H, B), THREADS, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<int8_t*>(kc) + plane, static_cast<int8_t*>(vc) + plane,
      static_cast<float*>(ks) + splane, static_cast<float*>(vs) + splane, H,
      Dh, T, pos, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
