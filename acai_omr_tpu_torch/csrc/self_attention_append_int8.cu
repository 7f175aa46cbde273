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
// (2 * B * H * Dh * pos) plus their fp32 scales, at 3.35 TB/s. At the
// per-op step's 4-8 rows (after compaction) one block per (row, head) leaves
// most SMs idle, and 1-byte loads strided by T keep few bytes in flight.
//
// Design (`acai_self_attention_append_int8_cluster`): K12's cluster kernel
// (hd_int8_cluster.cuh, FRESH): the keys [0, pos) of a (row, head) split
// across a thread-block cluster as ops/decode_kernel.py
// `decode_attention_int8_plan` splits them for K12, int8 K / V boxes and
// their fp32 scale boxes by TMA, a thread per key column for the logits.
// Every block quantizes the fresh k / v (one warp, while its first tiles are
// in flight) for lc, which enters the max exchange; the partial
// denominators and PV partials meet at one cluster barrier, summed in rank
// order by rank 0, which adds wc last, adds wc * vq * vsc to the V sum,
// divides once and rounds to bf16 once. Rank 0 writes column `pos` and its
// two scales after the cluster's last barrier, when no block can still have
// a read in flight over a box that holds the column. pos = 0 takes one block
// a (row, head) in an ordinary launch: no cluster, no TMA, no cluster
// barrier. No atomics: two runs give the same bits.
//
// The kernel it replaced (`acai_self_attention_append_int8`, kept as the
// yardstick, `variant="simt"`): one block of 256 threads per (row, head), the
// fresh head rows quantized by block reductions, threads along T for the
// logits (1-byte loads strided by T), every logit in shared memory, one warp
// per head-dim row for the V sum. A block writes only column `pos` of its own
// (row, head) planes and reads only columns < pos, so blocks never race.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "func_attrs.cuh"
#include "hd_int8_cluster.cuh"

namespace {

using hd8::warp_max;
using hd8::warp_sum;

// ------------------------------------------------ the simt kernel (yardstick)

namespace simt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float QMAX = 127.0f;

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

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q, k_new, v_new: (B, H, Dh) bf16;
// kc/vc: (L, B, H, Dh, T) int8 and ks/vs: (L, B, H, T) fp32, column `pos` of
// layer `layer` written in place; 0 <= pos < T; out: (B, H, Dh) bf16.
extern "C" int acai_self_attention_append_int8(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    void* ks, void* vs, int layer, int B, int H, int Dh, int T, int pos,
    float scale, void* out, void* stream) {
  const size_t smem = (size_t)(3 * Dh + (pos > 0 ? pos : 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simt::self_attention_append_int8_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  simt::self_attention_append_int8_kernel<<<
      dim3(H, B), simt::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<int8_t*>(kc) + plane, static_cast<int8_t*>(vc) + plane,
      static_cast<float*>(ks) + splane, static_cast<float*>(vs) + splane, H,
      Dh, T, pos, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The cluster kernel: the arguments of acai_self_attention_append_int8 above
// (Dh 16, 32, 64 or 128), plus `split` and `chunk` as
// acai_decode_attention_cluster takes them (decode_attention.cu) for the pos
// keys before the fresh token (pos 0: split 1, no cluster).
extern "C" int acai_self_attention_append_int8_cluster(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    void* ks, void* vs, int layer, int B, int H, int Dh, int T, int pos,
    float scale, int chunk, int split, void* out, void* stream) {
  const hd8::Fresh fr{static_cast<const __nv_bfloat16*>(k_new),
                      static_cast<const __nv_bfloat16*>(v_new),
                      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
                      static_cast<float*>(ks), static_cast<float*>(vs), pos};
  return hd8::launch_layer<true>(q, kc, vc, ks, vs, nullptr, layer, B, H, Dh,
                                 T, pos, scale, chunk, split, out, fr,
                                 stream);
}

// The resource report (func_attrs.cuh): the cluster kernels, which every
// `split{s}` launch runs (`copy`: the tiles copied by the block), at their
// largest dynamic shared memory, and the simt kernel.
#define ACAI_CL(D, TMA, NAME)                                                \
  AcaiKernelEntry {                                                          \
    "self_attention_append_int8|split|append_hd_int8_cluster<" #D "," NAME   \
    ">",                                                                     \
        reinterpret_cast<const void*>(&hd8::append_hd_int8_cluster<D, TMA>),  \
        hd8::THREADS, hd8::Form<D>::SMEM_MAX                                 \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(16, true, "tma"),   ACAI_CL(32, true, "tma"),
    ACAI_CL(64, true, "tma"),   ACAI_CL(128, true, "tma"),
    ACAI_CL(16, false, "copy"), ACAI_CL(32, false, "copy"),
    ACAI_CL(64, false, "copy"), ACAI_CL(128, false, "copy"),
    ACAI_KERNEL("self_attention_append_int8", "simt",
                simt::self_attention_append_int8_kernel, simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
