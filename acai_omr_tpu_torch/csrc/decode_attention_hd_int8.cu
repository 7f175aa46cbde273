// K12 decode_attention_hd_int8: single-query attention of the per-op decode
// step over an int8 lane-major cache, per layer or reading one layer of a
// stacked cache.
//
// Replaces: ops/pallas_decode.py `_kernel_int8` (the int8 branch of
// `decode_attention`, pallas_call at :374) and `_kernel_int8_stacked`
// (`decode_attention_stacked`, pallas_call at :329) of the JAX package: one
// kernel, the stacked form selected by a layer index. For each (row b, head h)
// of layer l, with kT/vT int8 (Dh, T) planes and fp32 scales ks/vs (T,):
//   logit_t = ((<q, k_t> * scale) * ks_t) + bias_t    q in fp32, k as integers
//   p_t = exp(logit_t - m) / sum_t exp(logit_t - m)    normalised in fp32
//   out = sum_t (p_t * vs_t) * v_t
// Nothing is rounded to bf16 before the output. bias (B, T) fp32 or absent
// (zeros). Only the first n_keys positions are read (masked weights are
// exactly 0 in fp32).
//
// Bound on an H100: the int8 K and V bytes read (2 * B * H * Dh * n_keys)
// plus their fp32 scales (2 * 4 * B * H * n_keys) at 3.35 TB/s. At the
// per-op step's 4-32 rows one block per (row, head) leaves SMs idle, and
// 1-byte loads strided by T keep few bytes in flight.
//
// Design (`acai_decode_attention_hd_int8_cluster`): the cluster kernel of
// hd_int8_cluster.cuh, K11's design (decode_attention_hd.cu) on int8
// planes, which K13 shares: the keys of a (row, head) split across a
// thread-block cluster (ops/decode_kernel.py `decode_attention_int8_plan`),
// int8 K / V boxes and their fp32 scale boxes by TMA, a thread per key
// column for the logits, the exchanges through distributed shared memory in
// rank order. Here the denominators meet before PV, the same sum in every
// block, and each block normalises its weights before they enter the V sum,
// as the twin does. No atomics: two runs give the same bits.
//
// The kernel it replaced (`acai_decode_attention_hd_int8`, kept as the
// yardstick, `variant="simt"`): one block of 256 threads per (row, head), a
// thread per key walking Dh with 1-byte loads strided by T, every logit of
// the row in shared memory, PV one warp per head-dim row on 1-byte loads.

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
decode_attention_hd_int8_kernel(const __nv_bfloat16* __restrict__ q,
                                const int8_t* __restrict__ kT,
                                const int8_t* __restrict__ vT,
                                const float* __restrict__ ks,
                                const float* __restrict__ vs,
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
  const size_t row = (size_t)b * H + h;  // kT, vT, ks, vs already at layer l
  const int8_t* kp = kT + row * Dh * T;
  const int8_t* vp = vT + row * Dh * T;
  const float* ksr = ks + row * T;
  const float* vsr = vs + row * T;

  for (int d = tid; d < Dh; d += THREADS) qs[d] = __bfloat162float(q[row * Dh + d]);
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s += qs[d] * (float)kp[(size_t)d * T + t];
    s = (s * scale) * ksr[t];
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
  sum = block_sum(sum, red);
  for (int t = tid; t < n_keys; t += THREADS) w[t] = (w[t] / sum) * vsr[t];
  __syncthreads();

  for (int d = warp; d < Dh; d += WARPS) {
    const int8_t* vr = vp + (size_t)d * T;
    float acc = 0.0f;
    for (int t = lane; t < n_keys; t += 32) acc += w[t] * (float)vr[t];
    acc = warp_sum(acc);
    if (lane == 0) out[row * Dh + d] = __float2bfloat16(acc);
  }
}

}  // namespace simt

}  // namespace

// The simt kernel (`variant="simt"`). q: (B, H, Dh) bf16; kT/vT:
// (L, B, H, Dh, T) int8 (L = 1 for a per-layer call) and layer in [0, L);
// ks/vs: (L, B, H, T) fp32; bias: (B, T) fp32 or null; 1 <= n_keys <= T;
// out: (B, H, Dh) bf16.
extern "C" int acai_decode_attention_hd_int8(const void* q, const void* kT,
                                             const void* vT, const void* ks,
                                             const void* vs, const void* bias,
                                             int layer, int B, int H, int Dh,
                                             int T, int n_keys, float scale,
                                             void* out, void* stream) {
  const size_t smem = (size_t)(Dh + n_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simt::decode_attention_hd_int8_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)layer * B * H * Dh * T;
  const size_t splane = (size_t)layer * B * H * T;
  simt::decode_attention_hd_int8_kernel<<<dim3(H, B), simt::THREADS, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(kT) + plane,
      static_cast<const int8_t*>(vT) + plane,
      static_cast<const float*>(ks) + splane,
      static_cast<const float*>(vs) + splane, static_cast<const float*>(bias),
      H, Dh, T, n_keys, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The cluster kernel: the arguments of acai_decode_attention_hd_int8 above
// (Dh 16, 32, 64 or 128), plus `split` and `chunk` as
// acai_decode_attention_cluster takes them (decode_attention.cu).
extern "C" int acai_decode_attention_hd_int8_cluster(
    const void* q, const void* kT, const void* vT, const void* ks,
    const void* vs, const void* bias, int layer, int B, int H, int Dh, int T,
    int n_keys, float scale, int chunk, int split, void* out, void* stream) {
  return hd8::launch_layer<false>(q, kT, vT, ks, vs, bias, layer, B, H, Dh,
                                  T, n_keys, scale, chunk, split, out,
                                  hd8::Fresh{}, stream);
}

// The resource report (func_attrs.cuh): the cluster kernels, which every
// `split{s}` launch runs (`copy`: the tiles copied by the block), at their
// largest dynamic shared memory, and the simt kernel.
#define ACAI_CL(D, TMA, NAME)                                                \
  AcaiKernelEntry {                                                          \
    "decode_attention_hd_int8|split|attend_hd_int8_cluster<" #D "," NAME ">", \
        reinterpret_cast<const void*>(&hd8::attend_hd_int8_cluster<D, TMA>),  \
        hd8::THREADS, hd8::Form<D>::SMEM_MAX                                 \
  }
static const AcaiKernelEntry kResources[] = {
    ACAI_CL(16, true, "tma"),   ACAI_CL(32, true, "tma"),
    ACAI_CL(64, true, "tma"),   ACAI_CL(128, true, "tma"),
    ACAI_CL(16, false, "copy"), ACAI_CL(32, false, "copy"),
    ACAI_CL(64, false, "copy"), ACAI_CL(128, false, "copy"),
    ACAI_KERNEL("decode_attention_hd_int8", "simt",
                simt::decode_attention_hd_int8_kernel, simt::THREADS, 0),
};
#undef ACAI_CL
ACAI_EXPORT_RESOURCES(kResources)
