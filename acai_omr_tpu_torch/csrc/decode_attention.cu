// K2 decode_attention: single-token attention of one decode step.
//
// Replaces: the two `_attend_all` sites of ops/pallas_monolith.py `_kernel`
// (bf16 mode) in the JAX package -- the self-attention over the time-major
// KV cache with the fresh token appended in place at `pos` and folded into the
// softmax analytically, and the cross-attention over the precomputed memory
// K/V with its padding-bias column.
//
// Self mode (k_new != nullptr): q, the fresh k and the fresh v are the three
// E-wide column blocks of one (B, 3E) qkv row. The block for (row b, head h)
// writes the fresh k/v head slice into the (B, T, E) layer caches at `pos`,
// attends over cache positions [0, pos), and folds the fresh token in:
//   lc = <q, k_new> * scale,  m = max(max_t logit_t, lc),
//   out = (sum_t bf16(exp(logit_t - m)) * v_t + exp(lc - m) * v_new)
//         / (sum_t exp(logit_t - m) + exp(lc - m)).
// The unnormalised weights are rounded to bf16 before the PV product and the
// fresh token's term is added in fp32, as the monolith does.
// Cross mode (k_new == nullptr): attends over all n_keys memory positions with
// the additive fp32 bias (0 valid / -1e9 padding), same rounding. With
// mem_group = G > 1 (the bf16 branch of `_attend_shared`: beams of one image)
// the memory and its bias hold B / G rows and batch row b reads row b / G.
// Each of the G rows' blocks reads the shared K/V rows itself (once per row,
// not once per group; the repeats are served by the L2 cache at best).
//
// Bound on an H100: the bytes of the cache rows read (2 * B * n_keys * E * 2)
// at 3.35 TB/s; the arithmetic is a few flops per byte. Design: one block per
// (row, head); each warp walks its share of key rows with one coalesced
// Dh-wide load per row (Dh / 32 bf16 per lane), logits kept in shared memory,
// fp32 softmax statistics by block reductions, then the PV pass over the same
// rows. One block per (row, head) fills the card only at B*H >= ~132*4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, int q_stride,
                        const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new,
                        __nv_bfloat16* __restrict__ kc,
                        __nv_bfloat16* __restrict__ vc, int T, int E,
                        int n_keys, const float* __restrict__ bias, int pos,
                        int mem_group, float scale,
                        __nv_bfloat16* __restrict__ out) {
  constexpr int PER = DH / 32;
  extern __shared__ float logits[];
  __shared__ float red[WARPS][DH];
  __shared__ float scratch[WARPS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bm = b / mem_group;  // row of the caches / memory and the bias
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int col = h * DH + lane * PER;

  float qv[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p)
    qv[p] = __bfloat162float(q[(size_t)b * q_stride + col + p]);

  const bool fresh = k_new != nullptr;
  float lc = -FLT_MAX;
  if (fresh) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const __nv_bfloat16 kv = k_new[(size_t)b * q_stride + col + p];
      const __nv_bfloat16 vv = v_new[(size_t)b * q_stride + col + p];
      s += qv[p] * __bfloat162float(kv);
      if (warp == 0) {
        kc[((size_t)b * T + pos) * E + col + p] = kv;
        vc[((size_t)b * T + pos) * E + col + p] = vv;
      }
    }
    lc = warp_sum(s) * scale;
  }

  // logits over the cache / memory rows
  for (int t = warp; t < n_keys; t += WARPS) {
    const __nv_bfloat16* kr = kc + ((size_t)bm * T + t) * E + col;
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < PER; ++p) s += qv[p] * __bfloat162float(kr[p]);
    s = warp_sum(s);
    if (lane == 0)
      logits[t] = s * scale + (bias != nullptr ? bias[(size_t)bm * T + t] : 0.0f);
  }
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < n_keys; t += THREADS) mx = fmaxf(mx, logits[t]);
  mx = warp_max(mx);
  if (lane == 0) scratch[warp] = mx;
  __syncthreads();
  mx = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, scratch[w]);
  if (fresh) mx = fmaxf(mx, lc);
  __syncthreads();

  float sum = 0.0f;
  for (int t = tid; t < n_keys; t += THREADS) {
    const float w = expf(logits[t] - mx);
    logits[t] = w;
    sum += w;
  }
  sum = warp_sum(sum);
  if (lane == 0) scratch[warp] = sum;
  __syncthreads();
  float denom = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) denom += scratch[w];
  const float wc = fresh ? expf(lc - mx) : 0.0f;
  denom += wc;

  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.0f;
  for (int t = warp; t < n_keys; t += WARPS) {
    const float w = __bfloat162float(__float2bfloat16(logits[t]));
    const __nv_bfloat16* vr = vc + ((size_t)bm * T + t) * E + col;
#pragma unroll
    for (int p = 0; p < PER; ++p) acc[p] += w * __bfloat162float(vr[p]);
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) red[warp][lane * PER + p] = acc[p];
  __syncthreads();

  if (tid < DH) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][tid];
    if (fresh) {
      const float vfresh =
          __bfloat162float(v_new[(size_t)b * q_stride + h * DH + tid]);
      o += wc * vfresh;
    }
    out[(size_t)b * E + h * DH + tid] = __float2bfloat16(o / denom);
  }
}

}  // namespace

// q: (B, q_stride) bf16 with head h's query at columns [h*Dh, (h+1)*Dh).
// Self mode: k_new/v_new point at the fresh k/v blocks of the same rows
// (q + E, q + 2E), pos is the cache slot to write and n_keys == pos; bias is
// null, mem_group is 1. Cross mode: k_new == v_new == null, n_keys == T,
// kc/vc (B / mem_group, T, E) and bias (B / mem_group, T) fp32.
// kc/vc: this layer's (B, T, E) caches in self mode. out: (B, E) bf16.
extern "C" int acai_decode_attention(const void* q, int q_stride,
                                     const void* k_new, const void* v_new,
                                     void* kc, void* vc, int B, int H, int dh,
                                     int T, int n_keys, const void* bias,
                                     int pos, int mem_group, float scale,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * dh;
  dim3 grid(H, B);
  const size_t smem = (size_t)(n_keys > 0 ? n_keys : 1) * sizeof(float);
#define ACAI_LAUNCH(D)                                                         \
  decode_attention_kernel<D><<<grid, THREADS, smem, s>>>(                      \
      static_cast<const __nv_bfloat16*>(q), q_stride,                          \
      static_cast<const __nv_bfloat16*>(k_new),                                \
      static_cast<const __nv_bfloat16*>(v_new),                                \
      static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), T, E,  \
      n_keys, static_cast<const float*>(bias), pos, mem_group, scale,          \
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
