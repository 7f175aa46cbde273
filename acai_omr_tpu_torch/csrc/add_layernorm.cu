// K4 add_layernorm: out = LayerNorm(bf16(x + r)) * gamma + beta, stats in fp32.
//
// Replaces: the post-norm residual LayerNorms of both Pallas bodies in the JAX
// package -- `_ln` of ops/pallas_monolith.py `_kernel` (after the self-attn,
// cross-attn and FFN residuals) and `_ln_fwd` of ops/pallas_train_layer.py
// `_fwd_kernel`. As there, the residual sum is taken in the compute dtype
// (rounded to bf16) before the fp32 statistics; biased variance, eps given.
//
// Bound on an H100: bytes (two bf16 rows in, one out, per row) at 3.35 TB/s;
// a row reduction with nothing for the tensor cores. Design: one warp per row,
// each lane holding E/32 values in registers (E % 32 == 0, E <= 1024), two-pass
// mean/variance by warp shuffles, four rows per block.
//
// Training modes: with `zout` given the rounded sum z = x + r is written too
// (the forward's saved pre-norm residuals z1, z2, z3); with r == nullptr the
// kernel is LayerNorm(x) alone (the backward re-derives x1 = LN(z1) and
// x2 = LN(z2) from the saved sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "func_attrs.cuh"

namespace {

constexpr int ROWS = 4;
constexpr int MAX_PER = 32;  // E <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ROWS * 32)
add_layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ zout, int R, int E, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int per = E / 32;
  const size_t off = (size_t)row * E;
  float v[MAX_PER];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const int c = i * 32 + lane;
      if (r != nullptr) {
        const __nv_bfloat16 z = __float2bfloat16(__bfloat162float(x[off + c]) +
                                                 __bfloat162float(r[off + c]));
        if (zout != nullptr) zout[off + c] = z;
        v[i] = __bfloat162float(z);
      } else {
        v[i] = __bfloat162float(x[off + c]);
      }
      sum += v[i];
    }
  }
  const float mean = warp_sum(sum) / E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / E + eps);
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const int c = i * 32 + lane;
      out[off + c] = __float2bfloat16((v[i] - mean) * inv * gamma[c] + beta[c]);
    }
  }
}

}  // namespace

// x, r, out, zout: (R, E) bf16 (r and zout may be null); gamma, beta: (E,)
// fp32. E % 32 == 0, E <= 1024.
extern "C" int acai_add_layernorm(const void* x, const void* r,
                                  const void* gamma, const void* beta,
                                  void* out, void* zout, int R, int E,
                                  float eps, void* stream) {
  if (E % 32 != 0 || E > 32 * MAX_PER) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  add_layernorm_kernel<<<(R + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(zout), R, E,
      eps);
  return (int)cudaGetLastError();
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("add_layernorm", "", add_layernorm_kernel, ROWS * 32, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
