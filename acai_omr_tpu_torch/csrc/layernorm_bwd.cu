// K8 layernorm_bwd: backward of y = LayerNorm(z) * gamma + beta given the
// saved pre-norm sum z: dz per row, dgamma and dbeta as column sums.
//
// Replaces: `_ln_bwd` of ops/pallas_train_layer.py `_bwd_kernel` in the JAX
// package (the three post-norm LayerNorms of a decoder layer, two of an
// encoder layer), together with the `_apply_drop` that follows it: the
// gradient that flows on into the branch (`dff`, `dca`, `dsa`) is dz with the
// forward's dropout mask applied, the gradient of the residual is dz itself.
//
// g, z: (R, E) bf16; gamma: (E,) fp32. Outputs: dz (R, E) bf16; dz_drop (R, E)
// bf16 or null; dgamma, dbeta (E,) fp32. E % 128 == 0, E <= 1024.
//
// Numerics follow `_ln_bwd`: statistics recomputed in fp32 from z (biased
// variance, eps), gg = g * gamma, dz = inv * (gg - mean(gg) - zh * mean(gg *
// zh)) rounded to bf16 once; dgamma = sum_r g * zh and dbeta = sum_r g in fp32
// over all rows in a fixed order (no atomics: two runs give equal bits).
//
// Bound on an H100: bytes (g and z in, one or two rows out) at 3.35 TB/s.
// Design: three launches. (1) one warp per row, each lane holding E/32 values
// as groups of four neighbouring columns (8-byte accesses, one Philox call per
// group), writes dz, dz_drop and the row's (mean, inv); (2) column partial sums
// over slabs of 256 rows, 32 columns by 8 row lanes per block, reduced through
// shared memory in a fixed order; (3) the sum over the slabs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout.cuh"
#include "func_attrs.cuh"

namespace {

constexpr int ROWS = 4;
constexpr int MAX_G = 8;  // groups of 4 columns per lane: E <= 1024
constexpr int SLAB = 256;
constexpr int CX = 32, CY = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ROWS * 32)
ln_bwd_rows(const __nv_bfloat16* __restrict__ g,
            const __nv_bfloat16* __restrict__ z,
            const float* __restrict__ gamma, __nv_bfloat16* __restrict__ dz,
            __nv_bfloat16* __restrict__ dz_drop, float* __restrict__ stats,
            int R, int E, float eps, DropSpec drop) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int groups = E / 128;
  const size_t off = (size_t)row * E;
  float zv[MAX_G][4], gg[MAX_G][4];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      load4_bf16(z + off + i * 128 + lane * 4, zv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += zv[i][j];
    }
  }
  const float mean = warp_sum(sum) / E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = zv[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / E + eps);
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      const int c = i * 128 + lane * 4;
      load4_bf16(g + off + c, gg[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zv[i][j] = (zv[i][j] - mean) * inv;  // zh
        gg[i][j] *= gamma[c + j];
        s1 += gg[i][j];
        s2 += gg[i][j] * zv[i][j];
      }
    }
  }
  const float m1 = warp_sum(s1) / E;
  const float m2 = warp_sum(s2) / E;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    if (i < groups) {
      const int c = i * 128 + lane * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = round_bf16(inv * (gg[i][j] - m1 - zv[i][j] * m2));
      store4_bf16(dz + off + c, v);
      if (dz_drop != nullptr) {
        drop4(drop, row, c, v);
        store4_bf16(dz_drop + off + c, v);
      }
    }
  }
  if (lane == 0) {
    stats[2 * (size_t)row] = mean;
    stats[2 * (size_t)row + 1] = inv;
  }
}

// partial[(slab, 0, col)] = sum over the slab's rows of g * zh; (slab, 1, col)
// of g.
__global__ void __launch_bounds__(CX * CY)
ln_bwd_cols(const __nv_bfloat16* __restrict__ g,
            const __nv_bfloat16* __restrict__ z,
            const float* __restrict__ stats, float* __restrict__ partial, int R,
            int E) {
  __shared__ float sh[2][CY][CX];
  const int tx = threadIdx.x % CX;
  const int ty = threadIdx.x / CX;
  const int col = blockIdx.x * CX + tx;
  const int r_end = min(R, (int)(blockIdx.y + 1) * SLAB);
  float a = 0.0f, b = 0.0f;
  for (int r = blockIdx.y * SLAB + ty; r < r_end; r += CY) {
    const float gv = __bfloat162float(g[(size_t)r * E + col]);
    const float zh = (__bfloat162float(z[(size_t)r * E + col]) -
                      stats[2 * (size_t)r]) * stats[2 * (size_t)r + 1];
    a += gv * zh;
    b += gv;
  }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  __syncthreads();
  if (ty < 2) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CY; ++i) s += sh[ty][i][tx];
    partial[((size_t)blockIdx.y * 2 + ty) * E + col] = s;
  }
}

__global__ void ln_bwd_final(const float* __restrict__ partial, int slabs,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int E) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * E) return;
  const int which = i / E, col = i % E;
  float s = 0.0f;
  for (int k = 0; k < slabs; ++k) s += partial[((size_t)k * 2 + which) * E + col];
  (which == 0 ? dgamma : dbeta)[col] = s;
}

}  // namespace

// stats: (R, 2) fp32 scratch; partial: (ceil(R / 256), 2, E) fp32 scratch.
extern "C" int acai_layernorm_bwd(const void* g, const void* z,
                                  const void* gamma, void* dz, void* dz_drop,
                                  void* dgamma, void* dbeta, void* stats,
                                  void* partial, int R, int E, float eps,
                                  unsigned drop_thresh, float drop_scale,
                                  unsigned seed0, unsigned seed1,
                                  unsigned drop_stream, int drop_t,
                                  void* stream) {
  if (E % 128 != 0 || E > 128 * MAX_G) return (int)cudaErrorInvalidValue;
  if (dz_drop != nullptr && drop_thresh != 0u && drop_t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d{drop_thresh, drop_scale, seed0, seed1, drop_stream,
                   drop_t > 0 ? drop_t : 1};
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* zp = static_cast<const __nv_bfloat16*>(z);
  ln_bwd_rows<<<(R + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
      gp, zp, static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(dz_drop), static_cast<float*>(stats), R, E,
      eps, d);
  const int slabs = (R + SLAB - 1) / SLAB;
  ln_bwd_cols<<<dim3(E / CX, slabs), CX * CY, 0, s>>>(
      gp, zp, static_cast<const float*>(stats), static_cast<float*>(partial), R,
      E);
  ln_bwd_final<<<(2 * E + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), slabs, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), E);
  return (int)cudaGetLastError();
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("layernorm_bwd", "", ln_bwd_rows, ROWS * 32, 0),
    ACAI_KERNEL("layernorm_bwd", "", ln_bwd_cols, CX * CY, 0),
    ACAI_KERNEL("layernorm_bwd", "", ln_bwd_final, 256, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
