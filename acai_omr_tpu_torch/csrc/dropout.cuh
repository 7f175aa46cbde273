// K10 dropout, the device half: the keep-mask as a counter-based function.
//
// Replaces: `_drop_mask` / `_apply_drop` of ops/pallas_train_layer.py in the
// JAX package, which seed the TPU's hardware generator per (layer, site,
// image). Here the 32 random bits of one element are a pure function of
//
//     key     = (seed0, seed1)
//     counter = (column / 4, row within the image, image index, stream)
//
// through Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3"); the element takes output word `column % 4`. `stream` is
// `layer * 8 + site` inside the stacks. The mask therefore depends on the
// image's global index and on the element's own row and column, never on how
// a kernel tiles the batch or chunks the columns, and the backward
// regenerates the forward's mask from the same arguments.
//
// keep <=> bits >= thresh with thresh = min(rate * 2^32, 2^32 - 1); kept
// values are scaled by `scale` = 1 / (1 - rate) in fp32 and rounded to the
// compute dtype. thresh == 0 switches dropout off. The plain twin
// (ops/dropout_kernel.py) computes the same bits with integer tensor ops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

struct DropSpec {
  uint32_t thresh;  // 0 = off
  float scale;
  uint32_t seed0, seed1;
  uint32_t stream;
  int t;  // rows per image
};

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The bits of the four elements (row, 4 * col4 .. 4 * col4 + 3).
__device__ __forceinline__ uint4 drop_bits(const DropSpec& d, int row,
                                           int col4) {
  return philox4x32_10((uint32_t)col4, (uint32_t)(row % d.t),
                       (uint32_t)(row / d.t), d.stream, d.seed0, d.seed1);
}

// One element that was already rounded to bf16: kept and rescaled, or zero.
__device__ __forceinline__ float drop_apply(const DropSpec& d, float v,
                                            uint32_t bits) {
  if (bits < d.thresh) return 0.0f;
  return __bfloat162float(__float2bfloat16(v * d.scale));
}

// Dropout on four neighbouring elements of one row, in place.
__device__ __forceinline__ void drop4(const DropSpec& d, int row, int col,
                                      float v[4]) {
  if (d.thresh == 0u) return;
  const uint4 b = drop_bits(d, row, col >> 2);
  v[0] = drop_apply(d, v[0], b.x);
  v[1] = drop_apply(d, v[1], b.y);
  v[2] = drop_apply(d, v[2], b.z);
  v[3] = drop_apply(d, v[3], b.w);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load4_bf16(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
