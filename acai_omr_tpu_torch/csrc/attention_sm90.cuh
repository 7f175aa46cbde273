// attention_sm90.cuh: the building blocks of the Hopper attention kernels, K3
// encoder_attention's forward (encoder_attention.cu) and K7 attention_bwd's
// dQ and dK / dV kernels (attention_bwd.cu), on top of sm90_gemm.cuh's
// mbarriers, TMA and wgmma.
//
// Every kernel built on them has the same shape: one block per 128 rows (of
// queries or keys), a producer warpgroup whose first thread issues the TMA
// loads and two consumer warpgroups of 64 rows; the block's fixed tiles
// arrive on one mbarrier, the streamed 64-row tiles through a ring of STAGES
// stages with full / empty mbarrier pairs. A head is a 64 x Dh box of its
// operand's map (one map per operand over its E columns at the buffer's row
// stride), swizzled across Dh * 2 bytes: 128 at Dh = 64, 64 at Dh = 32.
// Products are wgmma m64nNk16 bf16 -> fp32: logits with both operands
// K-major in shared memory, the P V-like products with A from registers (an
// accumulator's fragment rounded to bf16 pairs) and B read MN-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_gemm.cuh"

namespace attn90 {

constexpr int ROWS = 64;           // a consumer warpgroup's rows; one tile
constexpr int SM90_THREADS = 384;  // producer warpgroup + two consumers
constexpr int STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

// k16 step kk of a tile read K-major: its 64 rows are M or N, Dh runs along
// the contraction (+32 bytes a step inside the swizzled row; SBO: 8 rows).
template <int DH>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return sm90::smem_desc(tile + kk * 32, 16, 8 * DH * 2, DH * 2);
}

// k16 step kk of a tile read MN-major: its 64 rows run along the
// contraction, Dh along N (+16 rows a step; SBO: 8 rows; one atom along N).
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return sm90::smem_desc(tile + kk * 16 * DH * 2, ROWS * DH * 2, 8 * DH * 2,
                         DH * 2);
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DH == 64)
    sm90::wgmma_rs_n64<1>(d, a, db);
  else
    sm90::wgmma_rs_n32<1>(d, a, db);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// This thread's 32 scores of a 64 x 64 tile (rows qa and qa + 8, columns
// 8 j + 2 (lane % 4) + e of key tile kt; the accumulator's layout), scaled and
// biased in place as the JAX kernels bias them: -1e9 for a masked key (its
// validity byte in vb) plus -1e9 for a key after the query when causal.
__device__ __forceinline__ void bias_scores(float (&sc)[32],
                                            const unsigned char* vb, int kt,
                                            int qa, int t4, float scale,
                                            int causal) {
  constexpr float NEG = -1e9f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const uint16_t v2 = *reinterpret_cast<const uint16_t*>(vb + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float kb = (v2 >> (8 * e)) & 0xffu ? 0.0f : NEG;
      const int key = kt * ROWS + col + e;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float cm = (causal && key > qa + 8 * hh) ? NEG : 0.0f;
        float& x = sc[4 * j + 2 * hh + e];
        x = x * scale + (cm + kb);
      }
    }
  }
}

// Release a ring stage: every warp of the consumer arrives once it is done
// with the stage (its wgmma groups retired, its shared reads made).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(empty));
}

// What a block may skip. With `on`, every query row of image b has a key it
// may attend (bidirectional: some key is valid; causal: key 0 is), so each
// row's max is a real logit and a masked key's exp(-1e9 - max) is exactly 0:
// tiles of masked keys add nothing. `last`: the image's last valid key, or
// -1. The count of the barriers' arrivals depends on it, so the scan runs
// before they are set up.
struct Skip {
  bool on;
  int last;
};

__device__ __forceinline__ Skip block_skip(const uint8_t* valid, int Tk,
                                           int causal, int b, int* last_sh) {
  if (threadIdx.x == 0) *last_sh = -1;
  __syncthreads();
  const uint8_t* v = valid + (size_t)b * Tk;
  int loc = -1;
  for (int k = threadIdx.x; k < Tk; k += blockDim.x)
    if (v[k]) loc = k;
  if (loc >= 0) atomicMax(last_sh, loc);
  __syncthreads();
  const int last = *last_sh;
  return {causal ? v[0] != 0 : last >= 0, last};
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* fixed, int arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), arrivals > 0 ? arrivals : 1);
    }
    sm90::mbar_init(sm90::smem_u32(fixed), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// A 64 x Dh accumulator (this warpgroup's rows row0.., this thread's rows
// row0 + 16 warp + lane / 4 (+ 8)) as bf16 into dst (row stride ld), head
// column c0.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t ld,
                                           int c0, const float (&d)[DH / 2],
                                           int lt) {
  const int warp = lt / 32, lane = lt % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* row = dst + (size_t)(warp * 16 + lane / 4 + 8 * hh) * ld +
                         c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
  }
}

}  // namespace attn90
