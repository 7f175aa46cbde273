// sm90_cluster.cuh: thread-block clusters and unswizzled TMA boxes, shared
// by the kernels that split one reduction across the blocks of a cluster:
// K1's skinny decode kernel and K14's W4A8 product (linear_bias_act.cu,
// quant_linear.cu: K split across the cluster), K2 decode_attention, K6
// decode_attention_int8 and K11 decode_attention_hd (the keys split across
// the cluster), and K17 blockdiag_decode_attention (a row's keys split
// across the cluster).
//
// A cluster's blocks run on neighbouring SMs at the same time and can read
// each other's shared memory (distributed shared memory). The pattern of all
// three: each block stages its partial result in its own shared memory,
// a cluster barrier publishes it, and the partials are summed in rank order
// from distributed shared memory, so one launch gives the same bits on every
// run without atomics or a second launch.

#pragma once

#include <algorithm>
#include <type_traits>

#include "sm90_gemm.cuh"

namespace sm90 {

constexpr int MAX_CLUSTER = 8;  // a portable cluster

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// A barrier of every thread of the cluster (arrive releases and wait
// acquires: shared-memory writes before it are seen by the cluster's reads
// after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

// The address of this block's shared-memory location `p` in block `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  return addr;
}

// Four floats / one float of block `rank`'s shared memory at this block's
// address `p`.
__device__ __forceinline__ float4 load_peer4(const float* p, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(peer_addr(p, rank))
               : "memory");
  return v;
}

__device__ __forceinline__ float load_peer(const float* p, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(peer_addr(p, rank))
               : "memory");
  return v;
}

// One int / four ints of block `rank`'s shared memory at this block's `p`.
__device__ __forceinline__ int load_peer_int(const int* p, int rank) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];"
               : "=r"(v)
               : "r"(peer_addr(p, rank))
               : "memory");
  return v;
}

__device__ __forceinline__ int4 load_peer_int4(const int* p, int rank) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(peer_addr(p, rank))
               : "memory");
  return v;
}

// The value at this block's `p` in each of the cluster's first n blocks
// (n <= MAX_CLUSTER) into v[0 .. n), every load issued before the first is
// used (a distributed load is a round trip of a few hundred cycles; one after
// another they add up).
template <class T>
__device__ __forceinline__ void load_peers(const T* p, int n,
                                           T (&v)[MAX_CLUSTER]) {
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) {
    if constexpr (std::is_same<T, float>::value)
      v[r] = r < n ? load_peer(p, r) : 0.0f;
    else
      v[r] = r < n ? load_peer_int(p, r) : 0;
  }
}

// The two bf16 of a 32-bit word as floats (element 0 in the low half).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// An int8 value as a float (K12, K13, K17), exactly, without the quarter-rate integer
// conversion: the float 2^23 + (b + 128), whose low mantissa byte is the
// byte with its sign bit flipped, less 2^23 + 128. `u`: the byte as stored;
// `flipped`: a word of four int8 values with their sign bits flipped
// (w ^ 0x80808080), j picking the byte.
__device__ __forceinline__ float i8_float(uint32_t biased) {
  return __uint_as_float(biased) - 8388736.0f;
}
__device__ __forceinline__ float i8_byte(uint8_t u) {
  return i8_float(0x4B000000u | ((uint32_t)u ^ 0x80u));
}
__device__ __forceinline__ float i8_lane(uint32_t flipped, int j) {
  return i8_float(__byte_perm(flipped, 0x4B000000u, 0x7540 | j));
}

// Launch `kernel` on `grid` in clusters of `cluster_x` blocks along x.
template <class Kernel, class... Args>
inline int launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                          int cluster_x, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stages of a ring of `tile_bytes` tiles for a launch of `blocks`
// blocks, each holding `fixed_bytes` of shared memory beside its ring: as
// many as `want` (every load of the block in flight) and `max_stages`
// allow, but few enough that the blocks fit the SMs at once where the
// shared memory allows (an SM holds 228 KB, 1 KB of it reserved a block),
// and at least two.
inline int ring_stages(long long blocks, int fixed_bytes, int tile_bytes,
                       int max_stages, int want) {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
    return n;
  }();
  const long long per_sm =
      std::min<long long>(8, std::max<long long>(1, (blocks + sms - 1) / sms));
  const int budget = (int)(228 * 1024 / per_sm) - 1024 - fixed_bytes;
  return std::max(2, std::min({want, max_stages, budget / tile_bytes}));
}

// The unswizzled map of a row-major bf16 matrix (encode_map,
// sm90_gemm.cuh): a box lands in shared memory row after row, box_cols * 2
// bytes a row (a multiple of 16).
inline int tensor_map_plain(CUtensorMap* map, const void* ptr, long long rows,
                            long long cols, int box_rows, int box_cols,
                            long long ld) {
  if (box_cols % 8 != 0) return (int)cudaErrorInvalidValue;
  return encode_map(map, ptr, rows, cols, ld, box_rows, box_cols,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace sm90
