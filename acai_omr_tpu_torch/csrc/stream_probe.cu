// K22 bulk_copy_ring, K23 clamped_chunk_sum and K24 lane_stream_sum: the
// memory-stream probes.
//
// K22 replaces tools/dma_issue_probe.py `build` (kernel `_kernel` :34,
// pallas_call :77): `steps` grid steps of bytes streamed through an S-slot
// ring in F fragments a step, no compute, the first 8 rows x 128 lanes of
// the last step written out. On Hopper one block per SM streams its share
// of every step: an S-slot ring in dynamic shared memory, one mbarrier a
// slot armed with expect_tx of the slot's bytes, F bulk copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes) a refill, issued S-1
// steps ahead by one elected thread, which then waits on the step's barrier
// parity. A wait that does not end within 5 s of %globaltimer traps instead
// of hanging the card. Block 0 writes the tile from the last step's slot.
// Bound: the streamed bytes over 3.35 TB/s; what the probe measures is how
// the time grows with F, the copies issued.
//
// K23 replaces tools/dma_skip_probe.py `run` (kernel :28, pallas_call :55):
// out (1, E) fp32 = the sum over k <= s of the column sums of x[k], x (n, CH,
// E) bf16, s an int32 in device memory. `clamped`: block k reads chunk
// min(k, s), as the TPU's index map (:49), through volatile loads the
// compiler may not drop, and stores its sums only when k <= s; the re-reads
// of chunk s may come from L2. `skip`: blocks past s return before they load
// anything. A block sums CH / slices rows of one chunk over a 128-column
// strip, 16 bytes a thread a row, eight loads in flight, so that even two
// live chunks put 128 blocks on the card; its 16 row groups are added in
// shared memory in a fixed order into a partial row, and a second launch
// adds the partial rows of k <= s in a fixed order, so two runs are
// bit-equal (no float atomics). Bound: (s + 1) chunks read once.
//
// K24 replaces tools/narrow_lane_dma_probe.py `stream_sum` (pallas_call
// :36): out (1, lanes) = c + the sum over blocks and rows of x (blocks, T,
// lanes) fp32. Memory is linear on Hopper, so the kernel reads x flat and
// coalesced, 16 bytes a thread, lane = index mod lanes; a block's threads
// keep four lane sums each and reduce them by lane in shared memory in a
// fixed order; a second launch, a block per 8 lanes, adds the blocks' rows
// by lane in a fixed order, then to c. Bound: x read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SLOTS = 8;
constexpr unsigned long long WAIT_LIMIT_NS = 5000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = global_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

__global__ void __launch_bounds__(32)
bulk_copy_ring_kernel(const char* __restrict__ src,
                      __nv_bfloat16* __restrict__ out, int steps, int slots,
                      int frags, int slot_bytes, long long step_bytes,
                      int row_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[MAX_SLOTS];
  if (threadIdx.x != 0) return;  // one elected thread issues and waits
  const char* base = src + (size_t)blockIdx.x * slot_bytes;
  for (int s = 0; s < slots; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(&bars[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int frag_bytes = slot_bytes / frags;

  auto refill = [&](int g) {
    const int s = g % slots;
    const uint32_t bar = smem_addr(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar),
                 "r"(slot_bytes)
                 : "memory");
    const char* from = base + (size_t)g * step_bytes;
    unsigned char* to = ring + (size_t)s * slot_bytes;
    for (int f = 0; f < frags; ++f)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(to + (size_t)f * frag_bytes)),
          "l"(from + (size_t)f * frag_bytes), "r"(frag_bytes), "r"(bar)
          : "memory");
  };

  for (int g = 0; g < slots - 1 && g < steps; ++g) refill(g);
  for (int g = 0; g < steps; ++g) {
    if (g + slots - 1 < steps) refill(g + slots - 1);
    wait_parity(smem_addr(&bars[g % slots]), (uint32_t)((g / slots) & 1));
  }
  if (blockIdx.x == 0) {  // rows 0..7, lanes 0..127 of the last step
    const unsigned char* last = ring + (size_t)((steps - 1) % slots) * slot_bytes;
    uint4* o = reinterpret_cast<uint4*>(out);
    for (int v = 0; v < 8 * 16; ++v)
      o[v] = *reinterpret_cast<const uint4*>(last + (size_t)(v / 16) * row_bytes
                                             + (v % 16) * 16);
  }
}

__device__ __forceinline__ uint4 ld_volatile_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void add_bf16x2(float* acc, uint32_t v) {
  acc[0] += __uint_as_float(v << 16);
  acc[1] += __uint_as_float(v & 0xFFFF0000u);
}

constexpr int SUM_THREADS = 256;  // 16 row groups x 16 threads of 8 columns
constexpr int STRIP = 128;        // columns a block sums

// block (k, row slice, strip): rows of one slice of chunk min(k, s), 128
// columns; the 16 row groups reduced in shared memory in a fixed order
__global__ void __launch_bounds__(SUM_THREADS)
chunk_sum_partial_kernel(const __nv_bfloat16* __restrict__ x,
                         const int* __restrict__ s_ptr,
                         float* __restrict__ partial, int n_chunks,
                         int ch_rows, int e, int slices, int skip) {
  __shared__ float red[16][STRIP + 1];
  const int strips = e / STRIP;
  const int strip = blockIdx.x % strips;
  const int sl = (blockIdx.x / strips) % slices;
  const int k = blockIdx.x / strips / slices;
  const int s = *s_ptr;
  if (skip && k > s) return;
  const int c = max(0, min(k, min(s, n_chunks - 1)));
  const int rows = ch_rows / slices;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const char* p = reinterpret_cast<const char*>(
      x + ((size_t)c * ch_rows + (size_t)sl * rows) * e + strip * STRIP +
      8 * tx);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = ty; r < rows; r += 16) {
    const uint4 v = ld_volatile_v4(p + (size_t)r * e * 2);
    add_bf16x2(acc + 0, v.x);
    add_bf16x2(acc + 2, v.y);
    add_bf16x2(acc + 4, v.z);
    add_bf16x2(acc + 6, v.w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty][8 * tx + j] = acc[j];
  __syncthreads();
  if (k <= s && threadIdx.x < STRIP) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) sum += red[g][threadIdx.x];
    partial[((size_t)k * slices + sl) * e + strip * STRIP + threadIdx.x] = sum;
  }
}

// 32 columns a block, 8 parts of the partial rows each, added in order
__global__ void __launch_bounds__(SUM_THREADS)
chunk_sum_final_kernel(const float* __restrict__ partial,
                       const int* __restrict__ s_ptr, float* __restrict__ out,
                       int n_chunks, int slices, int e) {
  __shared__ float red[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x % 32;
  const int part = threadIdx.x / 32;
  const int n_rows = (min(*s_ptr, n_chunks - 1) + 1) * slices;
  float acc = 0.f;
  for (int i = part; i < n_rows; i += 8) acc += partial[(size_t)i * e + col];
  red[part][threadIdx.x % 32] = acc;
  __syncthreads();
  if (part == 0) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += red[q][threadIdx.x];
    out[col] = sum;
  }
}

constexpr int LANE_THREADS = 256;

__global__ void __launch_bounds__(LANE_THREADS)
lane_sum_partial_kernel(const float4* __restrict__ x,
                        float* __restrict__ partial, int vec_per_block,
                        int lanes) {
  __shared__ float red[LANE_THREADS * 4];
  const float4* p = x + (size_t)blockIdx.x * vec_per_block;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int v = threadIdx.x; v < vec_per_block; v += LANE_THREADS) {
    const float4 q = p[v];
    a0 += q.x;
    a1 += q.y;
    a2 += q.z;
    a3 += q.w;
  }
  float* r = red + 4 * threadIdx.x;
  r[0] = a0;
  r[1] = a1;
  r[2] = a2;
  r[3] = a3;
  __syncthreads();
  if (threadIdx.x < lanes) {  // lane L: the threads whose four lanes hold it
    const int lane = threadIdx.x, groups = lanes / 4;
    float s = 0.f;
    for (int t = lane / 4; t < LANE_THREADS; t += groups) s += red[4 * t + lane % 4];
    partial[(size_t)blockIdx.x * lanes + lane] = s;
  }
}

// a block per 8 lanes (all lanes when fewer): lane = t % width, part = t /
// width of the blocks' rows, the parts added in order
__global__ void __launch_bounds__(LANE_THREADS)
lane_sum_final_kernel(const float* __restrict__ partial,
                      const float* __restrict__ c, float* __restrict__ out,
                      int blocks, int lanes) {
  __shared__ float red[LANE_THREADS];
  const int width = min(lanes, 8);
  const int parts = LANE_THREADS / width;
  const int lane = blockIdx.x * width + threadIdx.x % width;
  const int part = threadIdx.x / width;
  float acc = 0.f;
  for (int b = part; b < blocks; b += parts)
    acc += partial[(size_t)b * lanes + lane];
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < width) {
    float sum = c[lane];
    for (int q = 0; q < parts; ++q) sum += red[q * width + threadIdx.x];
    out[lane] = sum;
  }
}

}  // namespace

// K22. src (steps, blocks * slot_bytes) bytes; out (8, 128) bf16. The
// wrapper checks slots in 2..8, slot_bytes % (16 frags) == 0, slot_bytes
// below 2^20 (expect_tx) and slots * slot_bytes within the opt-in shared
// memory; row_bytes is the width of one source row (rows of 128 lanes and
// more, at least 8 of them in a slot).
extern "C" int acai_bulk_copy_ring(const void* src, void* out, int steps,
                                   int blocks, int slots, int frags,
                                   int slot_bytes, int row_bytes,
                                   void* stream) {
  const int dyn = slots * slot_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  bulk_copy_ring_kernel<<<blocks, 32, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<__nv_bfloat16*>(out), steps,
      slots, frags, slot_bytes, (long long)blocks * slot_bytes, row_bytes);
  return (int)cudaGetLastError();
}

// K23. x (n_chunks, ch_rows, e) bf16, s (1,) int32, partial (n_chunks *
// slices, e) fp32 scratch, out (1, e) fp32; e % 128 == 0, ch_rows % slices
// == 0. Two launches.
extern "C" int acai_clamped_chunk_sum(const void* x, const void* s,
                                      void* partial, void* out, int n_chunks,
                                      int ch_rows, int e, int slices, int skip,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chunk_sum_partial_kernel<<<n_chunks * slices * (e / STRIP), SUM_THREADS, 0,
                             st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(s),
      static_cast<float*>(partial), n_chunks, ch_rows, e, slices, skip);
  chunk_sum_final_kernel<<<e / 32, SUM_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const int*>(s),
      static_cast<float*>(out), n_chunks, slices, e);
  return (int)cudaGetLastError();
}

// K24. x flat fp32 of blocks * vec_per_block float4s, vec_per_block a
// multiple of 256; c, out (lanes,) fp32, lanes dividing 1024, 4 <= lanes <=
// 256; partial (blocks, lanes) fp32 scratch. Two launches.
extern "C" int acai_lane_stream_sum(const void* x, const void* c,
                                    void* partial, void* out, int blocks,
                                    int vec_per_block, int lanes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lane_sum_partial_kernel<<<blocks, LANE_THREADS, 0, st>>>(
      static_cast<const float4*>(x), static_cast<float*>(partial),
      vec_per_block, lanes);
  lane_sum_final_kernel<<<(lanes + 7) / 8, LANE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(c),
      static_cast<float*>(out), blocks, lanes);
  return (int)cudaGetLastError();
}
