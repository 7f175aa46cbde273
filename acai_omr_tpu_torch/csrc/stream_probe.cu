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
// E) bf16, s an int32 in device memory. The TPU's grid walks k = 0 .. n-1 in
// order, its index map asks for block min(k, s) (:49) and the kernel adds
// only when k <= s; the probe asks whether the pipeline skips the copy of a
// block whose index did not change since the last step.
//
// The walk (`chunk_walk_kernel`, one launch): a block owns one tile, R rows
// of a chunk x one 128-column strip (ops/stream_probe_kernels.chunk_tiles:
// (64, 4096, 1024) gives 32 row slices x 8 strips, 256 blocks of 128 x 128,
// two an SM, so that even the 16 MiB of s = 1 fill the card), and walks k =
// 0 .. n-1 as the TPU's "arbitrary" grid axis does (`skip`: only to
// min(s, n-1)). Step k asks for chunk c = min(k, s), and the block copies it
// (a TMA 3-D box, rows past CH zero, into a ring slot armed with expect_tx)
// only when k <= s and c differs from the previous step's c: the Pallas
// pipeline's rule, so chunks 0 .. min(s, n-1) are read once each and the
// steps past s issue nothing and add nothing. The rule needs no state
// (`walk_copies`; ops/stream_probe_kernels.walk_copies is the same rule), so
// a warp decides 32 steps with one ballot: warp 0 walks ahead and its lane 0
// issues the copies, up to four in flight, and every warp walks behind it.
// 16 row groups x 16 threads of 8 columns sum a tile from shared memory
// into registers, in chunk and row order; the row groups meet in shared
// memory in a fixed order into the tile's partial row; the last block of a
// strip to take an integer ticket adds the strip's partial rows in a fixed
// order (every load in flight at once) and resets the ticket, so two runs
// are bit-equal with no float atomics. The partial rows and tickets are
// scratch the wrapper allocates once per shape. Bound: (s + 1) chunks read
// once.
//
// The form it replaced (`chunk_sum_partial_kernel` + `chunk_sum_final_kernel`,
// kept as the yardstick, variant "grid"): two launches; a block per (k, row
// slice, strip), n x 8 x E / 128 blocks whatever s is, each reading chunk
// min(k, s) through volatile loads and storing its sums only when k <= s
// (`skip`: blocks past s return first), so at s = 1 the blocks past s
// re-read chunk 1 from L2; a second launch adds the partial rows.
//
// K24 replaces tools/narrow_lane_dma_probe.py `stream_sum` (pallas_call
// :36): out (1, lanes) = c + the sum over blocks and rows of x (blocks, T,
// lanes) fp32. Memory is linear on Hopper, so the kernel reads x flat and
// coalesced, 16 bytes a thread, lane = index mod lanes. Bound: x read once;
// at 16 lanes (8 MiB) a launch and one round trip weigh as much as the
// stream.
//
// The one-launch form (`lane_sum_kernel`): a persistent grid of at most one
// 256-thread block an SM (ops/stream_probe_kernels.stream_plan) walks the
// flat stream grid-stride in steps of 16 x 16 bytes a thread: each thread
// issues a step's sixteen loads before it adds any, and the next step's
// sixteen before it adds the current one, so the stream has no gap between
// steps. The stride in floats, 4 x the grid's threads, is a multiple of 1024
// and so of lanes, so a thread's four accumulators hold the same four lanes
// at every step; loads past the end are not issued. A block reduces its
// threads' float4s by lane in a tree of fixed order with one barrier
// (`lane_tree`: shuffles inside each warp over the lanes that hold a lane's
// column, then the warps' rows added in warp order) into one partial row;
// the last block to take an integer ticket adds every block's partial row,
// all its loads in flight, then c, and resets the ticket. One block an SM
// keeps the rows few (66 KB at 128 lanes for the last block to read, which
// one SM reads alone). The partial rows and the ticket are scratch the
// wrapper allocates once per shape: no float atomics, so two runs are
// bit-equal. (Tried on the card and not kept: 512- or 1024-thread blocks
// with wider trees, and bulk copies through a shared-memory ring, which
// streamed 64 MiB no faster and were slower at 8 MiB.)
//
// The form it replaced (`lane_sum_partial_kernel` + `lane_sum_final_kernel`,
// kept as the yardstick, variant "two_pass"): up to 512 blocks of one
// contiguous range each, four lane sums a thread reduced by a 64-long serial
// walk of shared memory a lane; a second launch, a block per 8 lanes, adds
// the blocks' rows by lane in a fixed order, then to c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"
#include "sm90_gemm.cuh"

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

constexpr int WALK_THREADS = 256;  // 16 row groups x 16 threads of 8 columns
constexpr int WALK_MAX_SLOTS = 4;

// Whether step k of the walk copies chunk min(k, s): k <= s and the index
// changed since step k - 1 (whose index was min(k - 1, s); none before step
// 0). The rule needs no state, so a warp's lanes decide 32 steps at once.
__device__ __forceinline__ bool walk_copies(int k, int s) {
  return k <= s && min(k, s) != (k == 0 ? -1 : min(k - 1, s));
}

// The steps of [k0, k0 + 32) below `steps` that copy, a bit each, decided by
// lane l for step k0 + l (the whole warp calls it).
__device__ __forceinline__ unsigned walk_window(int k0, int steps, int s) {
  const int k = k0 + (int)(threadIdx.x % 32);
  return __ballot_sync(0xffffffffu, k < steps && walk_copies(k, s));
}

// One 3-D box of `map` at (c0 = column, c1 = row, c2 = chunk).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// block (slice, strip) over the tile of `rows` rows x 128 columns of every
// chunk it copies; grid slices x strips
__global__ void __launch_bounds__(WALK_THREADS)
chunk_walk_kernel(const __grid_constant__ CUtensorMap tx,
                  const int* __restrict__ s_ptr, float* __restrict__ partial,
                  int* __restrict__ tickets, float* __restrict__ out,
                  int n_chunks, int e, int rows, int slices, int slots,
                  int skip) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[WALK_MAX_SLOTS];
  __shared__ float red[16][STRIP + 1];
  __shared__ int is_last;
  const int strips = e / STRIP;
  const int strip = blockIdx.x % strips, slice = blockIdx.x / strips;
  const int tid = threadIdx.x, tx16 = tid % 16, ty = tid / 16, warp = tid / 32;
  const int s = *s_ptr;
  const int steps = skip ? max(0, min(s, n_chunks - 1) + 1) : n_chunks;
  const uint32_t tile_bytes = (uint32_t)rows * STRIP * 2;
  const uint32_t raw = sm90::smem_u32(ring);
  const uint32_t base = (raw + 127u) & ~127u;  // a TMA box's alignment
  const unsigned char* slots_at = ring + (base - raw);

  // warp 0 walks ahead of the adds and its lane 0 issues the copies: `pk`
  // the next step it looks at
  const int lane = tid % 32;
  int pk = 0, issued = 0;
  auto issue_next = [&]() {  // warp 0: the next copy step's copy
    for (; pk < steps; pk += 32) {
      const unsigned m = walk_window(pk, steps, s);
      if (m == 0) continue;
      const int k = pk + __ffs(m) - 1;
      pk = k + 1;
      if (lane == 0) {
        const int slot = issued % slots;
        const uint32_t bar = sm90::smem_u32(&full[slot]);
        sm90::mbar_expect_tx(bar, tile_bytes);
        tma_load_3d(base + slot * tile_bytes, &tx, bar, strip * STRIP,
                    slice * rows, min(k, s));
      }
      ++issued;
      return;
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      for (int i = 0; i < slots; ++i)
        sm90::mbar_init(sm90::smem_u32(&full[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    for (int i = 0; i < slots; ++i) issue_next();
  }
  __syncthreads();  // the barriers are initialised

  // every warp walks the steps 32 at a time and adds the tile of each step
  // that copies, in step order
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int used = 0;
  for (int k0 = 0; k0 < steps; k0 += 32) {
    unsigned m = walk_window(k0, steps, s);
    while (m != 0) {
      m &= m - 1;  // step k0 + ffs(m) - 1: its copy is the next one in the ring
      const int slot = used % slots;
      sm90::mbar_wait(sm90::smem_u32(&full[slot]),
                      (uint32_t)((used / slots) & 1));
      const unsigned char* tile =
          slots_at + (size_t)slot * tile_bytes + 16 * tx16;
#pragma unroll 4
      for (int r = ty; r < rows; r += 16) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(tile + r * (STRIP * 2));
        add_bf16x2(acc + 0, v.x);
        add_bf16x2(acc + 2, v.y);
        add_bf16x2(acc + 4, v.z);
        add_bf16x2(acc + 6, v.w);
      }
      ++used;
      __syncthreads();  // the slot is read: warp 0 refills it
      if (warp == 0) issue_next();
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty][8 * tx16 + j] = acc[j];
  __syncthreads();
  const int col = strip * STRIP + tid;
  if (tid < STRIP) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) sum += red[g][tid];
    partial[(size_t)slice * e + col] = sum;
    __threadfence();  // the partial row is seen before the ticket
  }
  // the last block of the strip adds the slices' partial rows: thread t
  // sums slices t / 32, t / 32 + 8, ... of columns 4 (t % 32) .. + 3 (every
  // load in flight at once), then the eight sums of a column in order
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[strip], 1) == slices - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int c4 = strip * STRIP + 4 * (tid % 32), grp = tid / 32;
  float4 sum4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int q = grp; q < slices; q += 8) {
    const float4 v =
        __ldcg(reinterpret_cast<const float4*>(partial + (size_t)q * e + c4));
    sum4.x += v.x;
    sum4.y += v.y;
    sum4.z += v.z;
    sum4.w += v.w;
  }
  float* r8 = &red[0][0];  // (8, 128) sums, the row groups' sums are read
  r8[grp * STRIP + 4 * (tid % 32) + 0] = sum4.x;
  r8[grp * STRIP + 4 * (tid % 32) + 1] = sum4.y;
  r8[grp * STRIP + 4 * (tid % 32) + 2] = sum4.z;
  r8[grp * STRIP + 4 * (tid % 32) + 3] = sum4.w;
  __syncthreads();
  if (tid < STRIP) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += r8[q * STRIP + tid];
    out[col] = sum;
  }
  if (tid == 0) tickets[strip] = 0;  // ready for the next call
}

constexpr int LANE_THREADS = 256;  // the blocks of both forms
constexpr int LANE_WARPS = LANE_THREADS / 32;
constexpr int LANE_VEC = 16;   // float4 loads a thread issues a step
constexpr int FINAL_VEC = 24;  // the last block's loads in flight a thread

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int s) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, s),
                     __shfl_xor_sync(0xffffffffu, v.y, s),
                     __shfl_xor_sync(0xffffffffu, v.z, s),
                     __shfl_xor_sync(0xffffffffu, v.w, s));
}

// The lane sums of a block's float4s, thread t's float4 holding lanes
// 4 (t mod q) .. + 3 (q = lanes / 4, a power of two dividing 256), in a
// fixed order with one barrier: inside each warp a butterfly over the
// strides 16 .. q (both lanes of a pair add the same two values, so every
// lane of a column holds the same bits), then column t (t < q) adds the
// rows of the warps that hold it in warp order (every warp where q <= 32;
// where q = 64, the warps w with w mod 2 = t / 32). `sm`: LANE_WARPS x 32
// float4s. Thread t < q returns the sums of float4 column t.
__device__ __forceinline__ float4 lane_tree(float4 v, float4 (*sm)[32],
                                            int q) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (int s = 16; s >= q; s /= 2) v = add4(v, shfl_xor4(v, s));
  sm[warp][lane] = v;
  __syncthreads();
  if (t < q) {
    const int per = q > 32 ? q / 32 : 1;
    v = sm[t / 32][t % 32];
    for (int w = t / 32 + per; w < LANE_WARPS; w += per)
      v = add4(v, sm[w][t % 32]);
  }
  return v;
}

// a step's loads of thread i (those below n4; zeros past it)
__device__ __forceinline__ void load_step(float4 (&v)[LANE_VEC],
                                          const float4* __restrict__ x,
                                          long long at, long long threads,
                                          long long n4) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < LANE_VEC; ++j) {
    const long long k = at + j * threads;
    v[j] = k < n4 ? __ldg(x + k) : zero;
  }
}

// grid: stream_plan's blocks (at most one an SM), LANE_THREADS threads
__global__ void __launch_bounds__(LANE_THREADS, 1)
lane_sum_kernel(const float4* __restrict__ x, const float* __restrict__ c,
                float4* __restrict__ partial, int* __restrict__ ticket,
                float* __restrict__ out, long long n4, int lanes) {
  __shared__ float4 sm[LANE_WARPS][32];
  __shared__ int is_last;
  const int q = lanes / 4, tid = threadIdx.x;
  const long long threads = (long long)gridDim.x * LANE_THREADS;
  const long long step = threads * LANE_VEC;
  const long long i = (long long)blockIdx.x * LANE_THREADS + tid;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  float4 cur[LANE_VEC];
  load_step(cur, x, i, threads, n4);
  for (long long at = i + step; at - step < n4; at += step) {
    float4 nxt[LANE_VEC];
    load_step(nxt, x, at, threads, n4);  // in flight while cur is added
#pragma unroll
    for (int j = 0; j < LANE_VEC; ++j) {
      acc = add4(acc, cur[j]);
      cur[j] = nxt[j];
    }
  }
  acc = lane_tree(acc, sm, q);
  if (tid < q) {
    partial[(size_t)blockIdx.x * q + tid] = acc;
    __threadfence();  // the partial row is seen before the ticket
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: thread t adds float4 column t mod q of rows t / q,
  // t / q + LANE_THREADS / q, ..., FINAL_VEC loads in flight at a time
  const int col = tid % q, stride = LANE_THREADS / q;
  const int blocks = gridDim.x;
  float4 sum = zero;
  for (int r0 = tid / q; r0 < blocks; r0 += FINAL_VEC * stride) {
    float4 v[FINAL_VEC];
#pragma unroll
    for (int j = 0; j < FINAL_VEC; ++j) {
      const int r = r0 + j * stride;
      v[j] = r < blocks ? __ldcg(partial + (size_t)r * q + col) : zero;
    }
#pragma unroll
    for (int j = 0; j < FINAL_VEC; ++j) sum = add4(sum, v[j]);
  }
  sum = lane_tree(sum, sm, q);
  if (tid < q) {
    const int l = 4 * tid;
    out[l + 0] = sum.x + c[l + 0];
    out[l + 1] = sum.y + c[l + 1];
    out[l + 2] = sum.z + c[l + 2];
    out[l + 3] = sum.w + c[l + 3];
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

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

// K23's replaced form (variant "grid"). x (n_chunks, ch_rows, e) bf16, s
// (1,) int32, partial (n_chunks * slices, e) fp32 scratch, out (1, e) fp32;
// e % 128 == 0, ch_rows % slices == 0. Two launches.
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

// The 3-D map of x (n_chunks, ch_rows, e) bf16: boxes of `rows` rows x 128
// columns of one chunk, rows past ch_rows zero.
static int chunk_map(CUtensorMap* map, const void* x, int n_chunks,
                     int ch_rows, int e, int rows) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)ch_rows,
                              (cuuint64_t)n_chunks};
  const cuuint64_t strides[2] = {(cuuint64_t)e * 2,
                                 (cuuint64_t)ch_rows * e * 2};
  const cuuint32_t box[3] = {(cuuint32_t)STRIP, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// K23, the walk: x (n_chunks, ch_rows, e) bf16, 16-byte aligned; s (1,)
// int32; partial (slices, e) fp32 and tickets (e / 128,) int32 scratch, the
// tickets zero (the kernel leaves them zero); out (1, e) fp32. e % 128 == 0,
// rows in 16..128 with slices = ceil(ch_rows / rows), slots 2..4. One launch.
extern "C" int acai_clamped_chunk_walk(const void* x, const void* s,
                                       void* partial, void* tickets, void* out,
                                       int n_chunks, int ch_rows, int e,
                                       int rows, int slices, int slots,
                                       int skip, void* stream) {
  if (e % STRIP != 0 || rows < 16 || rows > 128 || rows % 16 != 0 ||
      slices != (ch_rows + rows - 1) / rows || slots < 2 ||
      slots > WALK_MAX_SLOTS || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx;
  const int rc = chunk_map(&tx, x, n_chunks, ch_rows, e, rows);
  if (rc != 0) return rc;
  const int dyn = slots * rows * STRIP * 2 + 128;  // + the ring's alignment
  const cudaError_t err = cudaFuncSetAttribute(
      chunk_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  chunk_walk_kernel<<<slices * (e / STRIP), WALK_THREADS, dyn,
                      static_cast<cudaStream_t>(stream)>>>(
      tx, static_cast<const int*>(s), static_cast<float*>(partial),
      static_cast<int*>(tickets), static_cast<float*>(out), n_chunks, e, rows,
      slices, slots, skip);
  return (int)cudaGetLastError();
}

// K24, one launch: x flat fp32 of n4 float4s, 16-byte aligned; c, out
// (lanes,) fp32, lanes dividing 1024, 4 <= lanes <= 256; partial (blocks,
// lanes) fp32 (16-byte aligned) and ticket (1,) int32 scratch, the ticket
// zero (the kernel leaves it zero).
extern "C" int acai_lane_stream_sum(const void* x, const void* c,
                                    void* partial, void* ticket, void* out,
                                    long long n4, int blocks, int lanes,
                                    void* stream) {
  if (lanes < 4 || lanes > 256 || 1024 % lanes != 0 || blocks < 1 ||
      n4 < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  lane_sum_kernel<<<blocks, LANE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(c),
      static_cast<float4*>(partial), static_cast<int*>(ticket),
      static_cast<float*>(out), n4, lanes);
  return (int)cudaGetLastError();
}

// K24's replaced form (variant "two_pass"). x flat fp32 of blocks *
// vec_per_block float4s, vec_per_block a multiple of 256; c, out (lanes,)
// fp32, lanes dividing 1024, 4 <= lanes <= 256; partial (blocks, lanes) fp32
// scratch. Two launches.
extern "C" int acai_lane_stream_sum_two_pass(const void* x, const void* c,
                                             void* partial, void* out,
                                             int blocks, int vec_per_block,
                                             int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lane_sum_partial_kernel<<<blocks, LANE_THREADS, 0, st>>>(
      static_cast<const float4*>(x), static_cast<float*>(partial),
      vec_per_block, lanes);
  lane_sum_final_kernel<<<(lanes + 7) / 8, LANE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(c),
      static_cast<float*>(out), blocks, lanes);
  return (int)cudaGetLastError();
}

// The resource report (func_attrs.cuh): K23's walk at the tool's plan (three
// slots of 128 x 128 bf16), the grid form it replaced; K22; K24's one-launch
// kernel and the two-pass form it replaced.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("clamped_chunk_sum", "", chunk_walk_kernel, WALK_THREADS,
                3 * 128 * STRIP * 2 + 128),
    ACAI_KERNEL("clamped_chunk_sum", "grid", chunk_sum_partial_kernel,
                SUM_THREADS, 0),
    ACAI_KERNEL("clamped_chunk_sum", "grid", chunk_sum_final_kernel,
                SUM_THREADS, 0),
    ACAI_KERNEL("bulk_copy_ring", "", bulk_copy_ring_kernel, 32,
                3 * 64 * 1024),
    ACAI_KERNEL("lane_stream_sum", "", lane_sum_kernel, LANE_THREADS, 0),
    ACAI_KERNEL("lane_stream_sum", "two_pass", lane_sum_partial_kernel,
                LANE_THREADS, 0),
    ACAI_KERNEL("lane_stream_sum", "two_pass", lane_sum_final_kernel,
                LANE_THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
