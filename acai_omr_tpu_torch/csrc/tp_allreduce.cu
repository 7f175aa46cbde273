// K15 tp_allreduce: the all-reduce of the tensor-parallel decode step,
//   out[r] = round_out(sum over ranks of part[i] + bias), for every rank r.
//
// Replaces: `tp_allreduce` inside `_kernel` of ops/pallas_monolith.py in the
// JAX package (:1068-1093, scratch :1790-1800, peers :1575-1587): the three
// row-parallel partial outputs of each decoder layer (self out, cross out,
// ff2) are summed across the model shards by recursive doubling. Round r
// exchanges the running sum with the rank at model coordinate XOR (1 << r)
// and adds it, so tp = 2 computes p0 + p1 and tp = 4 (p0 + p1) + (p2 + p3) on
// every rank; fp32 addition is commutative, so every rank holds the same
// bits. The JAX kernel rotates 2 * nr send slots (nr = log2 tp rounds) so
// that no slot needs a reset between calls; this kernel does the same.
//
// Two modes, one kernel: the monolith step's fp32 partials with the bias
// added once after the sum (`in_bf16` = 0, output bf16 or fp32), and the
// per-op step's sum in the compute dtype (`lax.psum` of a bf16 dot): with
// `in_bf16` = 1 the running sum is rounded to bf16 after every round.
//
// Protocol. One device table holds every rank's input, output, bias, send
// slots (2 * nr, n) fp32 and flag words (nr, chunks). The buffer is cut into
// chunks of 1024 elements; a block owns a chunk of one rank at a time. Per
// round it writes the chunk's running sum into its slot (parity of the call
// x round), releases its flag word with the call's epoch (st.release after a
// fence), acquire-waits until the peer's flag for the same chunk and round
// holds that epoch or a later one, and adds the peer's slot (read through L2,
// ld.global.cg, since L1 is not coherent across SMs). Epochs only grow, so
// the flags need no reset either. A rank runs at most one call ahead of a
// peer it just exchanged with, and all ranks pass every call before any
// passes the next, so two slot sets (even and odd calls) are enough. The
// epoch lives in device memory, one counter per card: every block reads it
// when it starts, and the last block of the launch to finish advances it.
// So no launch argument changes from call to call, and a CUDA graph may
// replay the launch.
//
// Ranks that share a card must be one launch (grid.y = its ranks), launched
// cooperatively so that every block is resident: a rank waiting for a block
// of its peer that has not been scheduled would wait forever. On one card
// (the emulated mesh: every TP shard on cuda:0) that single launch runs the
// whole exchange. With several cards each card launches its own ranks and
// reads its peers' slots and flags through peer-mapped pointers (UVA with
// cudaDeviceEnablePeerAccess), with .sys scope; a one-card mesh never runs
// that form, which tests/test_torch_port_kernels.py holds against the twin on
// two and four cards (test_tp_allreduce_across_cards).
//
// Bound on an H100: the bytes, tp partials read and tp outputs written per
// call ((B, E) each, B <= 128, E = 1024), a few microseconds at 3.35 TB/s; the
// rounds' flag round trips through L2 and the launch make it latency-bound.
//
// The one-card form (tp_allreduce_local_kernel). Where every rank of the group
// lies on one card, every partial is readable in place, so nothing needs to
// be exchanged: one ordinary launch, no slots, flags, epoch or spin loop.
// Each thread owns 8 consecutive elements (E % 8 == 0, so they share a row):
// it loads every rank's bias for them (two float4 each), then every rank's
// partial (two float4 fp32 or one 16-byte bf16 load each), all in flight
// before the first add; sums them once in the tree order of the exchange
// ((p0 + p1) + (p2 + p3), rounded to bf16 after every round in the per-op
// mode), and stores tp outputs, each with its own rank's bias, with 16-byte
// stores into one (tp, B, E) buffer. The same bits as the exchange on every
// rank; a single memory round trip and one launch is all it waits for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "func_attrs.cuh"

namespace {

constexpr int MAX_TP = 4;
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 4;  // elements of one chunk, 4 per thread
constexpr int MAX_DEVICES = 64;
constexpr long long kMaxSpins = 1ll << 28;

struct RankTable {
  const void* in[MAX_TP];
  void* out[MAX_TP];
  const float* bias[MAX_TP];  // nullptr: no bias
  float* slots[MAX_TP];       // (2 * nr, n) fp32 on each rank's card
  unsigned* flags[MAX_TP];    // (nr, chunks) on each rank's card
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool kSys>
__device__ __forceinline__ void release_flag(unsigned* p, unsigned v) {
  if constexpr (kSys) {
    __threadfence_system();
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  } else {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  }
}

template <bool kSys>
__device__ __forceinline__ unsigned acquire_flag(const unsigned* p) {
  unsigned v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
                 : "memory");
  return v;
}

__device__ __forceinline__ void load4(const void* base, int i, int bf16,
                                      float v[4]) {
  if (bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
    v[2] = __low2float(b);
    v[3] = __high2float(b);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

__device__ __forceinline__ void store4(void* base, int i, int bf16,
                                       const float v[4]) {
  if (bf16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kSys>
__global__ void __launch_bounds__(THREADS)
tp_allreduce_kernel(RankTable t, int tp, int rank0, int n, int e, int in_bf16,
                    int out_bf16, unsigned* counters) {
  // counters[0]: this card's epoch (the call's number, from 1);
  // counters[1]: blocks of this launch that have finished
  __shared__ unsigned epoch_s;
  if (threadIdx.x == 0)
    epoch_s = *reinterpret_cast<volatile unsigned*>(counters);
  __syncthreads();
  const unsigned epoch = epoch_s;
  const int rank = rank0 + blockIdx.y;
  const int nr = tp == 4 ? 2 : 1;
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int parity = (int)(epoch & 1u);
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int i = c * CHUNK + threadIdx.x * 4;
    const bool live = i < n;  // n % 4 == 0: a live thread owns 4 elements
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) load4(t.in[rank], i, in_bf16, acc);
    for (int r = 0; r < nr; ++r) {
      const int peer = rank ^ (1 << r);
      const size_t off = (size_t)(parity * nr + r) * n + i;
      if (live)
        __stcg(reinterpret_cast<float4*>(t.slots[rank] + off),
               make_float4(acc[0], acc[1], acc[2], acc[3]));
      __syncthreads();
      if (threadIdx.x == 0) {
        release_flag<kSys>(t.flags[rank] + r * chunks + c, epoch);
        const unsigned* theirs = t.flags[peer] + r * chunks + c;
        // a peer that never arrives (a broken launch) traps the kernel after
        // seconds instead of hanging the card; a real wait is microseconds
        for (long long spin = 0;
             (int)(acquire_flag<kSys>(theirs) - epoch) < 0; ++spin) {
          if (spin > kMaxSpins) __trap();
          __nanosleep(32);
        }
      }
      __syncthreads();
      if (live) {
        const float4 p =
            __ldcg(reinterpret_cast<const float4*>(t.slots[peer] + off));
        acc[0] = __fadd_rn(acc[0], p.x);
        acc[1] = __fadd_rn(acc[1], p.y);
        acc[2] = __fadd_rn(acc[2], p.z);
        acc[3] = __fadd_rn(acc[3], p.w);
        if (in_bf16) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = round_bf16(acc[j]);
        }
      }
    }
    if (live) {
      const float* b = t.bias[rank];
      if (b != nullptr) {
        const int col = i % e;  // e % 4 == 0: the four share a row
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], b[col + j]);
      }
      store4(t.out[rank], i, out_bf16, acc);
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y;
    if (atomicAdd(counters + 1, 1u) == blocks - 1) {  // the last block
      counters[1] = 0u;
      atomicExch(counters, epoch + 1u);
    }
  }
}

// Blocks that may run at once on `dev` for `n_local` ranks (cooperative launch
// limit), cached per device and scope.
template <bool kSys>
int max_blocks_x(int dev, int n_local) {
  static int cache[MAX_DEVICES] = {0};
  int& per_card = cache[dev < MAX_DEVICES ? dev : 0];
  if (per_card == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tp_allreduce_kernel<kSys>, THREADS, 0);
    per_card = coop ? per_sm * sms : -1;
  }
  return per_card < 0 ? -1 : per_card / n_local;
}

// Eight consecutive elements as float: two float4 (fp32) or one 16-byte load
// of eight bf16.
__device__ __forceinline__ void load8(const void* base, int i, int bf16,
                                      float v[8]) {
  if (bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store8(void* base, size_t i, int bf16,
                                       const float v[8]) {
  if (bf16) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

struct LocalTable {
  const void* in[MAX_TP];
  const float* bias[MAX_TP];  // all null: no bias
};

template <int TP>
__global__ void __launch_bounds__(256)
tp_allreduce_local_kernel(LocalTable t, void* out, int n, int e, int in_bf16,
                          int out_bf16) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const bool has_bias = t.bias[0] != nullptr;
  float b[TP][8];
  if (has_bias) {
    const int col = i % e;  // e % 8 == 0: the eight share a row
#pragma unroll
    for (int r = 0; r < TP; ++r) load8(t.bias[r] + col, 0, 0, b[r]);
  }
  float p[TP][8];
#pragma unroll
  for (int r = 0; r < TP; ++r) load8(t.in[r], i, in_bf16, p[r]);
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float a = __fadd_rn(p[0][j], p[1][j]);
    if (in_bf16) a = round_bf16(a);
    if constexpr (TP == 4) {
      float c = __fadd_rn(p[2][j], p[3][j]);
      if (in_bf16) c = round_bf16(c);
      a = __fadd_rn(a, c);
      if (in_bf16) a = round_bf16(a);
    }
    s[j] = a;
  }
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = has_bias ? __fadd_rn(s[j], b[r][j]) : s[j];
    store8(out, (size_t)r * n + i, out_bf16, o);
  }
}

}  // namespace

// The one-card form: every rank of a group of tp (2 or 4) on the current
// device. `in`: tp fp32 (in_bf16 = 0) or bf16 (B, E) buffers of n = B * E
// elements, n % 8 == 0, e % 8 == 0, 16-byte aligned; `bias`: tp fp32 (E,)
// vectors or null (no bias); `out`: one (tp, B, E) buffer, rank r's output at
// r * n. `blocks` x `threads` cover n / 8 threads (local_plan in
// ops/tp_allreduce_kernel.py). Launches on `stream`.
extern "C" int acai_tp_allreduce_local(const void* const* in,
                                       const void* const* bias, void* out,
                                       int tp, int n, int e, int in_bf16,
                                       int out_bf16, int blocks, int threads,
                                       void* stream) {
  if ((tp != 2 && tp != 4) || n <= 0 || n % 8 || e <= 0 || e % 8 || n % e ||
      threads < 32 || threads > 256 || (long long)blocks * threads * 8 < n)
    return (int)cudaErrorInvalidValue;
  LocalTable t;
  for (int r = 0; r < MAX_TP; ++r) {
    t.in[r] = r < tp ? in[r] : nullptr;
    t.bias[r] = r < tp && bias != nullptr ? static_cast<const float*>(bias[r])
                                          : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tp == 2)
    tp_allreduce_local_kernel<2><<<blocks, threads, 0, s>>>(t, out, n, e,
                                                            in_bf16, out_bf16);
  else
    tp_allreduce_local_kernel<4><<<blocks, threads, 0, s>>>(t, out, n, e,
                                                            in_bf16, out_bf16);
  return (int)cudaGetLastError();
}

// One card's launch: its ranks rank0 .. rank0 + n_local - 1 of a group of tp
// (2 or 4). The tables list every rank of the group (tp entries each); `in`
// holds fp32 (in_bf16 = 0) or bf16 (B, E) buffers of n = B * E elements,
// n % 4 == 0, e % 4 == 0; `bias` entries may be null. `counters`: this card's
// two words (epoch, starting at 1; finished blocks, 0). `sys_scope` = 1 when
// the group spans cards. Launches on `stream` of the current device.
extern "C" int acai_tp_allreduce(const void* const* in, void* const* out,
                                 const void* const* bias, void* const* slots,
                                 void* const* flags, int tp, int rank0,
                                 int n_local, int n, int e, int in_bf16,
                                 int out_bf16, void* counters, int sys_scope,
                                 void* stream) {
  if ((tp != 2 && tp != 4) || n_local < 1 || rank0 < 0 ||
      rank0 + n_local > tp || n <= 0 || n % 4 || e <= 0 || e % 4 || n % e)
    return (int)cudaErrorInvalidValue;
  RankTable t;
  for (int r = 0; r < MAX_TP; ++r) {
    const bool has = r < tp;
    t.in[r] = has ? in[r] : nullptr;
    t.out[r] = has ? out[r] : nullptr;
    t.bias[r] = has ? static_cast<const float*>(bias[r]) : nullptr;
    t.slots[r] = has ? static_cast<float*>(slots[r]) : nullptr;
    t.flags[r] = has ? static_cast<unsigned*>(flags[r]) : nullptr;
  }
  int dev = 0;
  cudaGetDevice(&dev);
  const int cap = sys_scope ? max_blocks_x<true>(dev, n_local)
                            : max_blocks_x<false>(dev, n_local);
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int chunks = (n + CHUNK - 1) / CHUNK;
  dim3 grid(chunks < cap ? chunks : cap, n_local);
  unsigned* cnt = static_cast<unsigned*>(counters);
  void* args[] = {&t, &tp, &rank0, &n, &e, &in_bf16, &out_bf16, &cnt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = sys_scope ? (const void*)tp_allreduce_kernel<true>
                             : (const void*)tp_allreduce_kernel<false>;
  const cudaError_t err =
      cudaLaunchCooperativeKernel(fn, grid, dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Lets `dev` read and write the memory of `peer` (the multi-card form).
// Returns the CUDA error, cudaErrorPeerAccessUnsupported where the two cards
// cannot map each other.
extern "C" int acai_tp_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(dev);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// The resource report (func_attrs.cuh): the exchange's kernels ("coop") and
// the one-card form's ("local") at the block sizes their launchers use.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("tp_allreduce", "coop", tp_allreduce_kernel<false>, THREADS, 0),
    ACAI_KERNEL("tp_allreduce", "coop", tp_allreduce_kernel<true>, THREADS, 0),
    ACAI_KERNEL("tp_allreduce", "local", tp_allreduce_local_kernel<2>, 256, 0),
    ACAI_KERNEL("tp_allreduce", "local", tp_allreduce_local_kernel<4>, 256, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
