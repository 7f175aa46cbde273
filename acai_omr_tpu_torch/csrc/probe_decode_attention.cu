// K17 blockdiag_decode_attention and K18 batched_decode_attention: the two
// single-query attention formulations of the JAX package's
// tools/attn_microbench.py, one query per (row, head) against lane-major
// kT / vT (B, H, Dh, T), bias (B, T) fp32, fp32 softmax, bf16 out (B, H, Dh).
//
// K17 replaces `_blockdiag_kernel` (:89, `blockdiag_attn` :129, pallas_call
// :151): the 16 heads' queries laid out as a block-diagonal (H, H*Dh)
// operand (15/16 of it zeros) against the row's K2 = (H*Dh, T), one
// matrix-unit product for all heads' logits; fp32 softmax (max, exp, sum,
// divide); for int8 caches the logits times ks and the weights times vs
// (fp32 (B, H, T) scales), the int8 values exact in bf16; weights rounded to
// bf16; then V2 (H*Dh, T) @ w^T (T, H), of which only the block-diagonal
// columns are kept. The probe asks whether that one tensor-core product over
// all heads beats the per-head form (K11).
//
// Bound on an H100: the K and V bytes read once (2 * B*H*Dh*T elements, plus
// the fp32 scales for int8) at 3.35 TB/s; a few flops per byte even counting
// the block-diagonal zeros. So the kernel is a stream, and the design is
// about keeping bytes in flight on every SM (`bd::blockdiag_cluster`):
//
// * The grid follows the card, not `bt`: one thread-block cluster per row b
//   and all 16 heads; the row's T keys split across its 1-8 blocks, block r
//   owning units [r U / split, (r + 1) U / split) of the U = T / 16 key units
//   (ranges in order, none empty; ops/probe_kernels.py `blockdiag_plan`
//   chooses the split, which `bt` does not touch). Split 1 is an ordinary
//   launch.
// * The loads: K and V arrive by TMA in boxes of (128 rows of K2 or V2) x 64
//   keys (bf16, 128-byte swizzle) or 256 rows x 64 keys (int8, 64-byte
//   swizzle), 16 KB a box, from a 2-D map of (B*H*Dh, T), into a ring fed
//   by one producer warp, the first box issued before anything else: K boxes
//   key column by key column, then V boxes row slab by row slab. The first
//   V boxes load while the softmax exchanges run. The ring is the deepest
//   (2-6 stages) at which all B clusters are on the card at once: at 6
//   stages 30 clusters of 8 fit an H100, and two of the microbench's 32 ran
//   as a second wave. The bias's and scales' ranges come by bulk copies
//   into shared memory where two stages leave room for them (else they are
//   prefetched into L2 and read in place with 16-byte loads).
// * The logits stay one tensor-core product over all heads (M = 16 heads,
//   N = keys, K = H*Dh): `mma.sync` m16n8k16 bf16 -> fp32. wgmma's 64-row
//   minimum would be three quarters padding at 16 heads, and its operands
//   would have to be bf16 in shared memory, where int8 boxes are not. Four
//   consumer warps own 16 keys of a 64-key column each; the block-diagonal
//   A fragment of a k-step is the thread's two words of its head's q, or
//   zero (lanes whose row is not the k-step's head), read from the row's q
//   in shared memory: the (16, H*Dh) operand is never materialised. B: bf16
//   boxes through `ldmatrix.trans`; int8 boxes one 4-byte word a row a thread
//   (the 64-byte swizzle puts a load's 16 distinct words on distinct banks),
//   widened in registers with byte permutes (`sm90::i8_lane`, exact) and
//   packed two at a time into bf16 pairs. Four accumulator sets take the
//   k-steps in turn: four mma chains at once.
// * The softmax across the cluster: the twin rounds w = exp(l - m) / sum
//   (times vs) to bf16 before the V product, so every block needs the row's
//   max and sum first. A block keeps its 16 heads' logits (fp32) in shared
//   memory; the per-head maxima, then the per-head partial sums, go through
//   distributed shared memory and every block combines them in rank order
//   (the same bits in every block, no atomics); then each block forms its
//   bf16 weights exactly as the twin does. The exchanges push with
//   `st.async`, which counts the bytes on the receiver's own mbarrier: a
//   block waits for what it receives, not for a cluster barrier (on an H100
//   80GB HBM3 a cluster barrier after remote stores cost about 1.9 us an
//   exchange).
// * The V product, V2 (H*Dh rows x the block's keys) @ w^T (keys x heads):
//   each 16-row slab of V2 lies in one head, so only the n8 tile holding
//   that head is computed and only its column kept. int8 slabs take the keys
//   in the order 4t .. 4t + 3 for the k-slots 2t, 2t + 1, 2t + 8, 2t + 9 (one
//   word a row a thread, widened as above; the weights read in the same
//   order).
// * The partial (H*Dh) outputs meet in distributed shared memory: each
//   block pushes them to their owners, block r adds its share of the
//   elements over all blocks in rank order and rounds each to bf16 once (the
//   same sum rank 0 would form alone), so two runs give the same bits.
// The kernel it replaced (`bt` rows a block, B / bt blocks, two barriers a
// 16-row step of K2) stays as `variant="wmma"`, the yardstick timed in turns.
//
// K18 replaces `_batcheddot_kernel` (:157, `batcheddot_attn` :176,
// pallas_call :184), bf16 only: one warp per (row, head), the logits as a
// CUDA-core dot along Dh (lanes on neighbouring keys, coalesced along T), the
// weights rounded to bf16, the V sum one warp reduction per head-dim row. It
// keeps the TPU's `bt` rows per block, so B / bt blocks stream the whole
// cache: at B = 32 that is 8 of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

#include <type_traits>

#include "func_attrs.cuh"
#include "sm90_cluster.cuh"

using namespace nvcuda;

namespace {

constexpr int H = 16;         // heads: one m16 tile of logits
constexpr int WARPS = 8;      // K17
constexpr int THREADS = 32 * WARPS;
constexpr int E_SLAB = 16 * WARPS;  // V rows per slab, 16 per warp
constexpr int T_SLAB = 64;          // keys per V slab
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// eight neighbouring cache values widened to bf16 (int8 values are exact)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 load8(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16((float)b[i]);
  return *reinterpret_cast<const uint4*>(v);
}

// K17's wmma kernel (variant "wmma", the yardstick): its shared-memory
// layout (bf16 elements unless said), every region starting on a 32-byte
// boundary for the wmma pointers
struct Smem {
  int e, t;
  __host__ __device__ int qbd_ld() const { return e + 8; }
  __host__ __device__ int ks_ld() const { return t + 8; }
  __host__ __device__ int lg_ld() const { return t + 4; }   // fp32
  __host__ __device__ int w_ld() const { return t + 8; }
  __host__ __device__ size_t qbd() const { return 0; }
  __host__ __device__ size_t kst() const { return qbd() + (size_t)H * qbd_ld() * 2; }
  __host__ __device__ size_t lg() const { return kst() + (size_t)16 * ks_ld() * 2; }
  __host__ __device__ size_t w() const { return lg() + (size_t)H * lg_ld() * 4; }
  __host__ __device__ size_t vst() const { return w() + (size_t)H * w_ld() * 2; }
  __host__ __device__ size_t scratch() const {
    return vst() + (size_t)E_SLAB * (T_SLAB + 8) * 2;
  }
  __host__ __device__ size_t bytes() const { return scratch() + WARPS * 256 * 4; }
};

template <typename TK, int NJ>
__global__ void __launch_bounds__(THREADS)
blockdiag_kernel(const __nv_bfloat16* __restrict__ q, const TK* __restrict__ kT,
                 const TK* __restrict__ vT, const float* __restrict__ bias,
                 const float* __restrict__ ks, const float* __restrict__ vs,
                 int bt, int Dh, int T, float scale,
                 __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = H * Dh;
  const Smem L{E, T};
  __nv_bfloat16* qbd = reinterpret_cast<__nv_bfloat16*>(smem + L.qbd());
  __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(smem + L.kst());
  float* lg = reinterpret_cast<float*>(smem + L.lg());
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + L.w());
  __nv_bfloat16* vst = reinterpret_cast<__nv_bfloat16*>(smem + L.vst());
  float* scratch = reinterpret_cast<float*>(smem + L.scratch());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int vld = T_SLAB + 8;

  for (int r = 0; r < bt; ++r) {
    const int b = blockIdx.x * bt + r;
    const TK* k2 = kT + (size_t)b * E * T;  // (E, T) row-major
    const TK* v2 = vT + (size_t)b * E * T;

    // the block-diagonal query: row h holds q[b, h] in columns h*Dh ..
    for (int i = tid; i < H * E; i += THREADS) {
      const int h = i / E, c = i % E;
      qbd[h * L.qbd_ld() + c] =
          c / Dh == h ? q[((size_t)b * H + h) * Dh + c % Dh] : __float2bfloat16(0.0f);
    }

    // logits (H, T) = qbd (H, E) @ K2 (E, T): warp w owns key tiles w + 8j
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < E; kk += 16) {
      for (int v = tid; v < 16 * T / 8; v += THREADS) {
        const int rr = v / (T / 8), c = (v % (T / 8)) * 8;
        *reinterpret_cast<uint4*>(kst + rr * L.ks_ld() + c) =
            load8(k2 + (size_t)(kk + rr) * T + c);
      }
      __syncthreads();  // also publishes qbd on the first step
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, qbd + kk, L.qbd_ld());
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, kst + (warp + WARPS * j) * 16, L.ks_ld());
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wmma::store_matrix_sync(lg + (warp + WARPS * j) * 16, acc[j], L.lg_ld(),
                              wmma::mem_row_major);
    __syncthreads();

    // softmax over T in fp32, two heads per warp: (logit * scale) [* ks]
    // [+ bias], exp(. - max) / sum [* vs], rounded to bf16
    for (int h = warp; h < H; h += WARPS) {
      float* row = lg + h * L.lg_ld();
      const size_t sc = ((size_t)b * H + h) * T;
      float mx = -FLT_MAX;
      for (int t = lane; t < T; t += 32) {
        float l = row[t] * scale;
        if (ks != nullptr) l = l * ks[sc + t];
        if (bias != nullptr) l = l + bias[(size_t)b * T + t];
        row[t] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float p = expf(row[t] - mx);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int t = lane; t < T; t += 32) {
        float p = row[t] / sum;
        if (vs != nullptr) p = p * vs[sc + t];
        wb[h * L.w_ld() + t] = __float2bfloat16(p);
      }
    }
    __syncthreads();

    // out: V2 (E, T) @ w^T (T, H) by slabs of 128 E rows x 64 keys; the warp's
    // 16-row tile lies in one head, whose column it keeps
    for (int e0 = 0; e0 < E; e0 += E_SLAB) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.0f);
      for (int t0 = 0; t0 < T; t0 += T_SLAB) {
        for (int v = tid; v < E_SLAB * T_SLAB / 8; v += THREADS) {
          const int rr = v / (T_SLAB / 8), c = (v % (T_SLAB / 8)) * 8;
          *reinterpret_cast<uint4*>(vst + rr * vld + c) =
              load8(v2 + (size_t)(e0 + rr) * T + t0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < T_SLAB; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, vst + warp * 16 * vld + kk, vld);
          wmma::load_matrix_sync(fb, wb + t0 + kk, L.w_ld());
          wmma::mma_sync(o, fa, fb, o);
        }
        __syncthreads();
      }
      float* sc = scratch + warp * 256;
      wmma::store_matrix_sync(sc, o, 16, wmma::mem_row_major);
      __syncwarp();
      const int e = e0 + warp * 16 + lane;
      if (lane < 16) {
        const int h = e / Dh;
        out[((size_t)b * H + h) * Dh + e % Dh] = __float2bfloat16(sc[lane * 16 + h]);
      }
      __syncwarp();
    }
    __syncthreads();  // before the next row overwrites qbd
  }
}

// K18: block = H warps, warp h attends head h of each of the block's bt rows
__global__ void __launch_bounds__(32 * H)
batched_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kT,
               const __nv_bfloat16* __restrict__ vT,
               const float* __restrict__ bias, int bt, int Dh, int T,
               float scale, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float sm[];
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qs = sm + h * Dh;             // [H][Dh]
  float* w = sm + H * Dh + h * T;      // [H][T]
  for (int r = 0; r < bt; ++r) {
    const int b = blockIdx.x * bt + r;
    const size_t row = (size_t)b * H + h;
    const __nv_bfloat16* kp = kT + row * Dh * T;
    const __nv_bfloat16* vp = vT + row * Dh * T;
    for (int d = lane; d < Dh; d += 32) qs[d] = __bfloat162float(q[row * Dh + d]);
    __syncwarp();
    float mx = -FLT_MAX;
    for (int t = lane; t < T; t += 32) {
      float s = 0.0f;
      for (int d = 0; d < Dh; ++d) s += qs[d] * __bfloat162float(kp[(size_t)d * T + t]);
      s = s * scale;
      if (bias != nullptr) s = s + bias[(size_t)b * T + t];
      w[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float p = expf(w[t] - mx);
      w[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32)
      w[t] = __bfloat162float(__float2bfloat16(w[t] / sum));
    __syncwarp();
    for (int d = 0; d < Dh; ++d) {
      const __nv_bfloat16* vr = vp + (size_t)d * T;
      float acc = 0.0f;
      for (int t = lane; t < T; t += 32) acc += w[t] * __bfloat162float(vr[t]);
      acc = warp_sum(acc);
      if (lane == 0) out[row * Dh + d] = __float2bfloat16(acc);
    }
    __syncwarp();  // before the next row overwrites qs and w
  }
}

template <typename F>
int set_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

template <typename TK, int NJ>
int launch_blockdiag(const void* q, const void* kT, const void* vT,
                     const void* bias, const void* ks, const void* vs, int B,
                     int bt, int Dh, int T, float scale, void* out,
                     cudaStream_t s) {
  const size_t bytes = Smem{H * Dh, T}.bytes();
  auto kernel = blockdiag_kernel<TK, NJ>;
  const int e = set_smem(kernel, bytes);
  if (e != 0) return e;
  kernel<<<B / bt, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TK*>(kT),
      static_cast<const TK*>(vT), static_cast<const float*>(bias),
      static_cast<const float*>(ks), static_cast<const float*>(vs), bt, Dh, T,
      scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

template <typename TK>
int dispatch_blockdiag(const void* q, const void* kT, const void* vT,
                       const void* bias, const void* ks, const void* vs, int B,
                       int bt, int Dh, int T, float scale, void* out,
                       cudaStream_t s) {
  switch (T / (16 * WARPS)) {
    case 1: return launch_blockdiag<TK, 1>(q, kT, vT, bias, ks, vs, B, bt, Dh, T, scale, out, s);
    case 2: return launch_blockdiag<TK, 2>(q, kT, vT, bias, ks, vs, B, bt, Dh, T, scale, out, s);
    case 4: return launch_blockdiag<TK, 4>(q, kT, vT, bias, ks, vs, B, bt, Dh, T, scale, out, s);
    case 8: return launch_blockdiag<TK, 8>(q, kT, vT, bias, ks, vs, B, bt, Dh, T, scale, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// K17's cluster kernel
// ---------------------------------------------------------------------------

namespace bd {

constexpr int H = 16;                   // heads: the M of the logits product
constexpr int CONSUMERS = 4;            // warps: 16 keys of a 64-key column each
constexpr int PRODUCER = CONSUMERS;     // the warp whose lane 0 issues the loads
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int KEYS = 64;                // keys a TMA box
constexpr int UNIT = 16;                // keys: ranges are whole units
constexpr int STAGE_BYTES = 16 * 1024;  // a box
constexpr int MAX_STAGES = 6;
constexpr int NSET = 4;  // independent accumulator sets of the logits' k-steps
// room for the kernel's static shared memory (barriers, the per-head
// vectors and the peers' statistics, 1.4 KB) beside the dynamic
constexpr int STATIC = 2048;
constexpr int SMEM_LIMIT = 227 * 1024;

template <bool INT8>
struct Form {
  static constexpr int ROWS = INT8 ? 256 : 128;        // rows of K2 / V2 a box
  static constexpr int SLABS = ROWS / 16 / CONSUMERS;  // V m16 slabs a warp a box
};

// Dynamic shared memory, byte offsets from its first 1024-byte boundary:
// the ring, the logits (fp32, 16 x the block's key columns), the weights
// (bf16), the row's q (16 x Dh bf16), the partial output (16 x Dh fp32),
// the peers' partials of this block's share of it (16 x Dh fp32 + 128) and,
// where they fit (`side`), the bias of the block's keys and, int8, their
// k / v scales (16 x keys each).
struct Layout {
  int stages, cols, dh;
  bool int8, side;
  __host__ __device__ int lg_ld() const { return cols * KEYS + 4; }
  __host__ __device__ int w_ld() const { return cols * KEYS + 8; }
  __host__ __device__ int logits() const { return stages * STAGE_BYTES; }
  __host__ __device__ int weights() const { return logits() + H * lg_ld() * 4; }
  __host__ __device__ int q() const { return weights() + H * w_ld() * 2; }
  __host__ __device__ int part() const { return q() + H * dh * 2; }
  __host__ __device__ int recv() const { return part() + H * dh * 4; }
  __host__ __device__ int bias() const { return recv() + H * dh * 4 + 128; }
  __host__ __device__ int scales() const { return bias() + cols * KEYS * 4; }
  __host__ __device__ int bytes() const {
    return side ? scales() + (int8 ? 2 * H * cols * KEYS * 4 : 0) + 1024
                : bias() + 1024;
  }
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// Two floats as a bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// A float / four floats into block `rank`'s shared memory at this block's
// address `p`, counted on block `rank`'s mbarrier at this block's `bar`
// (st.async: the receiver waits on its own barrier for the bytes, no
// cluster barrier).
__device__ __forceinline__ void st_peer(const float* p, int rank, float v,
                                        const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(sm90::peer_addr(p, rank)),
      "f"(v), "r"(sm90::peer_addr(bar, rank))
      : "memory");
}
__device__ __forceinline__ void st_peer4(const float* p, int rank, float4 v,
                                         const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(sm90::peer_addr(p, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(sm90::peer_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte offsets of 16-byte chunk `c` of row `row` of a box: bf16 rows of 128
// bytes under the 128-byte swizzle, int8 rows of 64 bytes under the 64-byte
// swizzle (the tile base 1024-byte aligned).
__device__ __forceinline__ int at128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}
__device__ __forceinline__ int at64(int row, int c) {
  return row * 64 + ((c ^ ((row >> 1) & 3)) << 4);
}

// The logits' B fragments of k-step kk for the warp's 16 keys: two n8 tiles
// (r[0], r[1]) and (r[2], r[3]). bf16: key n of tile j is warp * 16 + 8 j +
// n, by ldmatrix.trans (the box's rows are the k index).
__device__ __forceinline__ void k_frags(uint32_t tile, const unsigned char*,
                                        int kk, int warp, int lane,
                                        uint32_t (&r)[4],
                                        const __nv_bfloat16*) {
  const int m = lane / 8;
  const int row = kk * 16 + (m & 1) * 8 + lane % 8;
  ldsm_x4_trans(tile + at128(row, warp * 2 + (m >> 1)), r);
}

// int8: key n of tile j is warp * 16 + 2 n + j, so a thread reads one word
// (four keys) of each of its four k rows and keeps two bytes of each.
__device__ __forceinline__ void k_frags(uint32_t, const unsigned char* tile,
                                        int kk, int warp, int lane,
                                        uint32_t (&r)[4], const int8_t*) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = kk * 16 + 2 * t, word = (g >> 1) << 2;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + (i & 1) + (i >> 1) * 8;  // k rows 2t, 2t + 1, + 8
    w[i] = lds32(tile + at64(row, warp) + word) ^ 0x80808080u;
  }
  const int sel = 2 * (g & 1);
  r[0] = bf2(sm90::i8_lane(w[0], sel), sm90::i8_lane(w[1], sel));
  r[1] = bf2(sm90::i8_lane(w[2], sel), sm90::i8_lane(w[3], sel));
  r[2] = bf2(sm90::i8_lane(w[0], sel + 1), sm90::i8_lane(w[1], sel + 1));
  r[3] = bf2(sm90::i8_lane(w[2], sel + 1), sm90::i8_lane(w[3], sel + 1));
}

// The keys of accumulator columns 2t and 2t + 1 of the warp's tile j.
__device__ __forceinline__ int2 k_cols(int warp, int t, int j, bool int8) {
  return int8 ? make_int2(warp * 16 + 4 * t + j, warp * 16 + 4 * t + 2 + j)
              : make_int2(warp * 16 + 8 * j + 2 * t, warp * 16 + 8 * j + 2 * t + 1);
}

// The V product's A fragment of m16 slab `ms`, k-step kk: bf16 by ldmatrix
// (keys in order), B from the weights: the pair at key0 + 2t, + 8.
__device__ __forceinline__ void v_frags(uint32_t tile, const unsigned char*,
                                        int ms, int kk, int lane,
                                        uint32_t (&a)[4],
                                        const __nv_bfloat16* wrow, int key0,
                                        uint32_t& b0, uint32_t& b1,
                                        const __nv_bfloat16*) {
  const int m = lane / 8, t = lane % 4;
  const int row = ms * 16 + (m & 1) * 8 + lane % 8;
  ldsm_x4(tile + at128(row, kk * 2 + (m >> 1)), a);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wrow + key0);
  b0 = w32[t];
  b1 = w32[t + 4];
}

// int8: the k-slots 2t, 2t + 1, 2t + 8, 2t + 9 take keys 4t .. 4t + 3, one
// word of each of the thread's two rows; the weights in the same order.
__device__ __forceinline__ void v_frags(uint32_t, const unsigned char* tile,
                                        int ms, int kk, int lane,
                                        uint32_t (&a)[4],
                                        const __nv_bfloat16* wrow, int key0,
                                        uint32_t& b0, uint32_t& b1,
                                        const int8_t*) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = ms * 16 + g;
  const uint32_t w0 = lds32(tile + at64(r0, kk) + 4 * t) ^ 0x80808080u;
  const uint32_t w1 = lds32(tile + at64(r0 + 8, kk) + 4 * t) ^ 0x80808080u;
  a[0] = bf2(sm90::i8_lane(w0, 0), sm90::i8_lane(w0, 1));
  a[1] = bf2(sm90::i8_lane(w1, 0), sm90::i8_lane(w1, 1));
  a[2] = bf2(sm90::i8_lane(w0, 2), sm90::i8_lane(w0, 3));
  a[3] = bf2(sm90::i8_lane(w1, 2), sm90::i8_lane(w1, 3));
  const uint2 wv = *reinterpret_cast<const uint2*>(wrow + key0 + 4 * t);
  b0 = wv.x;
  b1 = wv.y;
}

// Grid (split, B), clusters of `split` along x (split 1: an ordinary
// launch); `cols` key columns of 64 in the largest range, `stages` boxes in
// the ring. tk / tv: the (B*H*Dh, T) maps of kT / vT.
template <typename TK>
__global__ void __launch_bounds__(THREADS)
    blockdiag_cluster(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __nv_bfloat16* __restrict__ q,
                      const float* __restrict__ bias,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs, int Dh, int T, int cols,
                      int stages, int side, float scale,
                      __nv_bfloat16* __restrict__ out) {
  constexpr bool INT8 = std::is_same<TK, int8_t>::value;
  using F = Form<INT8>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t aux;  // the bias and scales' copies
  // the exchanges' arrivals: the peers' maxima, their sums, their partials
  __shared__ __align__(8) uint64_t xbar[3];
  __shared__ float mx_s[H], den_s[H], gm[H], gd[H];
  __shared__ float mx_all[sm90::MAX_CLUSTER][H], den_all[sm90::MAX_CLUSTER][H];

  const Layout L{stages, cols, Dh, INT8, side != 0};
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  float* logits = reinterpret_cast<float*>(base_p + L.logits());
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(base_p + L.weights());
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base_p + L.q());
  float* part = reinterpret_cast<float*>(base_p + L.part());
  float4* recv = reinterpret_cast<float4*>(base_p + L.recv());
  float* bias_s = reinterpret_cast<float*>(base_p + L.bias());
  float* ks_s = reinterpret_cast<float*>(base_p + L.scales());
  float* vs_s = ks_s + H * cols * KEYS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int split = (int)gridDim.x;
  const int rank = split > 1 ? sm90::cluster_rank() : 0;
  const int E = H * Dh;
  // block r's keys [lo, hi): units r U / split .. (r + 1) U / split
  const int units = T / UNIT;
  const int lo = (int)((long long)rank * units / split) * UNIT;
  const int hi = (int)((long long)(rank + 1) * units / split) * UNIT;
  const int nk = hi - lo;
  const int ncols = (nk + KEYS - 1) / KEYS;
  const int nslab = E / F::ROWS;
  const int nK = ncols * nslab;  // K boxes: column by column; then V boxes
  const int loads = 2 * nK;
  const int lg_ld = L.lg_ld(), w_ld = L.w_ld();
  const int row0 = b * E;
  const CUtensorMap* tkp = &tk;
  const CUtensorMap* tvp = &tv;
  // the partials' ownership: block r owns float4s [r n4 / split, (r + 1) n4
  // / split) of the row's E outputs
  const int n4 = E / 4;
  const int per = (n4 + split - 1) / split;
  const int i0 = (int)((long long)rank * n4 / split);
  const int i1 = (int)((long long)(rank + 1) * n4 / split);

  // load j into its slot once the consumers have released the slot
  auto issue = [&](int j) {
    const int s = j % stages;
    sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((j / stages) & 1) ^ 1);
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, STAGE_BYTES);
    const bool is_k = j < nK;
    const int c = is_k ? j / nslab : (j - nK) % ncols;
    const int r = is_k ? j % nslab : (j - nK) / ncols;
    sm90::tma_load(base + s * STAGE_BYTES, is_k ? tkp : tvp, bar,
                   lo + c * KEYS, row0 + r * F::ROWS);
  };
  // `all` = the per-head values `mine` of the cluster's blocks combined in
  // rank order (max or sum), the same in every block: each block pushes its
  // values into every block's `slots`, and waits on its barrier `k` for the
  // split x 16 values pushed into its own
  auto exchange = [&](const float* mine, float (*slots)[H], float* all,
                      bool is_max, int k) {
    __syncthreads();
    if (split > 1) {
      if (tid < H * split)
        st_peer(&slots[rank][tid % H], tid / H, mine[tid % H], &xbar[k]);
      if (tid < H) sm90::mbar_wait(sm90::smem_u32(&xbar[k]), 0);
    }
    if (tid < H) {
      float v = mine[tid];
      if (split > 1) {
        v = slots[0][tid];
        for (int r = 1; r < split; ++r)
          v = is_max ? fmaxf(v, slots[r][tid]) : v + slots[r][tid];
      }
      all[tid] = v;
    }
    __syncthreads();
  };

  // the producer starts the loads first: the barriers, the first boxes, the
  // bias and scales of the block's keys (bulk copies), then the rest of the
  // K boxes and the first V boxes as slots free; the consumers meanwhile
  // stage the row's q and wait only for the barriers' initialisation
  const int side_bytes =
      side ? (bias != nullptr ? nk * 4 : 0) + (INT8 ? 2 * H * nk * 4 : 0) : 0;
  if (warp == PRODUCER) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tkp))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tvp))
                   : "memory");
      for (int s = 0; s < stages; ++s) {
        sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
        sm90::mbar_init(sm90::smem_u32(&empty[s]), CONSUMERS);
      }
      sm90::mbar_init(sm90::smem_u32(&aux), 1);
      for (int k = 0; k < 3; ++k) {  // each expects its bytes once
        sm90::mbar_init(sm90::smem_u32(&xbar[k]), 1);
        sm90::mbar_expect_tx(sm90::smem_u32(&xbar[k]),
                             k < 2 ? split * H * 4 : split * (i1 - i0) * 16);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    if (split > 1)  // this block's barriers are initialised (waited before
                    // the first exchange)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("bar.arrive 1, %0;" ::"n"(THREADS) : "memory");
    if (lane == 0) {
      for (int j = 0; j < min(stages, nK); ++j) issue(j);
      if (side_bytes > 0) {
        const uint32_t abar = sm90::smem_u32(&aux);
        sm90::mbar_expect_tx(abar, side_bytes);
        if (bias != nullptr)
          sm90::bulk_load(sm90::smem_u32(bias_s), bias + (size_t)b * T + lo,
                          nk * 4, abar);
        if (INT8)
          for (int h = 0; h < H; ++h) {
            const size_t at = ((size_t)b * H + h) * T + lo;
            sm90::bulk_load(sm90::smem_u32(ks_s + h * cols * KEYS), ks + at,
                            nk * 4, abar);
            sm90::bulk_load(sm90::smem_u32(vs_s + h * cols * KEYS), vs + at,
                            nk * 4, abar);
          }
      }
      for (int j = min(stages, nK); j < nK; ++j) issue(j);
      if (!side) {  // read where they are: into L2 meanwhile
        if (bias != nullptr) prefetch_l2(bias + (size_t)b * T + lo, nk * 4);
        if (INT8)
          for (int h = 0; h < H; ++h) {
            prefetch_l2(ks + ((size_t)b * H + h) * T + lo, nk * 4);
            prefetch_l2(vs + ((size_t)b * H + h) * T + lo, nk * 4);
          }
      }
      // the first V boxes, into slots the K pass frees: no wait on the
      // softmax
      for (int j = nK; j < min(loads, nK + stages); ++j) issue(j);
    }
    __syncwarp();
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(q + (size_t)row0);
    uint4* dst = reinterpret_cast<uint4*>(q_s);
    for (int i = tid; i < E / 8; i += CONSUMERS * 32) dst[i] = src[i];
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
    if (split > 1)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

    // ---- logits (16 heads x the block's keys) = qbd (16, E) @ K2 (E, keys)
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q_s);
    for (int c = 0; c < ncols; ++c) {
      // NSET sets take the k-steps in turn: NSET independent mma chains
      float acc[NSET][2][4] = {};
      const bool live = c * KEYS + warp * 16 < nk;
      for (int r = 0; r < nslab; ++r) {
        const int j = c * nslab + r, s = j % stages;
        sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
        if (live) {
          const uint32_t tile = base + s * STAGE_BYTES;
          const unsigned char* tile_p = base_p + s * STAGE_BYTES;
          int h = r * F::ROWS / Dh, d = r * F::ROWS - h * Dh;
#pragma unroll
          for (int kk = 0; kk < F::ROWS / 16; ++kk) {
            // the block-diagonal A: row h holds q[h, d .. d + 16), the
            // other rows zeros
            const uint32_t w0 = qw[(h * Dh + d) / 2 + t];
            const uint32_t w1 = qw[(h * Dh + d) / 2 + t + 4];
            const uint32_t a[4] = {g == h ? w0 : 0u, g + 8 == h ? w0 : 0u,
                                   g == h ? w1 : 0u, g + 8 == h ? w1 : 0u};
            uint32_t bf[4];
            k_frags(tile, tile_p, kk, warp, lane, bf, (const TK*)nullptr);
            mma16816(acc[kk % NSET][0], a, bf[0], bf[1]);
            mma16816(acc[kk % NSET][1], a, bf[2], bf[3]);
            d += 16;
            if (d == Dh) {
              d = 0;
              ++h;
            }
          }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
      }
      if (live) {  // the sets in order
        float* lc = logits + c * KEYS;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            v[x] = acc[0][j][x];
#pragma unroll
            for (int m = 1; m < NSET; ++m) v[x] += acc[m][j][x];
          }
          const int2 k = k_cols(warp, t, j, INT8);
          lc[g * lg_ld + k.x] = v[0];
          lc[g * lg_ld + k.y] = v[1];
          lc[(g + 8) * lg_ld + k.x] = v[2];
          lc[(g + 8) * lg_ld + k.y] = v[3];
        }
      }
    }
  }
  __syncthreads();

  // ---- the softmax in fp32, as the twin rounds it; four heads a warp
  constexpr int HW = H / CONSUMERS;
  if (warp != PRODUCER) {  // l = ((sum * scale) [* ks]) [+ bias], the max
    if (side_bytes > 0) sm90::mbar_wait(sm90::smem_u32(&aux), 0);
    for (int hh = 0; hh < HW; ++hh) {
      const int h = warp * HW + hh;
      float4* row = reinterpret_cast<float4*>(logits + h * lg_ld);
      const float4* k4 = reinterpret_cast<const float4*>(
          side ? ks_s + h * cols * KEYS
               : INT8 ? ks + ((size_t)b * H + h) * T + lo : nullptr);
      const float4* b4 = reinterpret_cast<const float4*>(
          bias == nullptr ? nullptr : side ? bias_s : bias + (size_t)b * T + lo);
      float mx = -FLT_MAX;
      for (int i = lane; i < nk / 4; i += 32) {
        float4 l = row[i];
        l.x = __fmul_rn(l.x, scale);
        l.y = __fmul_rn(l.y, scale);
        l.z = __fmul_rn(l.z, scale);
        l.w = __fmul_rn(l.w, scale);
        if (INT8) {
          const float4 s4 = k4[i];
          l.x = __fmul_rn(l.x, s4.x);
          l.y = __fmul_rn(l.y, s4.y);
          l.z = __fmul_rn(l.z, s4.z);
          l.w = __fmul_rn(l.w, s4.w);
        }
        if (b4 != nullptr) {
          const float4 a4 = b4[i];
          l.x = __fadd_rn(l.x, a4.x);
          l.y = __fadd_rn(l.y, a4.y);
          l.z = __fadd_rn(l.z, a4.z);
          l.w = __fadd_rn(l.w, a4.w);
        }
        row[i] = l;
        mx = fmaxf(mx, fmaxf(fmaxf(l.x, l.y), fmaxf(l.z, l.w)));
      }
      mx = warp_max(mx);
      if (lane == 0) mx_s[h] = mx;
    }
  }
  // every block's exchange barriers are initialised before any is pushed to
  if (split > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  exchange(mx_s, mx_all, gm, true, 0);

  if (warp != PRODUCER) {  // p = exp(l - m), the partial sums
    for (int hh = 0; hh < HW; ++hh) {
      const int h = warp * HW + hh;
      const float m = gm[h];
      float4* row = reinterpret_cast<float4*>(logits + h * lg_ld);
      float sum = 0.0f;
      for (int i = lane; i < nk / 4; i += 32) {
        float4 p = row[i];
        p.x = expf(p.x - m);
        p.y = expf(p.y - m);
        p.z = expf(p.z - m);
        p.w = expf(p.w - m);
        row[i] = p;
        sum += p.x;
        sum += p.y;
        sum += p.z;
        sum += p.w;
      }
      sum = warp_sum(sum);
      if (lane == 0) den_s[h] = sum;
    }
  }
  exchange(den_s, den_all, gd, false, 1);

  if (warp != PRODUCER) {  // w = bf16((p / sum) [* vs])
    for (int hh = 0; hh < HW; ++hh) {
      const int h = warp * HW + hh;
      const float dn = gd[h];
      const float4* row = reinterpret_cast<const float4*>(logits + h * lg_ld);
      const float4* v4 = reinterpret_cast<const float4*>(
          side ? vs_s + h * cols * KEYS
               : INT8 ? vs + ((size_t)b * H + h) * T + lo : nullptr);
      uint2* wr = reinterpret_cast<uint2*>(wts + h * w_ld);
      for (int i = lane; i < nk / 4; i += 32) {
        float4 p = row[i];
        p.x = __fdiv_rn(p.x, dn);
        p.y = __fdiv_rn(p.y, dn);
        p.z = __fdiv_rn(p.z, dn);
        p.w = __fdiv_rn(p.w, dn);
        if (INT8) {
          const float4 s4 = v4[i];
          p.x = __fmul_rn(p.x, s4.x);
          p.y = __fmul_rn(p.y, s4.y);
          p.z = __fmul_rn(p.z, s4.z);
          p.w = __fmul_rn(p.w, s4.w);
        }
        wr[i] = make_uint2(bf2(p.x, p.y), bf2(p.z, p.w));
      }
    }
  }
  __syncthreads();

  // ---- out partial (E) = V2 (E, keys) @ w^T (keys, 16): slab by slab, each
  // m16 slab of V2 in one head, only the n8 tile holding it
  if (warp == PRODUCER) {
    if (lane == 0)
      for (int j = nK + stages; j < loads; ++j) issue(j);
    __syncwarp();
  } else {
    for (int r = 0; r < nslab; ++r) {
      float acc[F::SLABS][2][4] = {};  // two sets: even and odd k-steps
      for (int c = 0; c < ncols; ++c) {
        const int j = nK + r * ncols + c, s = j % stages;
        sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
        const uint32_t tile = base + s * STAGE_BYTES;
        const unsigned char* tile_p = base_p + s * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < F::SLABS; ++i) {
          const int ms = warp * F::SLABS + i;
          const int h = (r * F::ROWS + ms * 16) / Dh;
          const __nv_bfloat16* wrow = wts + ((h & 8) + g) * w_ld;
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk) {
            const int key0 = c * KEYS + kk * 16;
            if (key0 < nk) {
              uint32_t a[4], b0, b1;
              v_frags(tile, tile_p, ms, kk, lane, a, wrow, key0, b0, b1,
                      (const TK*)nullptr);
              mma16816(acc[i][kk & 1], a, b0, b1);
            }
          }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
      }
#pragma unroll
      for (int i = 0; i < F::SLABS; ++i) {  // the column of the slab's head
        const int e0 = r * F::ROWS + (warp * F::SLABS + i) * 16;
        const int col = (e0 / Dh) & 7;
        if ((col >> 1) == t) {  // the sets in order; no dynamic index
          const float(&s0)[4] = acc[i][0];
          const float(&s1)[4] = acc[i][1];
          part[e0 + g] = (col & 1) ? s0[1] + s1[1] : s0[0] + s1[0];
          part[e0 + g + 8] = (col & 1) ? s0[3] + s1[3] : s0[2] + s1[2];
        }
      }
    }
  }
  __syncthreads();

  // ---- the partials in rank order: every block pushes its partial of the
  // owner's float4s into the owner's `recv` (the slot of its rank); the
  // owner waits for them on its barrier, sums them in rank order and
  // rounds each to bf16 once. A block leaves once its own outputs are
  // written: nothing of its shared memory is read by another.
  const float4* part4 = reinterpret_cast<const float4*>(part);
  if (split > 1) {
    for (int i = tid; i < n4; i += THREADS) {
      const int o = ((i + 1) * split - 1) / n4;  // the owner of float4 i
      const int io = (int)((long long)o * n4 / split);
      st_peer4(reinterpret_cast<const float*>(recv + rank * per + i - io), o,
               part4[i], &xbar[2]);
    }
    sm90::mbar_wait(sm90::smem_u32(&xbar[2]), 0);
  }
  for (int i = i0 + tid; i < i1; i += THREADS) {
    float4 o = split > 1 ? recv[i - i0] : part4[i];
    for (int r = 1; r < split; ++r) o = add4(o, recv[r * per + i - i0]);
    *reinterpret_cast<uint2*>(out + (size_t)row0 + 4 * i) =
        make_uint2(bf2(o.x, o.y), bf2(o.z, o.w));
  }
}

// The dynamic shared memory the kernel may launch with, raised to `smem`.
template <typename TK>
int opt_in(int smem) {
  static int opted = 48 * 1024;
  if (smem <= opted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      blockdiag_cluster<TK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  opted = smem;
  return 0;
}

// The clusters of `split` blocks of `smem` bytes the card holds at once
// (cudaOccupancyMaxActiveClusters, remembered by (split, smem)); -error.
template <typename TK>
int max_clusters(int split, int smem) {
  static int seen[64][3];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (seen[i][0] == split && seen[i][1] == smem) return seen[i][2];
  const int err = opt_in<TK>(smem);
  if (err != 0) return -err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int c = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&c, blockdiag_cluster<TK>, &cfg);
  if (e != cudaSuccess) return -(int)e;
  if (n < 64) {
    seen[n][0] = split;
    seen[n][1] = smem;
    seen[n][2] = c;
    ++n;
  }
  return c;
}

template <typename TK>
int launch(const void* q, const void* kT, const void* vT, const void* bias,
           const void* ks, const void* vs, int B, int Dh, int T, float scale,
           int chunk, int split, void* out, cudaStream_t s) {
  constexpr bool INT8 = std::is_same<TK, int8_t>::value;
  using F = Form<INT8>;
  const int units = T / UNIT;
  if (split < 1 || split > sm90::MAX_CLUSTER || split > units ||
      chunk % UNIT != 0 || chunk > T ||
      chunk < (units + split - 1) / split * UNIT)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Dh;
  const CUtensorMapSwizzle sw =
      INT8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapDataType type = INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tk = {}, tv = {};
  int rc = sm90::encode_map(&tk, kT, rows, T, T, F::ROWS, KEYS, sw, type,
                            (int)sizeof(TK));
  if (rc == 0)
    rc = sm90::encode_map(&tv, vT, rows, T, T, F::ROWS, KEYS, sw, type,
                          (int)sizeof(TK));
  if (rc != 0) return rc;
  const int cols = (chunk + KEYS - 1) / KEYS;
  const int loads = 2 * cols * (int)(H * Dh / F::ROWS);
  // the bias and scales copied into shared memory where two stages leave
  // room for them
  const bool side =
      Layout{2, cols, Dh, INT8, true}.bytes() + STATIC <= SMEM_LIMIT;
  int stages =
      sm90::ring_stages((long long)B * split, Layout{0, cols, Dh, INT8, side}.bytes() +
                                                  STATIC,
                        STAGE_BYTES, MAX_STAGES, loads);
  // a cluster launch: the deepest ring at which all B clusters are on the
  // card at once (a cluster's blocks need room on neighbouring SMs, so two
  // blocks an SM can still leave clusters for a second wave)
  for (int st = split > 1 ? MAX_STAGES : 0; st >= 2; --st) {
    const int c =
        max_clusters<TK>(split, Layout{st, cols, Dh, INT8, side}.bytes());
    if (c < 0) return -c;
    if (c >= B) {
      stages = st;
      break;
    }
  }
  const int smem = Layout{stages, cols, Dh, INT8, side}.bytes();
  if (smem + STATIC > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const auto kernel = blockdiag_cluster<TK>;
  const int err = opt_in<TK>(smem);
  if (err != 0) return err;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* bp = static_cast<const float*>(bias);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (split == 1) {
    kernel<<<dim3(1, B), THREADS, smem, s>>>(tk, tv, qp, bp, ksp, vsp, Dh, T,
                                             cols, stages, (int)side, scale,
                                             op);
    return (int)cudaGetLastError();
  }
  return sm90::launch_cluster(kernel, dim3(split, B), THREADS, (size_t)smem,
                              split, s, tk, tv, qp, bp, ksp, vsp, Dh, T, cols,
                              stages, (int)side, scale, op);
}

}  // namespace bd

// q (B, 16, Dh) bf16; kT / vT (B, 16, Dh, T) bf16 (int8 = 0) or int8
// (int8 = 1, with ks / vs (B, 16, T) fp32); bias (B, T) fp32 or null; out
// (B, 16, Dh) bf16. bt | B, Dh % 16 == 0, T in {128, 256, 512, 1024}.
extern "C" int acai_blockdiag_decode_attention(
    const void* q, const void* kT, const void* vT, const void* bias,
    const void* ks, const void* vs, int int8, int B, int bt, int Dh, int T,
    float scale, void* out, void* stream) {
  if (bt <= 0 || B % bt || Dh % 16 || T % (16 * WARPS) || (int8 && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? dispatch_blockdiag<int8_t>(q, kT, vT, bias, ks, vs, B, bt, Dh, T, scale, out, s)
              : dispatch_blockdiag<__nv_bfloat16>(q, kT, vT, bias, nullptr, nullptr, B, bt, Dh,
                                                  T, scale, out, s);
}

// K17's cluster kernel: the same arguments without bt; `chunk` (keys of a
// block's largest range, a multiple of 16) and `split` (1-8) as
// ops/probe_kernels.py `blockdiag_plan` gives them. T % 64 == 0; q, kT, vT,
// the scales, the bias and out 16-byte aligned.
extern "C" int acai_blockdiag_decode_attention_cluster(
    const void* q, const void* kT, const void* vT, const void* bias,
    const void* ks, const void* vs, int int8, int B, int Dh, int T,
    float scale, int chunk, int split, void* out, void* stream) {
  const void* ptrs[] = {q, kT, vT, bias, ks, vs, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  if (B <= 0 || Dh <= 0 || Dh % 16 || T <= 0 || T % bd::KEYS ||
      (int8 && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? bd::launch<int8_t>(q, kT, vT, bias, ks, vs, B, Dh, T, scale,
                                   chunk, split, out, s)
              : bd::launch<__nv_bfloat16>(q, kT, vT, bias, nullptr, nullptr, B,
                                          Dh, T, scale, chunk, split, out, s);
}

// q (B, 16, Dh) bf16; kT / vT (B, 16, Dh, T) bf16; bias (B, T) fp32 or null;
// out (B, 16, Dh) bf16. bt | B.
extern "C" int acai_batched_decode_attention(const void* q, const void* kT,
                                             const void* vT, const void* bias,
                                             int B, int bt, int Dh, int T,
                                             float scale, void* out,
                                             void* stream) {
  if (bt <= 0 || B % bt) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)H * (Dh + T) * sizeof(float);
  const int e = set_smem(batched_kernel, bytes);
  if (e != 0) return e;
  batched_kernel<<<B / bt, 32 * H, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(vT), static_cast<const float*>(bias),
      bt, Dh, T, scale, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The resource rows of K17's cluster kernels (csrc/func_attrs.cuh), at the
// microbench's launch: Dh = 64, 64 keys a block, three stages (the ring at
// which its 32 clusters of 8 are on an H100 at once).
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("blockdiag_decode_attention", "bf16",
                bd::blockdiag_cluster<__nv_bfloat16>, bd::THREADS,
                (bd::Layout{3, 1, 64, false, true}.bytes())),
    ACAI_KERNEL("blockdiag_decode_attention", "int8",
                bd::blockdiag_cluster<int8_t>, bd::THREADS,
                (bd::Layout{3, 1, 64, true, true}.bytes())),
};
ACAI_EXPORT_RESOURCES(kResources)
