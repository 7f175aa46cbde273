// K17 blockdiag_decode_attention and K18 batched_decode_attention: the two
// single-query attention formulations of the JAX package's
// tools/attn_microbench.py, one query per (row, head) against lane-major
// kT / vT (B, H, Dh, T), bias (B, T) fp32, fp32 softmax, bf16 out (B, H, Dh).
//
// K17 replaces `_blockdiag_kernel` (:89, `blockdiag_attn` :129, pallas_call
// :151): `bt` rows per grid step; the 16 heads' queries laid out as a
// block-diagonal (H, H*Dh) operand (15/16 of it zeros) against the row's
// K2 = (H*Dh, T), one matrix-unit product for all heads' logits; fp32 softmax
// (max, exp, sum, divide); for int8 caches the logits times ks and the
// weights times vs (fp32 (B, H, T) scales), the int8 values exact in bf16;
// weights rounded to bf16; then V2 (H*Dh, T) @ w^T (T, H) in full, of which
// only the block-diagonal columns are kept. Hopper asks the same question of
// its tensor cores: `bt` rows per block, the logits one m16 tile (H = 16) by
// T over K = H*Dh on wmma 16x16x16 bf16 fragments, the K2 rows staged 16 at a
// time in shared memory (int8 widened to bf16 there); the softmax in fp32 by
// one warp per two heads; the V product as (128-row E slab) x (64 keys) wmma
// steps against the bf16 weights read as a col-major fragment, and each 16-row
// E tile keeps the column of its head.
//
// K18 replaces `_batcheddot_kernel` (:157, `batcheddot_attn` :176,
// pallas_call :184), bf16 only: one warp per (row, head), the logits as a
// CUDA-core dot along Dh (lanes on neighbouring keys, coalesced along T), the
// weights rounded to bf16, the V sum one warp reduction per head-dim row.
//
// Bound on an H100: the K and V bytes read once (2 * B*H*Dh*T elements, plus
// the fp32 scales for int8) at 3.35 TB/s; a few flops per byte even counting
// the block-diagonal zeros. Both kernels keep the TPU's `bt` rows per block,
// so B / bt blocks stream the whole cache: at B = 32 that is 4-16 of the 132
// SMs, which is the first thing the probe's numbers show.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

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

// shared-memory layout of K17 (bf16 elements unless said), every region
// starting on a 32-byte boundary for the wmma pointers
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
