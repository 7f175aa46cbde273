// K25 head_logits and K26 batched_head_logits: per-head attention logits in
// the forms the JAX package's two Mosaic probes test.
//
// K25 replaces tools/mosaic_head_access_probe.py `main` (kernels k1 :44, k2
// :58, k3 :78; pallas_call :52, :66, :83): S[h] = Q_h K_h^T in fp32 from bf16
// q and k, H heads of Dh = 64, output (H, T, T) fp32. The TPU probe asks
// which in-kernel access of a head Mosaic lowers; here the question is
// whether reading a head's 64 columns straight out of a fused row-major
// (T, E) buffer, as K3 and K7 do, costs anything against a pre-shaped
// (H, T, Dh) copy. One kernel templated on the form:
//   lane_slice (k1): one block per 64-query tile loops over all H heads and
//                    reads each head's Dh columns of row-major (T, E);
//   reshape    (k2): one block per (head, 64-query tile) reads the same
//                    strided columns;
//   preshaped  (k3): one block per (head, 64-query tile) reads contiguous
//                    (H, T, Dh).
// A head's 64 bf16 columns are 128 bytes of a row, so the strided forms read
// whole 128-byte lines too. Bound on an H100: the fp32 output (4 H T^2
// bytes) at 3.35 TB/s; the 2 H T^2 Dh flops are small beside it. Design: four
// warps of 16 query rows, wmma 16x16x16 bf16 tiles with fp32 sums; Q and a
// 64-key K tile in shared memory; each warp stages its 16 x 64 fp32 block
// through shared memory and writes it with 16-byte stores, a row's 256 bytes
// at a time. No pipelining of the tile loads.
//
// K26 replaces tools/mosaic_batched_attn_probe.py `run` (kernels `kern` :86 /
// `kernel` :31, pallas_call :117): batched single-query logits of BT images,
// k (BT, T, E) fp32 or int8, q (BT, E) fp32, H heads of 64:
//   compact[t, b H + h] = k[b, t, head h] . q[b, head h]      (T, BT H) fp32
//   colsum[0, n] = sum_t compact[t, n]                          (1, BT H)
//   col[n, 0] = colsum[0, n]                                    (BT H, 1)
// The TPU kernel builds a block-diagonal (BT T, E) x (BT H, E) product and
// masks it (BT-fold wasted work, which K17 measured at 12-48x the per-head
// form); the contract kept here is the three outputs. int8: q is rounded to
// int8 half to even (jnp.round, then astype), products summed with __dp4a in
// int32 and converted once: exact, |sum| <= 64 * 128 * 128 < 2^24. Column
// sums: one block per (b, h) keeps its T values in shared memory and one warp
// adds them in a fixed order (no float atomics; int32 for int8, converted
// once); the same block writes colsum and its transpose, so they are equal
// bit for bit. Bound: k read once (4 MiB fp32, 1 MiB int8) at 3.35 TB/s;
// with only BT H = 128 blocks of work the kernel is latency-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "func_attrs.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;
constexpr int QT = 64;  // query rows a block
constexpr int KT = 64;  // keys a tile
constexpr int THREADS = 128;
constexpr int H_LD = DH + 8;  // bf16 tiles of Q and K
constexpr int O_LD = KT + 4;  // fp32 staging of a warp's 16 x 64 block
constexpr int LANE_SLICE = 0, RESHAPE = 1, PRESHAPED = 2;

// 64 x 64 bf16 tile, rows `ld` elements apart in global, into shared (H_LD).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int tid) {
#pragma unroll
  for (int v = tid; v < 64 * DH / 8; v += THREADS) {
    const int r = v / (DH / 8);
    const int c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * H_LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// Rows q0..q0+63 of one head's logits: qh / kh point at the head's first
// column of query row q0 / key row 0 (row stride ld); out_h at S[h, q0, 0].
__device__ void head_rows(const __nv_bfloat16* qh, const __nv_bfloat16* kh,
                          int ld, float* out_h, int T, __nv_bfloat16* Qs,
                          __nv_bfloat16* Ks, float* Os) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16;
  __syncthreads();  // the previous head is done with Qs and Ks
  load_tile(Qs, qh, ld, tid);
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();  // every warp is done with the previous K tile
    load_tile(Ks, kh + (size_t)k0 * ld, ld, tid);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KT / 16];
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + row0 * H_LD + kk * 16, H_LD);
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + (j * 16) * H_LD + kk * 16, H_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    float* ow = Os + row0 * O_LD;
#pragma unroll
    for (int j = 0; j < KT / 16; ++j)
      wmma::store_matrix_sync(ow + j * 16, acc[j], O_LD, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (KT / 4); i += 32) {
      const int r = i / (KT / 4);
      const int c = (i % (KT / 4)) * 4;
      *reinterpret_cast<float4*>(out_h + (size_t)(row0 + r) * T + k0 + c) =
          *reinterpret_cast<const float4*>(ow + r * O_LD + c);
    }
    __syncwarp();
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
head_logits_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k, float* __restrict__ out,
                   int T, int H) {
  __shared__ __align__(128) __nv_bfloat16 Qs[QT * H_LD];
  __shared__ __align__(128) __nv_bfloat16 Ks[KT * H_LD];
  __shared__ __align__(128) float Os[QT * O_LD];
  const int q0 = blockIdx.x * QT;
  const int E = H * DH;
  if (FORM == LANE_SLICE) {
    for (int h = 0; h < H; ++h)
      head_rows(q + (size_t)q0 * E + h * DH, k + h * DH, E,
                out + ((size_t)h * T + q0) * T, T, Qs, Ks, Os);
  } else if (FORM == RESHAPE) {
    const int h = blockIdx.y;
    head_rows(q + (size_t)q0 * E + h * DH, k + h * DH, E,
              out + ((size_t)h * T + q0) * T, T, Qs, Ks, Os);
  } else {
    const int h = blockIdx.y;
    head_rows(q + ((size_t)h * T + q0) * DH, k + (size_t)h * T * DH, DH,
              out + ((size_t)h * T + q0) * T, T, Qs, Ks, Os);
  }
}

constexpr int MAX_T = 1024;  // K26 keys a (b, h) pair keeps in shared memory
constexpr int ROW_LANES = 16;  // lanes of one key row: 4 elements each

__device__ __forceinline__ int pack_int8(float4 v) {
  const int a = __float2int_rn(v.x), b = __float2int_rn(v.y);
  const int c = __float2int_rn(v.z), d = __float2int_rn(v.w);
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (d << 24);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
batched_head_logits_kernel(const void* __restrict__ k,
                           const float* __restrict__ q,
                           float* __restrict__ compact,
                           float* __restrict__ colsum, float* __restrict__ col,
                           int T, int H) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  __shared__ Acc vals[MAX_T];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int E = H * DH;
  const int NL = gridDim.y * H;
  const int n = b * H + h;
  const int tid = threadIdx.x;
  const int sub = tid % ROW_LANES;  // 4 columns of the head
  const int grp = tid / ROW_LANES;  // key rows grp, grp + 8, ...
  const float4 qv = *reinterpret_cast<const float4*>(
      q + (size_t)b * E + h * DH + sub * 4);
  const size_t col0 = (size_t)h * DH + sub * 4;
  for (int t = grp; t < T; t += THREADS / ROW_LANES) {
    const size_t at = ((size_t)b * T + t) * E + col0;
    Acc acc;
    if constexpr (INT8) {
      const int kw = *reinterpret_cast<const int*>(
          static_cast<const int8_t*>(k) + at);
      acc = __dp4a(kw, pack_int8(qv), 0);
    } else {
      const float4 kv = *reinterpret_cast<const float4*>(
          static_cast<const float*>(k) + at);
      acc = kv.x * qv.x + kv.y * qv.y + kv.z * qv.z + kv.w * qv.w;
    }
#pragma unroll
    for (int o = ROW_LANES / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o, ROW_LANES);
    if (sub == 0) {
      vals[t] = acc;
      compact[(size_t)t * NL + n] = (float)acc;
    }
  }
  __syncthreads();
  if (tid < 32) {  // fixed order: lane j adds rows j, j + 32, ..., then a tree
    Acc s = 0;
    for (int t = tid; t < T; t += 32) s += vals[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) {
      colsum[n] = (float)s;
      col[n] = (float)s;
    }
  }
}

}  // namespace

// q, k: (T, H * 64) bf16 for form 0 (lane_slice) and 1 (reshape), (H, T, 64)
// for form 2 (preshaped); out: (H, T, T) fp32. T % 64 == 0.
extern "C" int acai_head_logits(const void* q, const void* k, void* out, int T,
                                int H, int form, void* stream) {
  if (T % QT != 0 || T <= 0 || H <= 0 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  float* op = static_cast<float*>(out);
  if (form == LANE_SLICE)
    head_logits_kernel<LANE_SLICE><<<T / QT, THREADS, 0, s>>>(qp, kp, op, T, H);
  else if (form == RESHAPE)
    head_logits_kernel<RESHAPE><<<dim3(T / QT, H), THREADS, 0, s>>>(qp, kp, op,
                                                                    T, H);
  else
    head_logits_kernel<PRESHAPED><<<dim3(T / QT, H), THREADS, 0, s>>>(qp, kp,
                                                                      op, T, H);
  return (int)cudaGetLastError();
}

// k: (BT, T, H * 64) fp32 (int8 == 0) or int8; q: (BT, H * 64) fp32;
// compact: (T, BT * H), colsum: (BT * H,), col: (BT * H,) fp32. T <= 1024.
extern "C" int acai_batched_head_logits(const void* k, const void* q,
                                        void* compact, void* colsum, void* col,
                                        int BT, int T, int H, int int8,
                                        void* stream) {
  if (T <= 0 || T > MAX_T || BT <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, BT);
  const auto* qp = static_cast<const float*>(q);
  auto* cp = static_cast<float*>(compact);
  auto* sp = static_cast<float*>(colsum);
  auto* tp = static_cast<float*>(col);
  if (int8)
    batched_head_logits_kernel<true><<<grid, THREADS, 0, s>>>(k, qp, cp, sp,
                                                              tp, T, H);
  else
    batched_head_logits_kernel<false><<<grid, THREADS, 0, s>>>(k, qp, cp, sp,
                                                               tp, T, H);
  return (int)cudaGetLastError();
}

static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("head_logits", "lane_slice", head_logits_kernel<LANE_SLICE>,
                THREADS, 0),
    ACAI_KERNEL("head_logits", "reshape", head_logits_kernel<RESHAPE>,
                THREADS, 0),
    ACAI_KERNEL("head_logits", "preshaped", head_logits_kernel<PRESHAPED>,
                THREADS, 0),
    ACAI_KERNEL("batched_head_logits", "fp32",
                batched_head_logits_kernel<false>, THREADS, 0),
    ACAI_KERNEL("batched_head_logits", "int8",
                batched_head_logits_kernel<true>, THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
