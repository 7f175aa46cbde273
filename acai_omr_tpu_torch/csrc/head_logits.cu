// K25 head_logits and K26 batched_head_logits: per-head attention logits in
// the forms the JAX package's two Mosaic probes test.
//
// K25 replaces tools/mosaic_head_access_probe.py `main` (kernels k1 :44, k2
// :58, k3 :78; pallas_call :52, :66, :83): S[h] = Q_h K_h^T in fp32 from bf16
// q and k, H heads of Dh = 64, output (H, T, T) fp32. The TPU probe asks
// which in-kernel access of a head Mosaic lowers; here the question is
// whether reading a head's 64 columns straight out of a fused row-major
// (T, E) buffer, as K3 and K7 do, costs anything against a pre-shaped
// (H, T, Dh) copy. Bound on an H100: the fp32 output (4 H T^2 bytes) at
// 3.35 TB/s; the 2 H T^2 Dh flops, a product of depth 64, are small beside
// it. So the kernel is a store stream, and its design
// (`head_logits_persistent`) is the epilogue's:
//
// * One kernel body for the three forms; a form decides only how a head's
//   tile is addressed and the order of the tiles. lane_slice and reshape
//   read q and k through 2-D TMA maps of (T, E) whose 64-column box starts
//   at column h * 64 (128 bytes: the 128-byte swizzle's row), preshaped
//   through maps of (H * T, 64).
// * A tile is 64 queries x 128 keys of one head. One consumer warpgroup runs
//   `wgmma` m64n128k16 with both operands K-major in shared memory (Q_h and
//   K_h are both row-major along Dh, so S = Q K^T needs no transpose), four
//   k-steps, the sums in fp32 registers. A producer warp keeps the next
//   tiles' Q and K boxes in flight through a ring of three stages.
// * The epilogue is the kernel: the accumulators go, 64 keys at a time, to
//   one of two 16 KB staging buffers (128-byte swizzle: the warps' float2
//   writes take two wavefronts, the least), from which two TMA bulk tensor
//   stores of 64 x 32 write them into a (H * T, T) fp32 map. A buffer is
//   written again only once the store before last has read it, so one
//   half's stores overlap the next half's staging and the next tile's loads
//   and product.
// * The blocks are persistent, two an SM (81 KB of shared memory each), and
//   block b walks tiles [b N / G, (b + 1) N / G) of the N = H x T/64 x
//   ceil(T/128) tiles (ops/head_logits_kernels.py `head_logits_schedule`).
//   The forms keep their TPU question as tile order: lane_slice walks the
//   heads innermost (a block covers the heads of the same query and key
//   rows, as k1 loops over heads), reshape and preshaped the heads
//   outermost. No form is limited to T / 64 blocks.
// * T a multiple of 64 but not of 128 (T = 64, 320): the last key tile holds
//   64 keys; its box past T reads zeros (or the next head's rows,
//   preshaped), its second half is neither staged nor stored, and TMA never
//   writes past the map.
// The kernel it replaced (wmma 16x16x16, three barriers a 64-key tile,
// lane_slice on T / 64 blocks) stays as `variant="wmma"`, the yardstick
// timed in turns.
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
#include "sm90_gemm.cuh"

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

namespace hl {  // K25's persistent kernel

constexpr int BQ = 64;                        // queries a tile: a warpgroup
constexpr int BK = 128;                       // keys a tile
constexpr int HALF = 64;                      // keys a staged half
constexpr int OUT_COLS = 32;                  // fp32 columns a store box
constexpr int THREADS = 128 + 32;             // consumers + a producer warp
constexpr int STAGES = 3;
constexpr int Q_BYTES = BQ * DH * 2;          // 8 KB
constexpr int STAGE_BYTES = Q_BYTES + BK * DH * 2;  // + 16 KB
constexpr int BOX_BYTES = BQ * OUT_COLS * 4;  // 8 KB
constexpr int HALF_BYTES = BQ * HALF * 4;     // 16 KB: two store boxes
constexpr int NHALF = 2;                      // staging buffers of a half
constexpr int SMEM = STAGES * STAGE_BYTES + NHALF * HALF_BYTES + 1024;

// Tile i of a launch: its head and query / key tiles. lane_slice: heads
// innermost, then key tiles, then query tiles; reshape and preshaped: heads
// outermost, then query tiles, then key tiles.
__device__ __forceinline__ void tile_of(int i, int form, int H, int nq, int nk,
                                        int& h, int& qt, int& kt) {
  if (form == LANE_SLICE) {
    h = i % H;
    kt = i / H % nk;
    qt = i / H / nk;
  } else {
    kt = i % nk;
    qt = i / nk % nq;
    h = i / nk / nq;
  }
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Grid: G persistent blocks (G <= N tiles); tq / tk: the maps of q and k
// (forms 0, 1: (T, E), boxes of 64 / 128 rows x 64 columns; form 2:
// (H * T, 64)); to: the (H * T, T) fp32 map of the output, boxes of 64 x 32.
template <int FORM>
__global__ void __launch_bounds__(THREADS, 1)
    head_logits_persistent(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap to, int T,
                           int H) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t stage_out = ring + STAGES * STAGE_BYTES;
  unsigned char* out_p = smem_raw + (stage_out - raw);

  const int nq = T / BQ, nk = (T + BK - 1) / BK;
  const long long n_tiles = (long long)H * nq * nk;
  const int G = (int)gridDim.x;
  const int i0 = (int)(blockIdx.x * n_tiles / G);
  const int i1 = (int)((blockIdx.x + 1) * n_tiles / G);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer: Q and K boxes of each tile
    if (threadIdx.x % 32 == 0) {
      for (int i = i0; i < i1; ++i) {
        const int k = i - i0, s = k % STAGES;
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((k / STAGES) & 1) ^ 1);
        int h, qt, kt;
        tile_of(i, FORM, H, nq, nk, h, qt, kt);
        const uint32_t bar = sm90::smem_u32(&full[s]);
        const uint32_t dst = ring + s * STAGE_BYTES;
        sm90::mbar_expect_tx(bar, STAGE_BYTES);
        if (FORM == PRESHAPED) {
          sm90::tma_load(dst, &tq, bar, 0, h * T + qt * BQ);
          sm90::tma_load(dst + Q_BYTES, &tk, bar, 0, h * T + kt * BK);
        } else {
          sm90::tma_load(dst, &tq, bar, h * DH, qt * BQ);
          sm90::tma_load(dst + Q_BYTES, &tk, bar, h * DH, kt * BK);
        }
      }
    }
    return;
  }

  const int lt = threadIdx.x;  // 0..127: the consumer warpgroup
  const int lane = lt % 32;
  const int row = warp * 16 + lane / 4;  // the accumulator's rows row, row + 8
  int halves = 0;  // halves staged so far: the buffer is halves % NHALF
  for (int i = i0; i < i1; ++i) {
    const int k = i - i0, s = k % STAGES;
    int h, qt, kt;
    tile_of(i, FORM, H, nq, nk, h, qt, kt);
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (k / STAGES) & 1);
    const uint32_t qa = ring + s * STAGE_BYTES, ka = qa + Q_BYTES;
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::wgmma_n128<0, 0>(acc, sm90::step_desc<false>(qa, kk),
                             sm90::step_desc<false>(ka, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
    if (lt == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));

    const int k0 = kt * BK;
#pragma unroll
    for (int hf = 0; hf < BK / HALF; ++hf) {
      if (k0 + hf * HALF >= T) break;  // past the last key: nothing to store
      const int buf = halves++ % NHALF;
      // the store that last used this buffer has read it
      if (lt == 0) store_wait_read<NHALF - 1>();
      asm volatile("bar.sync 1, 128;" ::: "memory");
      unsigned char* hb = out_p + buf * HALF_BYTES;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int col = j * 8 + 2 * (lane % 4);  // within the half
        const int c = (col % OUT_COLS) / 4;      // 16-byte chunk of the row
        unsigned char* box = hb + (col / OUT_COLS) * BOX_BYTES + (col % 4) * 4;
        const int jj = hf * (HALF / 8) + j;
        *reinterpret_cast<float2*>(box + row * 128 + ((c ^ (row & 7)) << 4)) =
            make_float2(acc[4 * jj], acc[4 * jj + 1]);
        *reinterpret_cast<float2*>(box + (row + 8) * 128 +
                                   ((c ^ (row & 7)) << 4)) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
      if (lt == 0) {
        const uint32_t src = stage_out + buf * HALF_BYTES;
#pragma unroll
        for (int b = 0; b < HALF / OUT_COLS; ++b)
          tma_store(&to, src + b * BOX_BYTES, k0 + hf * HALF + b * OUT_COLS,
                    h * T + qt * BQ);
        store_commit();
      }
    }
  }
  if (lt == 0) store_wait_all();
}

template <int FORM>
int launch(const void* q, const void* k, void* out, int T, int H, int blocks,
           cudaStream_t s) {
  CUtensorMap tq = {}, tk = {}, to = {};
  const int E = H * DH;
  int rc;
  if (FORM == PRESHAPED) {
    rc = sm90::tensor_map(&tq, q, H * T, DH, BQ);
    if (rc == 0) rc = sm90::tensor_map(&tk, k, H * T, DH, BK);
  } else {
    rc = sm90::tensor_map(&tq, q, T, E, BQ);
    if (rc == 0) rc = sm90::tensor_map(&tk, k, T, E, BK);
  }
  if (rc == 0)
    rc = sm90::encode_map(&to, out, (long long)H * T, T, T, BQ, OUT_COLS,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  if (rc != 0) return rc;
  const auto kernel = head_logits_persistent<FORM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, SMEM, s>>>(tq, tk, to, T, H);
  return (int)cudaGetLastError();
}

}  // namespace hl

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

// K25's persistent kernel: the same arguments, and `blocks` persistent
// blocks (1 .. the tiles; ops/head_logits_kernels.py `head_logits_blocks`).
// q, k and out 16-byte aligned.
extern "C" int acai_head_logits_persistent(const void* q, const void* k,
                                           void* out, int T, int H, int form,
                                           int blocks, void* stream) {
  const long long tiles =
      (long long)H * (T / hl::BQ) * ((T + hl::BK - 1) / hl::BK);
  if (T % QT != 0 || T <= 0 || H <= 0 || form < 0 || form > 2 ||
      blocks <= 0 || blocks > tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == LANE_SLICE)
    return hl::launch<LANE_SLICE>(q, k, out, T, H, blocks, s);
  if (form == RESHAPE) return hl::launch<RESHAPE>(q, k, out, T, H, blocks, s);
  return hl::launch<PRESHAPED>(q, k, out, T, H, blocks, s);
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
    ACAI_KERNEL("head_logits", "lane_slice",
                hl::head_logits_persistent<LANE_SLICE>, hl::THREADS, hl::SMEM),
    ACAI_KERNEL("head_logits", "reshape",
                hl::head_logits_persistent<RESHAPE>, hl::THREADS, hl::SMEM),
    ACAI_KERNEL("head_logits", "preshaped",
                hl::head_logits_persistent<PRESHAPED>, hl::THREADS, hl::SMEM),
    ACAI_KERNEL("head_logits", "lane_slice wmma",
                head_logits_kernel<LANE_SLICE>, THREADS, 0),
    ACAI_KERNEL("head_logits", "reshape wmma", head_logits_kernel<RESHAPE>,
                THREADS, 0),
    ACAI_KERNEL("head_logits", "preshaped wmma",
                head_logits_kernel<PRESHAPED>, THREADS, 0),
    ACAI_KERNEL("batched_head_logits", "fp32",
                batched_head_logits_kernel<false>, THREADS, 0),
    ACAI_KERNEL("batched_head_logits", "int8",
                batched_head_logits_kernel<true>, THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
