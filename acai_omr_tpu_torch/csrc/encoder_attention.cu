// K3 encoder_attention: the multi-head attention forward of both training
// stacks, masked by key validity and optionally causal, without materialising
// (B, H, Tq, Tk).
//
// Replaces: the per-(image, head) `_attend` loops of ops/pallas_train_layer.py
// `_fwd_kernel` in the JAX package: the encoder's bidirectional self-attention
// (cross=False), the decoder's causal self-attention and its cross-attention
// over the precomputed `mem_kv` (cross=True).
//
// Operands: q rows (B*Tq) with row stride ldq, k and v rows (B*Tk) with row
// stride ldkv, head h at columns h*Dh of each; valid (B, Tk) uint8 (1 = real
// key). Self-attention passes three views of one (B*T, 3E) qkv buffer
// (ldq = ldkv = 3E); cross-attention passes qc (ld E) and the two halves of
// mem_kv[l] (B, M, 2E) (ld 2E). Output (B*Tq, E) bf16.
//
// Numerics follow the JAX kernel: logits = q.k * scale + bias in fp32, where
// bias is ADDITIVE: -1e9 for a padded key plus -1e9 for a key after the query
// when causal (not -inf: a query row with no valid key gets the uniform
// distribution, not NaN). p = exp(logit - max) / sum is normalised in fp32
// FIRST and only then rounded to bf16 for the PV product, fp32 accumulation.
// Because p must be normalised before it is rounded, both designs below make
// two passes over the key tiles: the first keeps the online softmax
// statistics (running max and rescaled sum) per query row, the second
// recomputes the logits tile by tile, forms the normalised p in bf16 and
// accumulates p @ V on the tensor cores. The scores exist only one 64x64
// tile at a time (Hopper: in registers). The head dim is a template parameter, 64 (the ViT encoder and
// the seq2seq decoder) or 32 (the MAE decoder's 16 heads of a 512-wide layer):
// each head is a tile product of its own Dh columns, so a head of 32 does half
// the work of a head of 64 (the TPU kernel pairs two such heads in one 64-lane
// group with the other head's lanes zeroed, `_group_spec` / `_head_col_mask`,
// because it cannot slice below 64 lanes; nothing of that is needed here).
// With the additive mask a row with no key it may attend spreads its
// probability over the masked keys (causal: over the keys after it too), so
// a tile may be skipped only where no row of the block is such a row.
//
// Bound on an H100: tensor-core flops (4 * B * H * Tq * Tk * Dh for QK^T and
// PV over the attended pairs at 989 TFLOP/s bf16; both designs add a third
// product, the second QK^T of the two sweeps below); the bytes are small
// beside them at T = 1024 (at Dh = 32 and T = 512, the MAE decoder, reading
// q, k, v and writing the output once is the larger of the two).
//
// The Hopper design (`sm90_dh{Dh}`, the default), the form of K7's dQ kernel
// (attention_bwd.cu) on the building blocks of attention_sm90.cuh: one block
// per (128 query rows, head, image), a producer warpgroup and two consumer
// warpgroups of 64 rows. The producer's first thread loads the block's Q
// boxes by TMA, then streams the key tiles through a ring of four stages
// (full / empty mbarrier pairs): sweep 1 the K boxes, sweep 2 the K and V
// boxes, each with its 64 validity bytes beside it as a bulk copy. Heads are
// read in place: one tensor map per operand over its E columns at the
// buffer's row stride (three views of the (B*T, 3E) qkv buffer, or qc and
// mem_kv[l]), 128-byte swizzle at Dh = 64, 64-byte at Dh = 32. Sweep 1:
// S = Q K^T by wgmma m64n64k16 (both operands K-major) into registers, biased
// and scaled there, the running row max by quad shuffles and each thread's
// share of the rescaled row sum. Sweep 2 recomputes S, forms p normalised in
// fp32, packs it to bf16 pairs in the A fragment's layout and accumulates
// O += P V by wgmma with A from registers and V read MN-major; O stays in
// registers and is stored as bf16 rows. Key tiles past the image's last
// valid key (the ragged encode) and, causal, past the diagonal are skipped,
// exactly, only where every row of the block has a key it may attend
// (attn90::block_skip); otherwise every tile is visited. No atomics on the
// output: two runs give the same bits, which the backward's recompute
// (ops/train_layer_kernel.py) relies on.
//
// The pre-Hopper design (`wmma_dh{Dh}`, kept as the yardstick): one block
// per (64-query tile, head, image), four warps of 16 query rows each, wmma
// 16x16x16 bf16 tiles; K and V tiles share one shared-memory buffer loaded
// synchronously, the scores through an fp32 tile in shared memory, row
// statistics by full-warp shuffles, every key tile visited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

#include "attention_sm90.cuh"
#include "func_attrs.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 64;
constexpr int KT = 64;
constexpr int THREADS = 128;
constexpr int P_LD = KT + 8;  // bf16 probability tile
constexpr int S_LD = KT + 4;  // fp32 score tile
constexpr float NEG = -1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 64 x DH bf16 tile from global (row stride ld_g elements) into shared (row
// stride DH + 8).
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld_g,
                                          int tid) {
#pragma unroll
  for (int v = tid; v < 64 * DH / 8; v += THREADS) {
    const int r = v / (DH / 8);
    const int c = (v % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld_g + c);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ valid,
                         __nv_bfloat16* __restrict__ out, int Tq, int Tk,
                         int E, int ldq, int ldkv, float scale, int causal) {
  constexpr int H_LD = DH + 8;  // bf16 tiles of Q and K/V
  __shared__ __align__(128) __nv_bfloat16 Qs[QT * H_LD];
  __shared__ __align__(128) __nv_bfloat16 KVs[KT * H_LD];
  __shared__ __align__(128) float Ss[QT * S_LD];
  __shared__ __align__(128) __nv_bfloat16 Ps[QT * P_LD];
  __shared__ float kbias[KT];

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const __nv_bfloat16* qb = q + (size_t)b * Tq * ldq + h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * ldkv + h * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * ldkv + h * DH;
  const int row0 = warp * 16;

  load_tile<DH>(Qs, qb + (size_t)q0 * ldq, ldq, tid);

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.0f;
  }

  // S = Q_w K^T for this warp's 16 rows, scaled and biased, into Ss.
  auto scores = [&](int k0) {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + row0 * H_LD + kk * 16, H_LD);
        wmma::load_matrix_sync(bk, KVs + (j * 16) * H_LD + kk * 16, H_LD);
        wmma::mma_sync(s, a, bk, s);
      }
      wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16, s, S_LD,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float* srow = Ss + (row0 + r) * S_LD;
      const int qi = q0 + row0 + r;
      const float c0 = (causal && k0 + lane > qi) ? NEG : 0.0f;
      const float c1 = (causal && k0 + lane + 32 > qi) ? NEG : 0.0f;
      srow[lane] = srow[lane] * scale + (c0 + kbias[lane]);
      srow[lane + 32] = srow[lane + 32] * scale + (c1 + kbias[lane + 32]);
    }
    __syncwarp();
  };

  auto load_keys = [&](int k0) {
    load_tile<DH>(KVs, kb + (size_t)k0 * ldkv, ldkv, tid);
    if (tid < KT) kbias[tid] = valid[(size_t)b * Tk + k0 + tid] ? 0.0f : NEG;
  };

  // pass 1: softmax statistics per query row
  for (int k0 = 0; k0 < Tk; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + e;
      m_run[r] = m_new;
    }
  }

  // pass 2: normalised bf16 probabilities times V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  float inv_l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) inv_l[r] = 1.0f / l_run[r];

  for (int k0 = 0; k0 < Tk; k0 += KT) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* srow = Ss + (row0 + r) * S_LD;
      __nv_bfloat16* prow = Ps + (row0 + r) * P_LD;
      prow[lane] = __float2bfloat16(expf(srow[lane] - m_run[r]) * inv_l[r]);
      prow[lane + 32] =
          __float2bfloat16(expf(srow[lane + 32] - m_run[r]) * inv_l[r]);
    }
    __syncthreads();  // every warp is done reading K from KVs
    load_tile<DH>(KVs, vb + (size_t)k0 * ldkv, ldkv, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + row0 * P_LD + kk * 16, P_LD);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, KVs + (kk * 16) * H_LD + j * 16, H_LD);
        wmma::mma_sync(o[j], a, bv, o[j]);
      }
    }
  }

  // out tile through the (now free) score buffer
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Ss + row0 * S_LD + j * 16, o[j], S_LD,
                            wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float* srow = Ss + (row0 + r) * S_LD;
    __nv_bfloat16* orow =
        out + ((size_t)b * Tq + q0 + row0 + r) * E + h * DH;
#pragma unroll
    for (int c = lane; c < DH; c += 32) orow[c] = __float2bfloat16(srow[c]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int Tq, int Tk, int H, int ldq, int ldkv,
           float scale, int causal, cudaStream_t s) {
  dim3 grid(Tq / QT, H, B);
  encoder_attention_kernel<DH><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), Tq, Tk, H * DH, ldq, ldkv, scale,
      causal);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ the Hopper form

using attn90::bias_scores;
using attn90::block_skip;
using attn90::desc_k;
using attn90::desc_mn;
using attn90::init_ring;
using attn90::LOG2E;
using attn90::pack_bf16;
using attn90::quad_max;
using attn90::quad_sum;
using attn90::release;
using attn90::ROWS;
using attn90::Skip;
using attn90::SM90_THREADS;
using attn90::STAGES;
using attn90::store_rows;
using attn90::wgmma_rs;
using attn90::zero;

struct FwdArgs {
  const uint8_t* valid;
  __nv_bfloat16* out;  // (B*Tq, E)
  int Tq, Tk, E;
  float scale;
  int causal;
};

// Shared memory: the two consumers' Q tiles, the ring of STAGES (K, V) tile
// pairs (sweep 1 fills only K) and beside each stage its validity bytes.
template <int DH>
struct FwdSmem {
  static constexpr int TILE = ROWS * DH * 2;  // a 64 x DH bf16 tile
  static constexpr int FIXED = 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int SIDE = ROWS;
  static constexpr int BYTES = 1024 + FIXED + STAGES * STAGE + STAGES * SIDE;
  static_assert(TILE % 1024 == 0, "every tile keeps the swizzle's alignment");
  static_assert(BYTES <= 227 * 1024, "past the card's shared memory");
};

// S = Q K^T (64 x 64) of one warpgroup, both operands K-major, waited for.
template <int DH>
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t q,
                                           uint32_t k) {
  zero(s);
  sm90::fence_acc(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    sm90::wgmma_n64<0, 0>(s, desc_k<DH>(q, kk), desc_k<DH>(k, kk));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_acc(s);
}

template <int DH>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    attn_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, FwdArgs p) {
  using L = FwdSmem<DH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t fixed;
  __shared__ int last_sh;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + L::FIXED;
  const uint32_t side = ring + STAGES * L::STAGE;
  const unsigned char* side_g = smem_raw + (side - raw);

  const int q0 = blockIdx.x * 2 * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int n_wg = min(2, (p.Tq - q0) / ROWS);
  const Skip sk = block_skip(p.valid, p.Tk, p.causal, b, &last_sh);
  int n_kt = p.Tk / ROWS;  // key tiles swept, twice
  if (sk.on) {
    n_kt = sk.last / ROWS + 1;
    if (p.causal) n_kt = min(n_kt, (q0 + n_wg * ROWS - 1) / ROWS + 1);
  }
  init_ring(full, empty, &fixed, 4 * n_wg);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const uint32_t fb = sm90::smem_u32(&fixed);
      sm90::mbar_expect_tx(fb, n_wg * L::TILE);
      for (int c = 0; c < n_wg; ++c)
        sm90::tma_load(base + c * L::TILE, &tq, fb, h * DH,
                       b * p.Tq + q0 + c * ROWS);
      for (int i = 0; i < 2 * n_kt; ++i) {
        const int s = i % STAGES, kt = i < n_kt ? i : i - n_kt;
        const bool sweep2 = i >= n_kt;
        const uint32_t fs = sm90::smem_u32(&full[s]);
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(fs, (sweep2 ? 2 : 1) * L::TILE + ROWS);
        const int row = b * p.Tk + kt * ROWS;
        sm90::tma_load(ring + s * L::STAGE, &tk, fs, h * DH, row);
        if (sweep2)
          sm90::tma_load(ring + s * L::STAGE + L::TILE, &tv, fs, h * DH, row);
        sm90::bulk_load(side + s * L::SIDE, p.valid + row, ROWS, fs);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1;
  if (c >= n_wg) return;
  const int lt = threadIdx.x % 128, lane = lt % 32;
  const int t4 = lane % 4;
  const int qa = q0 + c * ROWS + (lt / 32) * 16 + lane / 4;  // rows qa, qa + 8
  const int q_hi = q0 + c * ROWS + ROWS - 1;
  const uint32_t qs = base + c * L::TILE;
  const float scale = p.scale;
  sm90::mbar_wait(sm90::smem_u32(&fixed), 0);

  float mrow[2] = {-FLT_MAX, -FLT_MAX}, lrow[2] = {0.0f, 0.0f};
  float sc[32], o[DH / 2];
  zero(o);
  for (int i = 0; i < 2 * n_kt; ++i) {
    const int s = i % STAGES, kt = i < n_kt ? i : i - n_kt;
    const bool sweep2 = i >= n_kt;
    if (i == n_kt) {  // the row statistics, complete: 1 / sum, max in log2
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lrow[hh] = 1.0f / quad_sum(lrow[hh]);
        mrow[hh] *= LOG2E;
      }
    }
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / STAGES) & 1);
    if (sk.on && p.causal && kt * ROWS > q_hi) {  // past this warpgroup's
      release(&empty[s], lane);                  // diagonal: all zeros
      continue;
    }
    const uint32_t ks = ring + s * L::STAGE;
    qk_product<DH>(sc, qs, ks);
    // the logits, biased as the JAX kernel biases them
    bias_scores(sc, side_g + s * L::SIDE, kt, qa, t4, scale, p.causal);
    if (!sweep2) {  // the running max and this thread's share of the sum
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -FLT_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        const float m_new = fmaxf(mrow[hh], quad_max(mx));
        const float ml = m_new * LOG2E;
        float l = lrow[hh] * exp2f((mrow[hh] - m_new) * LOG2E);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            l += exp2f(fmaf(sc[4 * j + 2 * hh + e], LOG2E, -ml));
        mrow[hh] = m_new;
        lrow[hh] = l;
      }
      release(&empty[s], lane);
      continue;
    }
    // sweep 2: p normalised in fp32, rounded into A fragments; O += P V
    uint32_t a[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int hh = x % 2;
      float pr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pr[e] = exp2f(fmaf(sc[2 * x + e], LOG2E, -mrow[hh])) * lrow[hh];
      a[x] = pack_bf16(pr[0], pr[1]);
    }
    sm90::fence_acc(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma_rs<DH>(o, a + 4 * kk, desc_mn<DH>(ks + L::TILE, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(o);
    sm90::fence_regs(a);
    release(&empty[s], lane);
  }
  store_rows<DH>(p.out + ((size_t)b * p.Tq + q0 + c * ROWS) * p.E, p.E,
                 h * DH, o, lt);
}

template <int DH>
int launch_sm90(const void* q, const void* k, const void* v, const void* valid,
                void* out, int B, int Tq, int Tk, int H, int ldq, int ldkv,
                float scale, int causal, cudaStream_t s) {
  using L = FwdSmem<DH>;
  const int e = H * DH;
  CUtensorMap mq, mk, mv;
  int rc = sm90::tensor_map(&mq, q, B * Tq, e, ROWS, ldq, DH);
  if (rc == 0) rc = sm90::tensor_map(&mk, k, B * Tk, e, ROWS, ldkv, DH);
  if (rc == 0) rc = sm90::tensor_map(&mv, v, B * Tk, e, ROWS, ldkv, DH);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const FwdArgs p{static_cast<const uint8_t*>(valid),
                  static_cast<__nv_bfloat16*>(out), Tq, Tk, e, scale, causal};
  attn_fwd_sm90<DH><<<dim3((Tq + 2 * ROWS - 1) / (2 * ROWS), H, B),
                      SM90_THREADS, L::BYTES, s>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q: rows B*Tq, stride ldq; k, v: rows B*Tk, stride ldkv; valid: (B, Tk)
// uint8; out: (B*Tq, E) bf16. Requires Dh == 64 or Dh == 32, Tq % 64 == 0,
// Tk % 64 == 0 and strides that keep 16-byte loads aligned (multiples of 8);
// wmma 0 (the Hopper kernel): q, k, v 16-byte aligned (TMA); wmma 1: the
// pre-Hopper kernel.
extern "C" int acai_encoder_attention(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, int B, int Tq, int Tk, int H,
                                      int dh, int ldq, int ldkv, float scale,
                                      int causal, int wmma, void* stream) {
  if ((dh != 64 && dh != 32) || Tq % QT != 0 || Tk % KT != 0 || ldq % 8 != 0 ||
      ldkv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wmma)
    return dh == 32 ? launch_sm90<32>(q, k, v, valid, out, B, Tq, Tk, H, ldq,
                                      ldkv, scale, causal, s)
                    : launch_sm90<64>(q, k, v, valid, out, B, Tq, Tk, H, ldq,
                                      ldkv, scale, causal, s);
  if (dh == 32)
    return launch<32>(q, k, v, valid, out, B, Tq, Tk, H, ldq, ldkv, scale,
                      causal, s);
  return launch<64>(q, k, v, valid, out, B, Tq, Tk, H, ldq, ldkv, scale,
                    causal, s);
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("encoder_attention", "sm90_dh64", attn_fwd_sm90<64>,
                SM90_THREADS, FwdSmem<64>::BYTES),
    ACAI_KERNEL("encoder_attention", "sm90_dh32", attn_fwd_sm90<32>,
                SM90_THREADS, FwdSmem<32>::BYTES),
    ACAI_KERNEL("encoder_attention", "wmma_dh64", encoder_attention_kernel<64>, THREADS, 0),
    ACAI_KERNEL("encoder_attention", "wmma_dh32", encoder_attention_kernel<32>, THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
