// K4 add_layernorm: out = LayerNorm(bf16(x + r)) * gamma + beta, stats in fp32.
//
// Replaces: the post-norm residual LayerNorms of both Pallas bodies in the JAX
// package -- `_ln` of ops/pallas_monolith.py `_kernel` (after the self-attn,
// cross-attn and FFN residuals) and `_ln_fwd` of ops/pallas_train_layer.py
// `_fwd_kernel`. As there, the residual sum is taken in the compute dtype
// (rounded to bf16) before the fp32 statistics; biased variance, eps given.
//
// Bound on an H100: bytes (two bf16 rows in, one out, per row) at 3.35 TB/s;
// a row reduction with nothing for the tensor cores. At the decode step's
// rows (4-32 rows of E = 1024: 32-200 KB) the bytes take well under a
// microsecond, so the kernel's time is its fixed cost: the launch, the
// memory latency of its loads, the reductions.
//
// Design (add_layernorm_vec_kernel). W warps own a row (W = 1 or 4; the
// wrapper's add_layernorm_plan picks W from the rows), 128 threads a block.
// A thread owns 8 consecutive columns per chunk, c = (i * 32 W + t) * 8 for
// i < ceil(E / (256 W)), the last chunk masked (E % 8 == 0, E <= 1024), so
// x, r and the stores of out and zout move as 16-byte vectors and gamma and
// beta as float4 pairs. Two-pass mean / variance from registers, as the JAX
// kernels compute them.
//
// At the decode step's few rows (W = 4, one row a block) a row's latency is
// the kernel's time: gamma and beta are loaded first, then x and r, so every
// load of the row is in flight at once, and only the two reductions (warp
// shuffles, then one shared-memory exchange per statistic) stand between
// the loads and the stores. At thousands of rows (W = 1, four rows a block,
// no exchange) the kernel streams bytes, and what it keeps in flight per SM
// decides: there gamma and beta (shared by every row, hits in L1 / L2) are
// read at the stores, which keeps their 64 registers a thread free for more
// resident blocks.
//
// add_layernorm_kernel ("scalar") is the first form: one warp a row, scalar
// 2-byte loads strided by 32 columns, gamma and beta read after the
// statistics. It is kept only to be timed beside the redesign.
//
// Training modes: with `zout` given the rounded sum z = x + r is written too
// (the forward's saved pre-norm residuals z1, z2, z3); with r == nullptr the
// kernel is LayerNorm(x) alone (the backward re-derives x1 = LN(z1) and
// x2 = LN(z2) from the saved sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "func_attrs.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;      // rows a block of the scalar kernel
constexpr int MAX_PER = 32;  // E <= 1024
constexpr int MAX_E = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ROWS * 32)
add_layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ zout, int R, int E, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int per = E / 32;
  const size_t off = (size_t)row * E;
  float v[MAX_PER];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const int c = i * 32 + lane;
      if (r != nullptr) {
        const __nv_bfloat16 z = __float2bfloat16(__bfloat162float(x[off + c]) +
                                                 __bfloat162float(r[off + c]));
        if (zout != nullptr) zout[off + c] = z;
        v[i] = __bfloat162float(z);
      } else {
        v[i] = __bfloat162float(x[off + c]);
      }
      sum += v[i];
    }
  }
  const float mean = warp_sum(sum) / E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / E + eps);
#pragma unroll
  for (int i = 0; i < MAX_PER; ++i) {
    if (i < per) {
      const int c = i * 32 + lane;
      out[off + c] = __float2bfloat16((v[i] - mean) * inv * gamma[c] + beta[c]);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The sum of v over the W warps of this thread's row: warp shuffles, then
// (W = 4) the warps' sums through `part` (one slot a warp of the block).
template <int W>
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = warp_sum(v);
  if constexpr (W == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) s += part[first + k];
    return s;
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS)
add_layernorm_vec_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ r,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         __nv_bfloat16* __restrict__ out,
                         __nv_bfloat16* __restrict__ zout, int R, int E,
                         float eps) {
  constexpr int T = 32 * W;               // threads of a row
  constexpr int PER = MAX_E / (8 * T);    // chunks a thread at E = 1024
  constexpr int ROWS_B = THREADS / T;     // rows a block
  __shared__ float part[2][THREADS / 32];
  const int t = threadIdx.x % T;
  const int row = blockIdx.x * ROWS_B + threadIdx.x / T;
  // rows past R stay to the end where W = 4: their warps take part in the
  // block's exchanges, with nothing loaded or stored
  if constexpr (W == 1) {
    if (row >= R) return;
  }
  const bool live = row < R;
  const int vecs = E / 8;
  const size_t off = (size_t)(live ? row : 0) * E;
  constexpr bool kEarly = W == 4;  // gamma and beta before x and r
  float4 g[PER][2], b[PER][2];
  const auto load_affine = [&](int i) {
    const int c = (i * T + t) * 8;
    const float4* gp = reinterpret_cast<const float4*>(gamma + c);
    const float4* bp = reinterpret_cast<const float4*>(beta + c);
    g[i][0] = __ldg(gp);
    g[i][1] = __ldg(gp + 1);
    b[i][0] = __ldg(bp);
    b[i][1] = __ldg(bp + 1);
  };
  if constexpr (kEarly) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i * T + t < vecs) load_affine(i);
  }
  uint4 xu[PER], ru[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = (i * T + t) * 8;
    if (live && i * T + t < vecs) {
      xu[i] = *reinterpret_cast<const uint4*>(x + off + c);
      if (r != nullptr) ru[i] = *reinterpret_cast<const uint4*>(r + off + c);
    }
  }
  float v[PER][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = (i * T + t) * 8;
    if (live && i * T + t < vecs) {
      unpack8(xu[i], v[i]);
      if (r != nullptr) {
        float q[8];
        unpack8(ru[i], q);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[i][j] = __bfloat162float(__float2bfloat16(v[i][j] + q[j]));
        if (zout != nullptr)
          *reinterpret_cast<uint4*>(zout + off + c) = pack8(v[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.0f;
    }
  }
  const float mean = row_sum<W>(sum, part[0]) / E;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (live && i * T + t < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(row_sum<W>(sq, part[1]) / E + eps);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = (i * T + t) * 8;
    if (i * T + t < vecs) {
      if constexpr (!kEarly) load_affine(i);
      const float gs[8] = {g[i][0].x, g[i][0].y, g[i][0].z, g[i][0].w,
                           g[i][1].x, g[i][1].y, g[i][1].z, g[i][1].w};
      const float bs[8] = {b[i][0].x, b[i][0].y, b[i][0].z, b[i][0].w,
                           b[i][1].x, b[i][1].y, b[i][1].z, b[i][1].w};
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (v[i][j] - mean) * inv * gs[j] + bs[j];
      *reinterpret_cast<uint4*>(out + off + c) = pack8(o);
    }
  }
}

template <int W>
void launch_vec(const void* x, const void* r, const void* gamma,
                const void* beta, void* out, void* zout, int R, int E,
                float eps, cudaStream_t s) {
  constexpr int rows_b = THREADS / (32 * W);
  add_layernorm_vec_kernel<W><<<(R + rows_b - 1) / rows_b, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(zout), R, E,
      eps);
}

}  // namespace

// x, r, out, zout: (R, E) bf16 (r and zout may be null); gamma, beta: (E,)
// fp32. `warps`: 1 or 4 warps a row (the vector kernel: E % 8 == 0,
// E <= 1024, every pointer 16-byte aligned), or 0 for the scalar kernel
// (E % 32 == 0, E <= 1024).
extern "C" int acai_add_layernorm(const void* x, const void* r,
                                  const void* gamma, const void* beta,
                                  void* out, void* zout, int R, int E,
                                  float eps, int warps, void* stream) {
  if (R <= 0 || E <= 0 || E > MAX_E || E % (warps == 0 ? 32 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 0:
      add_layernorm_kernel<<<(R + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(r),
          static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(zout),
          R, E, eps);
      break;
    case 1:
      launch_vec<1>(x, r, gamma, beta, out, zout, R, E, eps, s);
      break;
    case 4:
      launch_vec<4>(x, r, gamma, beta, out, zout, R, E, eps, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The resource report of the kernels above (func_attrs.cuh): block size and
// dynamic shared memory as the launcher uses them.
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("add_layernorm", "scalar", add_layernorm_kernel, ROWS * 32, 0),
    ACAI_KERNEL("add_layernorm", "warps1", add_layernorm_vec_kernel<1>,
                THREADS, 0),
    ACAI_KERNEL("add_layernorm", "warps4", add_layernorm_vec_kernel<4>,
                THREADS, 0),
};
ACAI_EXPORT_RESOURCES(kResources)
