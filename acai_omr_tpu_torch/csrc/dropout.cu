// K10 dropout, the standalone apply kernel: out = keep ? round(x * scale) : 0.
//
// Replaces: `_apply_drop` of ops/pallas_train_layer.py in the JAX package
// where it is a step of its own (here: the transition head's dropout, forward
// and backward; inside the stacks the same device function runs in the
// epilogues of K1, K8 and K9, see dropout.cuh for the mask's definition).
//
// x, out: (R, W) bf16, W % 4 == 0; image i owns rows [i*t, (i+1)*t).
//
// Bound on an H100: bytes (one bf16 row in, one out) at 3.35 TB/s; the ten
// Philox rounds per four elements are integer work beside them. Design: one
// thread per four neighbouring elements (8-byte loads and stores), one
// Philox call each.

#include "dropout.cuh"

namespace {

__global__ void dropout_kernel(const __nv_bfloat16* __restrict__ x,
                               __nv_bfloat16* __restrict__ out, size_t n4,
                               int w4, DropSpec d) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int row = (int)(i / w4);
  const int c4 = (int)(i % w4);
  float v[4];
  load4_bf16(x + i * 4, v);
  drop4(d, row, c4 * 4, v);
  store4_bf16(out + i * 4, v);
}

}  // namespace

extern "C" int acai_dropout(const void* x, void* out, int R, int W, int t,
                            unsigned thresh, float scale, unsigned seed0,
                            unsigned seed1, unsigned stream_id, void* stream) {
  if (W % 4 != 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d{thresh, scale, seed0, seed1, stream_id, t};
  const size_t n4 = (size_t)R * (W / 4);
  const int blocks = (int)((n4 + 255) / 256);
  dropout_kernel<<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<__nv_bfloat16*>(out), n4,
                                        W / 4, d);
  return (int)cudaGetLastError();
}
