// K19 smem_probe: how much on-chip scratch one block can hold.
//
// Replaces: tools/vmem_probe.py `probe` (kernel :16, pallas_call :21) of the
// JAX package, which gives a trivial kernel an (n, 128) bf16 VMEM scratch,
// copies row 0 of x (8, 128) into scratch row 0, writes scratch[0:8] * 2, and
// grows the scratch until the TPU compiler refuses it. On Hopper the scratch
// a block holds is dynamic shared memory: the same body over `bytes` of it,
// after cudaFuncSetAttribute(MaxDynamicSharedMemorySize, bytes). Past the
// card's limit the attribute or the launch is refused; that refusal is the
// probe's answer and is returned, not hidden. Only row 0 of the output is
// defined (rows 1-7 read scratch nobody wrote, as on the TPU).
//
// Bound: 2 KB in, 2 KB out; the time is the launch. The number that matters
// is the largest `bytes` that launches, held against
// cudaDevAttrMaxSharedMemoryPerBlockOptin (acai_smem_optin).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;

__global__ void __launch_bounds__(LANES)
smem_probe_kernel(const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ out) {
  extern __shared__ __nv_bfloat16 scratch[];  // (bytes / 256, 128)
  const int c = threadIdx.x;
  scratch[c] = x[c];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
    out[r * LANES + c] = __float2bfloat16(__bfloat162float(scratch[r * LANES + c]) * 2.0f);
}

}  // namespace

// x (8, 128) bf16, out (8, 128) bf16, bytes >= 8 rows of 256 bytes. Returns
// the CUDA error of the attribute or of the launch, 0 when it ran.
extern "C" int acai_smem_probe(const void* x, void* out, int bytes,
                               void* stream) {
  if (bytes < 8 * LANES * 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size must not fail the next launch
    return (int)e;
  }
  smem_probe_kernel<<<1, LANES, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device, in bytes
extern "C" int acai_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

extern "C" const char* acai_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
