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
// Bound: 2 KB in, 2 KB out, about a nanosecond at 3.35 TB/s: the time is
// all fixed cost, a launch and one block's chain of dependent accesses. The
// number that matters is the largest `bytes` that launches, held against
// cudaDevAttrMaxSharedMemoryPerBlockOptin (acai_smem_optin).
//
// The kernel (`smem_probe_warp_kernel`) is one warp and no barrier: lane l
// owns bytes [8 l, 8 l + 8) of every 256-byte row, so the lane that writes
// scratch row 0 is the one that reads it back. Rows 1-7 depend on nothing
// and are read first, while the kernel waits for the launch before it;
// then row 0 of x as one 8-byte load a lane, its store into scratch and the
// read back, then eight 8-byte stores a lane. The shared accesses are
// volatile PTX, so each is made and in that order. The launch is
// programmatic (Hopper's dependent launch: `cudaLaunchKernelEx` with
// programmatic stream serialization): the kernel lets the next launch
// start at its entry (`griddepcontrol.launch_dependents`) and waits for the
// one before it (`griddepcontrol.wait`) only before its first global read,
// so back-to-back probes overlap one launch's start with the tail of the
// last.
//
// The attribute is set by acai_smem_set_max, which the wrapper calls only
// for a size past the largest it has set on the device
// (ops/probe_kernels.py keeps that cache), so a call that launches is one
// launch. `smem_probe_kernel` is the kernel this one replaced (128 threads,
// one 2-byte element a thread, a barrier, the attribute set on every call;
// `acai_smem_probe_simple`), kept as the yardstick timed in turns
// (variant "simple").

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "func_attrs.cuh"

namespace {

constexpr int LANES = 128;      // bf16 columns of a row
constexpr int ROW_WORDS = 32;   // 8-byte words of a row: one a lane
constexpr int MAX_SMEM = 227 * 1024;  // Hopper's opt-in limit of a block

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

__device__ __forceinline__ uint2 ld_shared(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};"
               :: "r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// four bf16 doubled, each through fp32 and rounded back: exact (a power of
// two), inf past the largest bf16, as the twin's scratch * 2
__device__ __forceinline__ uint2 twice(uint2 w) {
  uint32_t h[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&h[i]);
    v = __floats2bfloat162_rn(__low2float(v) * 2.0f, __high2float(v) * 2.0f);
    h[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint2(h[0], h[1]);
}

__global__ void __launch_bounds__(ROW_WORDS)
smem_probe_warp_kernel(const uint2* __restrict__ x, uint2* __restrict__ out) {
  extern __shared__ uint2 scratch_words[];  // (bytes / 256, 32) words
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int l = threadIdx.x;
  const uint32_t base = static_cast<uint32_t>(
      __cvta_generic_to_shared(scratch_words + l));
  uint2 row[8];
#pragma unroll
  for (int r = 1; r < 8; ++r) row[r] = ld_shared(base + r * ROW_WORDS * 8);
  // the launch before this one has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  st_shared(base, __ldg(x + l));
  row[0] = ld_shared(base);
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * ROW_WORDS + l] = twice(row[r]);
}

}  // namespace

// Sets the largest dynamic shared memory a launch of the kernel may ask for
// on the current device: `simple` 0 the warp kernel, 1 the kernel it
// replaced. Returns the CUDA error, the error state cleared, so a refused
// size leaves the attribute as it was and does not fail the next launch.
extern "C" int acai_smem_set_max(int bytes, int simple) {
  const cudaError_t e = cudaFuncSetAttribute(
      simple ? reinterpret_cast<const void*>(smem_probe_kernel)
             : reinterpret_cast<const void*>(smem_probe_warp_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// x (8, 128) bf16, out (8, 128) bf16, both 8-byte aligned; bytes >= 8 rows
// of 256 bytes and at most what acai_smem_set_max last set for the warp
// kernel. One programmatic launch. Returns the CUDA error of the launch
// (cleared), 0 when it ran.
extern "C" int acai_smem_probe(const void* x, void* out, int bytes,
                               void* stream) {
  if (bytes < 8 * LANES * 2) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(ROW_WORDS);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, smem_probe_warp_kernel,
                                     static_cast<const uint2*>(x),
                                     static_cast<uint2*>(out));
  if (e == cudaSuccess) e = cudaGetLastError();
  else cudaGetLastError();
  return (int)e;
}

// The kernel the warp kernel replaced, as it was launched: the attribute on
// every call, then an ordinary launch. Returns the CUDA error of the
// attribute or of the launch (cleared), 0 when it ran.
extern "C" int acai_smem_probe_simple(const void* x, void* out, int bytes,
                                      void* stream) {
  if (bytes < 8 * LANES * 2) return (int)cudaErrorInvalidValue;
  const int rc = acai_smem_set_max(bytes, 1);
  if (rc != 0) return rc;
  smem_probe_kernel<<<1, LANES, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// Captures `n` launches of the warp kernel on a stream of its own into a CUDA graph and counts the graph's edges and,
// among them, the programmatic ones (cudaGraphDependencyTypeProgrammatic):
// whether a graph keeps the overlap that the stream gives. The attribute
// must already be set for `bytes`. Returns the CUDA error, 0 when it ran.
extern "C" int acai_smem_graph_edges(const void* x, void* out, int bytes,
                                     int n, int* n_edges,
                                     int* n_programmatic) {
  cudaStream_t s = nullptr;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e == cudaSuccess)
    e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  for (int i = 0; e == cudaSuccess && i < n; ++i)
    e = (cudaError_t)acai_smem_probe(x, out, bytes, s);
  if (s != nullptr) {
    const cudaError_t end = cudaStreamEndCapture(s, &graph);
    if (e == cudaSuccess) e = end;
  }
  size_t count = 0;
  if (e == cudaSuccess)
    e = cudaGraphGetEdges_v2(graph, nullptr, nullptr, nullptr, &count);
  *n_edges = (int)count;
  *n_programmatic = 0;
  if (e == cudaSuccess && count > 0) {
    cudaGraphNode_t* from = new cudaGraphNode_t[count];
    cudaGraphNode_t* to = new cudaGraphNode_t[count];
    cudaGraphEdgeData* data = new cudaGraphEdgeData[count];
    e = cudaGraphGetEdges_v2(graph, from, to, data, &count);
    for (size_t i = 0; e == cudaSuccess && i < count; ++i)
      *n_programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
    delete[] from;
    delete[] to;
    delete[] data;
  }
  if (graph != nullptr) cudaGraphDestroy(graph);
  if (s != nullptr) cudaStreamDestroy(s);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
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

// The resource rows: each kernel at the card's limit, so a query leaves the
// attribute at the largest size any launch may ask for (the wrapper's cache
// of the largest size set stays a lower bound).
static const AcaiKernelEntry kResources[] = {
    ACAI_KERNEL("smem_probe", "", smem_probe_warp_kernel, ROW_WORDS, MAX_SMEM),
    ACAI_KERNEL("smem_probe", "simple", smem_probe_kernel, LANES, MAX_SMEM),
};

ACAI_EXPORT_RESOURCES(kResources)
