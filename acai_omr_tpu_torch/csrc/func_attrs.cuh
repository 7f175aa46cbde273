// The per-kernel resource report: what the compiler gave each compiled
// variant of a source's kernels, and how many of its blocks an SM holds.
//
// A source lists its device kernels in a table of AcaiKernelEntry, after the
// kernels, and exports it with ACAI_EXPORT_RESOURCES(table). Each entry names
// "<op>|<variant>|<kernel>": the KernelOp that launches the kernel, the key
// of KernelOp.variants the kernel belongs to (empty: every launch of the op
// runs it) and the kernel itself, with the block size and the dynamic shared
// memory its launcher uses. Three C functions follow per library (each
// source is its own shared library, loaded on its own, so the names repeat
// without clashing):
//
//   int acai_resource_count();
//   const char* acai_resource_name(int i);
//   int acai_resources(int i, int* out);  // 0 or the cudaError_t
//
// out[0..6]: registers a thread (cudaFuncAttributes::numRegs), local memory a
// thread in bytes (localSizeBytes: the stack frame, spills included), static
// shared memory a block (sharedSizeBytes), the dynamic shared memory a block
// may ask for (maxDynamicSharedSizeBytes), resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launcher's block size
// and dynamic shared memory), that block size, that dynamic shared memory.
//
// This is the Hopper form of the TPU's question "which stage runs out of
// VMEM": on the card a kernel that needs more than its registers spills to
// local memory, and shared memory and registers set how many blocks an SM
// keeps in flight.

#pragma once

#include <cuda_runtime.h>

struct AcaiKernelEntry {
  const char* name;  // "<op>|<variant>|<kernel>"
  const void* fn;
  int threads;
  int dyn_smem;
};

inline int acai_func_attrs(const AcaiKernelEntry& e, int* out) {
  cudaError_t err;
  if (e.dyn_smem > 48 * 1024) {  // as the launcher sets it before a launch
    err = cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               e.dyn_smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, e.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn, e.threads,
                                                      (size_t)e.dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = blocks;
  out[5] = e.threads;
  out[6] = e.dyn_smem;
  return 0;
}

#define ACAI_KERNEL(op, variant, kernel, threads, dyn_smem)              \
  AcaiKernelEntry {                                                       \
    op "|" variant "|" #kernel, reinterpret_cast<const void*>(&kernel),   \
        (threads), (int)(dyn_smem)                                        \
  }

#define ACAI_EXPORT_RESOURCES(TABLE)                                      \
  extern "C" int acai_resource_count() {                                  \
    return (int)(sizeof(TABLE) / sizeof(TABLE[0]));                       \
  }                                                                       \
  extern "C" const char* acai_resource_name(int i) {                      \
    const int n = (int)(sizeof(TABLE) / sizeof(TABLE[0]));                \
    return i >= 0 && i < n ? TABLE[i].name : nullptr;                     \
  }                                                                       \
  extern "C" int acai_resources(int i, int* out) {                        \
    const int n = (int)(sizeof(TABLE) / sizeof(TABLE[0]));                \
    if (i < 0 || i >= n) return (int)cudaErrorInvalidValue;               \
    return acai_func_attrs(TABLE[i], out);                                \
  }
