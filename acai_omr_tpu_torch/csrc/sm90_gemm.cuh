// sm90_gemm.cuh: one GEMM core for Hopper, shared by K1 linear_bias_act (its
// large-M products) and K9 linear_bwd (wgrad and dgrad), and the Hopper
// building blocks (mbarriers, TMA, shared-memory descriptors, wgmma) that K1's
// skinny decode kernel and the warp-specialised attention kernels of K3
// encoder_attention and K7 attention_bwd (attention_sm90.cuh) are made of.
//
// Computes C (M, N) = A (M, K) B (K, N) over one range of K in bf16 with an
// fp32 accumulator, a (BM = 128) x BN tile a block, and hands the fp32 tile to
// the caller's epilogue four neighbouring columns at a time. A and B are each
// either K-major or MN-major in device memory, a template parameter each:
//
//   K1:        A = X (M, K) K-major,       B = W (K, N) MN-major;
//   K9 wgrad:  A = X^T, X (R, K) MN-major, B = dY (R, N) MN-major, contracting
//              over the R rows;
//   K9 dgrad:  A = dY (M, N) K-major,      B = W^T, W (K_out, N) K-major
//              (BN rows of W a box), contracting over N.
//
// Replaces (JAX package, ops/pallas_train_layer.py): the MXU dots of
// `_fwd_kernel` :438 (`_dot(x, wqkv)`, `_dot(a_s, wo)`, the F-chunked ff1 /
// ff2 dots), the weight-gradient folds `_acc` / `_dot_tb` :666-694 and the
// `_dot_bt` products of `_bwd_kernel`.
//
// Bound on an H100: tensor-core operations, 2 M N K at 989 TFLOP/s bf16, at
// every shape this core is given (thousands of rows; 170-1,000 flops a byte).
// Reaching it takes `wgmma` (the only instruction at the full rate) fed from
// shared memory faster than it consumes. Design:
//
// * TMA. One CUtensorMap per operand, made on the host by
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint: no
//   -lcuda), passed as a __grid_constant__ kernel parameter. 128-byte
//   swizzle, so a box's inner extent is 64 bf16: a K-major tile is one box of
//   64 K columns by its rows; an MN-major tile is one 64 x 64 box per 64
//   columns of M or N. TMA's zero fill covers the ragged M / N edge and any K
//   tail: nothing is padded on the host. (`tensor_map` also takes a row
//   stride and a 32-column box with 64-byte swizzle: K7 maps one head of a
//   strided (rows, 3E) buffer with them.)
// * A ring of STAGES (4 at BN = 256, 6 at BN = 128) stages of the (128 x 64)
//   A and (64 x BN) B tiles in dynamic shared memory (193 KB), each stage with
//   a full mbarrier (arrive.expect_tx of the stage's bytes, completed by the
//   TMA) and an empty mbarrier (one arrival per consumer warpgroup).
// * Warp specialisation: warpgroup 0 is the producer (one thread issues the
//   loads; setmaxnreg 40), warpgroups 1 and 2 are the consumers (setmaxnreg
//   232), each a 64-row half of the tile as wgmma m64nBNk16 (bf16 x bf16 ->
//   fp32, BN / 2 accumulator registers a thread). A stage is released once
//   the wgmma group after it has been issued and the one reading it has
//   retired (wait_group 1), so one group is always in flight.
// * The operand form is the descriptor's business: a K-major tile advances
//   its start address 32 bytes a k16 step (SBO 1024: eight 128-byte rows);
//   an MN-major tile 2,048 bytes (sixteen 128-byte K rows; LBO 8,192 between
//   64-wide boxes, SBO 1,024), with the instruction's transpose bit set.
//   So A^T B reads at the same rate as A B (wmma's col-major fragments cost
//   Aᵀ@B 34 % more on this card).
// * Epilogue: the fp32 accumulators go through shared memory (the ring's
//   bytes, after both consumers have retired their last group), then the 256
//   consumer threads walk the staged tile in groups of four columns, row by
//   row (coalesced), and call the caller's epilogue: K1's bias / GELU /
//   GELU' / dropout (keyed by row and column: the mask does not depend on the
//   tiling) or fp32 partial; K9's bf16 dW or fp32 split partial, or dX with
//   dgrad's dropout / product / residual epilogue.
//
// Measured on an H100 (PERF.md section 6): the mainloop at about 90 % of an
// SM's share of the tensor-core rate, plus a fixed cost of about 10 us a
// tile (the ring's fill, the staged epilogue and its stores, the launch)
// that nothing hides while a block holds one tile; the wrappers' plans
// model both. An epilogue that reads device memory (dgrad's `* mul` on wide
// outputs) adds its reads to that fixed cost. Not here yet, each for a
// later change: a persistent tile scheduler (one tile's epilogue
// overlapping the next tile's loads: the answer to that fixed cost),
// clusters with TMA multicast, fp8.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int BM = 128;          // two consumer warpgroups of 64 rows
constexpr int BK = 64;           // one 128-byte swizzle row of bf16
constexpr int BOX = 64;          // a swizzled box's inner extent (bf16)
constexpr int BOX_BYTES = BOX * BK * 2;  // one 64 x 64 box, 8 KB
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int CONSUMERS = 2;
constexpr unsigned long long WAIT_LIMIT_NS = 4000000000ull;

template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int C_LD = BN + 4;  // fp32 staging row, 16-byte aligned
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static_assert(BM * C_LD * 4 <= STAGES * STAGE_BYTES,
                "the staged C tile reuses the ring");
  static_assert(SMEM <= 227 * 1024, "past the card's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of `parity` to complete; a wait that does not end within
// WAIT_LIMIT_NS traps (a fault, not a hung card).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = now_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (now_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// One 2-D box of `map` at (c0 = inner element, c1 = row) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar` like a TMA box.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One 2-D box of shared memory at `src` into `map` at (c0, c1), in the
// thread's bulk group (commit with store_commit).
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

// Wait until at most N of the thread's committed store groups still read
// shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A shared-memory matrix descriptor; `swizzle` is the swizzle's span in bytes
// (128 or 64: layout types 1 and 2).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              int swizzle = 128) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) |
         ((swizzle == 128 ? 1ull : 2ull) << 62);
}

// The descriptor of k16 step `kk` of a 64-deep tile at `addr`.
template <bool MN>
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int kk) {
  return MN ? smem_desc(addr + kk * 2048, BOX_BYTES, 1024)
            : smem_desc(addr + kk * 32, 16, 1024);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// D (64 x 128, fp32, 64 registers a thread) += A (64 x 16) B (16 x 128), bf16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 256, fp32, 128 registers a thread) += A (64 x 16) B (16 x 256), bf16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32, 32 registers a thread) += A (64 x 16) B (16 x 64), bf16,
// both operands in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers, the fragment
// layout of an accumulator's columns) B (16 x 64) in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers, the fragment
// layout of an accumulator's columns) B (16 x 32) in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// Keeps registers that an issued wgmma still reads (A fragments) live, and
// unchanged, up to this point: after its wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
  else
    wgmma_n128<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
}

// Stage s of the ring: the loads of K block `k` of the tile (m0, n0).
template <int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(uint32_t a, uint32_t bar,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb, int m0,
                                           int n0, int k, uint32_t bytes) {
  const uint32_t b = a + Tile<BN>::A_BYTES;
  mbar_expect_tx(bar, bytes);
  if constexpr (A_MN) {
#pragma unroll
    for (int j = 0; j < BM / BOX; ++j)
      tma_load(a + j * BOX_BYTES, ta, bar, m0 + j * BOX, k);
  } else {
    tma_load(a, ta, bar, k, m0);
  }
  if constexpr (B_MN) {
#pragma unroll
    for (int j = 0; j < BN / BOX; ++j)
      tma_load(b + j * BOX_BYTES, tb, bar, n0 + j * BOX, k);
  } else {
    tma_load(b, tb, bar, k, n0);
  }
}

// The tile's fp32 sums, staged in shared memory, through the epilogue:
// `epi(v, m, n)` for the four columns n .. n + 3 of row m, inside (M, N).
template <int BN, class Epi>
__device__ __forceinline__ void run_epilogue(const float* ctile, int tid,
                                             int nthreads, int m0, int n0,
                                             int M, int N, const Epi& epi) {
  constexpr int G = BN / 4;
  for (int e = tid; e < BM * G; e += nthreads) {
    const int r = e / G, c = (e % G) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(ctile + r * Tile<BN>::C_LD + c);
    const float f[4] = {v.x, v.y, v.z, v.w};
    epi(f, m, n);
  }
}

// A 64 x BN accumulator (rows r0 .. r0 + 63 of the tile) into the staging.
template <int BN>
__device__ __forceinline__ void stage_acc(float* ctile, const float (&d)[BN / 2],
                                          int r0, int lt) {
  const int warp = lt / 32, lane = lt % 32;
  const int row = r0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * (lane % 4);
    *reinterpret_cast<float2*>(ctile + row * Tile<BN>::C_LD + col) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(ctile + (row + 8) * Tile<BN>::C_LD + col) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The warp-specialised kernel: grid (ceil(N / BN), ceil(M / BM), splits);
// block z sums K over [z * k_chunk, min(K, (z + 1) * k_chunk)), k_chunk a
// multiple of BK.
template <int BN, bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, int M, int N, int K,
                int k_chunk, Epi epi) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES];
  __shared__ __align__(8) uint64_t empty[T::STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  float* ctile = reinterpret_cast<float*>(smem_raw + (ring - raw));

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_chunk;
  const int steps = (min(K, k_lo + k_chunk) - k_lo + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % T::STAGES;
        mbar_wait(smem_u32(&empty[s]), ((i / T::STAGES) & 1) ^ 1);
        load_stage<BN, A_MN, B_MN>(ring + s * T::STAGE_BYTES,
                                   smem_u32(&full[s]), &ta, &tb, m0, n0,
                                   k_lo + i * BK, T::STAGE_BYTES);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1;
  const int lt = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(smem_u32(&full[s]), (i / T::STAGES) & 1);
    const uint32_t a = ring + s * T::STAGE_BYTES + c * BOX_BYTES;
    const uint32_t b = ring + s * T::STAGE_BYTES + T::A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<BN, A_MN, B_MN>(acc, step_desc<A_MN>(a, kk),
                            step_desc<B_MN>(b, kk));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (i > 0 && lt == 0)
      mbar_arrive(smem_u32(&empty[(i - 1) % T::STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // both consumers' last groups have retired: the ring is free for C
  asm volatile("bar.sync 1, 256;" ::: "memory");
  stage_acc<BN>(ctile, acc, c * 64, lt);
  asm volatile("bar.sync 1, 256;" ::: "memory");
  run_epilogue<BN>(ctile, threadIdx.x - 128, 256, m0, n0, M, N, epi);
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a row-major matrix (rows, cols) of `type` elements,
// `elem_bytes` each (bf16 unless given: K6 reads int8 caches, K14 packed int4
// words), whose rows lie `ld` elements apart, read in boxes of box_rows x
// box_cols with `swizzle`, zeros outside. TMA's own rules: a row stride and a
// base address that are multiples of 16 bytes, a box row a multiple of 16
// bytes, box extents at most 256.
inline int encode_map(
    CUtensorMap* map, const void* ptr, long long rows, long long cols,
    long long ld, int box_rows, int box_cols, CUtensorMapSwizzle swizzle,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    int elem_bytes = 2) {
  if (rows <= 0 || cols <= 0 || ld < cols || (ld * elem_bytes) % 16 != 0 ||
      box_rows < 1 || box_rows > 256 || box_cols < 1 || box_cols > 256 ||
      (box_cols * elem_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The swizzled map of the core's operands: boxes of box_rows x box_cols (64
// or 32) columns, swizzled across box_cols * 2 bytes (128 or 64); `ld`
// cols when 0. A head of a fused (rows, 3E) buffer is a map of its E columns
// at stride 3E.
inline int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                      int box_rows, int ld = 0, int box_cols = BOX) {
  if (box_cols != 64 && box_cols != 32) return (int)cudaErrorInvalidValue;
  return encode_map(map, ptr, rows, cols, ld == 0 ? cols : ld, box_rows,
                    box_cols,
                    box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The box rows of an operand's map: a K-major tile is one box of its rows
// (BM for A, BN for B: at most 256, TMA's limit on a box's extent), an
// MN-major tile boxes of 64 K rows.
constexpr int box_rows(bool mn, int tile_rows) { return mn ? BK : tile_rows; }

// C (M, N) = A B over K, in `splits` ranges of k_chunk (a multiple of BK).
template <int BN, bool A_MN, bool B_MN, class Epi>
inline int launch(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N,
                  int K, int k_chunk, int splits, const Epi& epi,
                  cudaStream_t s) {
  if (k_chunk <= 0 || k_chunk % BK != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel = gemm_kernel<BN, A_MN, B_MN, Epi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, Tile<BN>::SMEM, s>>>(ta, tb, M, N, K, k_chunk, epi);
  return (int)cudaGetLastError();
}

}  // namespace sm90
