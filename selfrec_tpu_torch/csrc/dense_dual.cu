// Dual-direction dense bipartite propagation for Hopper (sm_90a): kernel K1
// of the port.
//
// Replaces: selfrec_tpu/ops/dense_dual.py:122-235 (Pallas `_dual_kernel`,
// `_dual_call`, `dual_matmul`), both of its variants. Computes
//
//     out_u = B @ xi      (U, I) x (I, D) -> (U, D)
//     out_i = B^T @ xu    (I, U) x (U, D) -> (I, D)
//
// with B the (U, I) 0/1 int8 incidence:
// - int8 operands (the main path; xu, xi per-channel-quantized) with exact
//   int32 sums: |products| <= 127 and the row counts are far below
//   2^31 / 127, so every order gives the same bits;
// - bf16 or f32 operands with f32 sums (the TPU kernel's float variant).
//
// Both kernels share one skeleton, built for one output chunk of N = 64,
// 128 or 192 columns; the wrapper pads D and runs ceil(D / 192) chunks as
// the grid's y dimension, each reading B once more.
//
// The trade. `wgmma` takes B's int8 tile K-major from shared memory, and B
// is K-major for only one of the two products. So the block is kept twice,
// as B and as B^T (`DenseAdj.a_iu`, made once per block, in `refactor_view`
// too), and a kernel is two plain GEMMs in one launch: blocks
// [0, tiles_u) make out_u from B and xi, blocks [tiles_u, ...) make out_i
// from B^T and xu. It reads 2.4 GB a launch at yelp2018 scale
// (U = 31,667, I = 38,048) instead of 1.2 GB, a floor of 0.72 ms at
// 3.35 TB/s. In exchange each block owns its output rows over the whole
// contraction: no atomics, no transposes in shared memory, one write of
// each output, and the operand is read as K-major (N, k) tiles.
// The skeleton:
// - 192 output rows a block: three consumer warpgroups of 64 rows each,
//   and a producer warp (float: warpgroup) whose first thread keeps TMA
//   loads in flight. Every
//   block reads the whole operand chunk from L2, so taller blocks cut that
//   traffic: at 192 rows it is about as much as the block's own bytes, and
//   the 364 blocks of a chunk fill 2.76 waves of the 132 SMs.
// - A stage is the (192 rows x 128 bytes) tile of B or B^T and the
//   operand's tile over the same 128 contraction indices, all copied by TMA
//   with the 128-byte swizzle, in a ring of 3-6 stages with full/empty
//   mbarriers between producer and consumers.
// - Ragged edges: TMA fills rows and columns past U, I with zeros, which
//   add nothing, and the epilogue writes only rows below U or I. Row
//   pitches must be multiples of 16 bytes (the wrapper sees to it).
//
// int8, `dual_s8_kernel`. Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8
// dense): at D = 64 one read of the 1.2 GB block, 0.36 ms (bytes); at
// D = 192, 4*U*I*D = 9.3e11 operations, 0.47 ms. The operand is K-major
// int8 (xi^T, xu^T); each stage is four `wgmma.m64nNk32.s32.s8.s8` a
// warpgroup, both operands from shared memory, the sums in registers for
// the whole contraction; a stage is released once the next one's products
// are issued.
//
// float, `dual_float_kernel`. Bound: 4*U*I*D bf16 tensor operations at
// 989 TFLOP/s (D = 192: 0.94 ms), three times that for f32 operands.
// - B's 0/1 bytes become the bf16 A operand in registers: each consumer
//   thread reads its fragment from the staged int8 tile (32-bit loads,
//   conflict-free under the swizzle: the 8 rows of a load fall in 8
//   different 16-byte bank groups) and widens 0/1 bytes to bf16 0/1 with
//   a byte permute and a multiply (exact for 0 and 1 only, which B is).
//   So `wgmma.m64nNk16.f32.bf16.bf16` takes A from registers and the
//   operand from shared memory; B is never widened in memory.
// - A thread's fragment holds the contraction indices 2t, 2t+1, 2t+8,
//   2t+9 of each 16 (t = lane % 4), and reading them as one 32-bit word
//   needs bytes 4t..4t+3 to hold them. The wrapper permutes the operand's
//   contraction index to match inside each group of 16 (position
//   8h + 2t + j holds index 4t + 2h + j), which pairs every byte of B
//   with its own operand row: the sum is the same, in another order.
// - The operand is K-major bf16, made from x in one pass
//   (`float_operand_kernel`: pad, permute, transpose and, for f32, split),
//   which the permutation needs anyway: two TMA boxes of 64 values a
//   stage, read with the same descriptors as the int8 kernel's (32 bytes a
//   k-step).
// - A fragment must stay unchanged until its products are done, so a
//   warpgroup keeps two sets: it issues four k-steps (two at N = 192) from
//   one, commits, and loads the next group into the other while waiting
//   only for the group before.
// - Registers: the producer is a whole warpgroup that hands most of its
//   registers to the consumers (`setmaxnreg`), 152 a consumer thread, so
//   the 96-register sum at N = 192 fits beside its fragments unspilled.
// - f32 operands come split (by the same pass) into bf16 pieces hi, mid and
//   lo with x == hi + 2^-8 mid + 2^-16 lo exactly, side by side in groups
//   of 64 columns; a 192-wide chunk then keeps three separate f32 sums for
//   64 output columns (one shared sum loses the small pieces' bits), and
//   the epilogue adds them smallest first.
//
// Plain C interface, loaded with ctypes (selfrec_tpu_torch/ops/dense_dual.py).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int CONSUMER_WGS = 3;        // consumer warpgroups, 64 output rows each
constexpr int BM = 64 * CONSUMER_WGS;  // output rows a block
constexpr int BK = 128;                // contraction indices a stage (B's tile: one swizzle row)
constexpr int CONSUMER_THREADS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMER_THREADS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK;
constexpr int RING_BYTES = 220 * 1024;

// The stage ring of a kernel whose operand tile takes X_BYTES a stage.
template <int X_BYTES>
struct Ring {
  static constexpr int STAGE = A_BYTES + X_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(X_BYTES % 1024 == 0, "tiles must stay 1024-byte aligned");
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart. Advancing along K inside the 128-byte row is adding the
// byte offset to the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments in registers, which `wgmma` reads while it runs.
template <int G>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[G][4]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// wgmma.m64nNk32 s8 x s8 -> s32, both operands from shared memory, and
// wgmma.m64nNk16 bf16 x bf16 -> f32 with A from registers; the sums
// accumulated into d.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n192(float (&d)[96], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_s8_n64(d, da, db);
  } else if constexpr (N == 128) {
    wgmma_s8_n128(d, da, db);
  } else {
    static_assert(N == 192, "built for N = 64, 128 and 192");
    wgmma_s8_n192(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (N == 64) {
    wgmma_bf16_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_bf16_n128(d, a, db);
  } else {
    static_assert(N == 192, "built for N = 64, 128 and 192");
    wgmma_bf16_n192(d, a, db);
  }
}

// What a block of either kernel works on: its direction, its rows, and
// the stage ring's barriers, set up by thread 0 before anything else.
struct Block {
  bool user_dir;
  int m0, m_rows, nk;
  uint32_t base, bars;
  int stages;

  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (stages + s); }
};

__device__ __forceinline__ Block block_setup(uint8_t* smem_raw, int stages, int stage_bytes,
                                             int n_u, int n_i, int tiles_u, int empty_count) {
  Block blk;
  const uint32_t raw = smem_u32(smem_raw);
  blk.base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  blk.stages = stages;
  blk.bars = blk.base + stages * stage_bytes;
  blk.user_dir = static_cast<int>(blockIdx.x) < tiles_u;
  blk.m0 = (blk.user_dir ? blockIdx.x : blockIdx.x - tiles_u) * BM;
  blk.m_rows = blk.user_dir ? n_u : n_i;
  blk.nk = ((blk.user_dir ? n_i : n_u) + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return blk;
}

// Lane 0 of the producer warp: stage kt gets B's (BM x BK) tile at
// contraction offset kt*BK and the operand's tile over the same range, as
// BOXES boxes of BK/BOXES values side by side (box_bytes each), rows
// x_row0.. of the K-major operand.
template <int STAGES, int STAGE, int BOXES>
__device__ __forceinline__ void produce(const Block& blk, const CUtensorMap* map_a,
                                        const CUtensorMap* map_x, int x_row0,
                                        int box_bytes) {
  for (int kt = 0; kt < blk.nk; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES) mbar_wait(blk.empty(s), ((kt / STAGES) - 1) & 1);
    const uint32_t a_dst = blk.base + s * STAGE;
    mbar_expect_tx(blk.full(s), STAGE);
    tma_load_2d(a_dst, map_a, kt * BK, blk.m0, blk.full(s));
#pragma unroll
    for (int b = 0; b < BOXES; ++b) {
      tma_load_2d(a_dst + A_BYTES + b * box_bytes, map_x, kt * BK + b * (BK / BOXES), x_row0,
                  blk.full(s));
    }
  }
}

// ---------------------------------------------------------------------------
// int8 operands
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
dual_s8_kernel(const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_bt,
               const __grid_constant__ CUtensorMap map_xit,
               const __grid_constant__ CUtensorMap map_xut, int* __restrict__ out_u,
               int* __restrict__ out_i, int ld_out, int n_u, int n_i, int tiles_u) {
  using R = Ring<N * BK>;
  extern __shared__ uint8_t smem_raw[];
  const Block blk = block_setup(smem_raw, R::STAGES, R::STAGE, n_u, n_i, tiles_u, CONSUMER_WGS);
  const int chunk = blockIdx.y;

  if (threadIdx.x >= CONSUMER_THREADS) {  // producer warp
    if (threadIdx.x == CONSUMER_THREADS) {
      produce<R::STAGES, R::STAGE, 1>(blk, blk.user_dir ? &map_b : &map_bt,
                                      blk.user_dir ? &map_xit : &map_xut, chunk * N, N * BK);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  int acc[N / 2];
#pragma unroll
  for (int r = 0; r < N / 2; ++r) acc[r] = 0;

  for (int kt = 0; kt < blk.nk; ++kt) {
    const int s = kt % R::STAGES;
    mbar_wait(blk.full(s), (kt / R::STAGES) & 1);
    const uint32_t a_tile = blk.base + s * R::STAGE + wg * 64 * BK;
    const uint32_t x_tile = blk.base + s * R::STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      wgmma_s8<N>(acc, desc_sw128(a_tile + 32 * kk), desc_sw128(x_tile + 32 * kk));
    }
    wgmma_commit();
    fence_regs(acc);
    // the previous stage's products are done once at most one group is open
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(blk.empty((kt - 1) % R::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator layout of m64nN: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8); in each 8-column block j, columns 8j + 2(lane%4) + {0,1}
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = blk.m0 + wg * 64 + 16 * warp + lane / 4;
  int* __restrict__ out = (blk.user_dir ? out_u : out_i) + chunk * N + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (row < blk.m_rows) {
      *reinterpret_cast<int2*>(out + static_cast<long long>(row) * ld_out + 8 * j) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
    }
    if (row + 8 < blk.m_rows) {
      *reinterpret_cast<int2*>(out + static_cast<long long>(row + 8) * ld_out + 8 * j) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 operands (f32 operands as three bf16 pieces)
// ---------------------------------------------------------------------------

constexpr int KSTEPS = BK / 16;  // bf16 k-steps a stage
// The producer is a whole warpgroup here, so that registers can move to
// the consumers: 13 warps share a block's 4 register-file quarters as
// 4 + 3 + 3 + 3, which caps every thread at 128 registers, too few for a
// 64 x 192 f32 sum (96) beside its A fragments. With 16 warps the producer
// gives up all but 40 of its 128 (`setmaxnreg`) and each consumer thread
// gets 152: 3 * 152 + 40 = 4 * 124 <= 4 * 128 a quarter.
constexpr int F_THREADS = CONSUMER_THREADS + 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 152;
static_assert(CONSUMER_WGS * CONSUMER_REGS + PRODUCER_REGS <= 4 * 128, "register file");

template <int R>
__device__ __forceinline__ void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Four 0/1 bytes (contraction indices 2t, 2t+1, 2t+8, 2t+9 after the
// wrapper's permutation) as two bf16 pairs: (2t, 2t+1) and (2t+8, 2t+9).
__device__ __forceinline__ void widen01(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = __byte_perm(w, 0, 0x4140) * 0x3F80u;  // bf16 1.0 is 0x3F80
  hi = __byte_perm(w, 0, 0x4342) * 0x3F80u;
}

template <int N, int PIECES>
__global__ void __launch_bounds__(F_THREADS, 1)
dual_float_kernel(const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_bt,
                  const __grid_constant__ CUtensorMap map_xit,
                  const __grid_constant__ CUtensorMap map_xut, float* __restrict__ out_u,
                  float* __restrict__ out_i, int ld_out, int n_u, int n_i, int tiles_u) {
  static_assert(PIECES == 1 || N == 192, "f32 pieces come in 192-wide chunks");
  constexpr int BOX_BYTES = N * 128;  // one box: N operand rows x 64 bf16
  using R = Ring<2 * BOX_BYTES>;
  extern __shared__ uint8_t smem_raw[];
  // every consumer warp releases a stage: its own fragment loads are then done
  const Block blk = block_setup(smem_raw, R::STAGES, R::STAGE, n_u, n_i, tiles_u,
                                CONSUMER_THREADS / 32);
  const int chunk = blockIdx.y;
  // k-steps a warpgroup issues in a group: their A fragments (4 registers
  // a step, two groups' worth) stay live until the group is done
  constexpr int KGROUP = N == 192 ? 2 : 4;
  static_assert((KSTEPS / KGROUP) % 2 == 0, "fragment sets alternate within a stage");

  if (threadIdx.x >= CONSUMER_THREADS) {  // producer warpgroup
    regs_lower<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_THREADS) {
      produce<R::STAGES, R::STAGE, 2>(blk, blk.user_dir ? &map_b : &map_bt,
                                      blk.user_dir ? &map_xit : &map_xut, chunk * N, BOX_BYTES);
    }
    return;
  }
  regs_raise<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows in the warpgroup's slab: 16 warp + g and + 8; both
  // have g as their row index mod 8, which the swizzle XORs into the chunk
  const uint32_t row_off = (16 * warp + g) * BK + 4 * t;
  float acc[N / 2];
#pragma unroll
  for (int r = 0; r < N / 2; ++r) acc[r] = 0.f;

  // two sets of fragments: one group's are loaded while the previous
  // group's products run
  uint32_t a[2][KGROUP][4] = {};
  for (int kt = 0; kt < blk.nk; ++kt) {
    const int s = kt % R::STAGES;
    mbar_wait(blk.full(s), (kt / R::STAGES) & 1);
    const uint32_t a_tile = blk.base + s * R::STAGE + wg * 64 * BK + row_off;
    const uint32_t x_tile = blk.base + s * R::STAGE + A_BYTES;
#pragma unroll
    for (int q = 0; q < KSTEPS / KGROUP; ++q) {
      uint32_t (&cur)[KGROUP][4] = a[q % 2];
#pragma unroll
      for (int j = 0; j < KGROUP; ++j) {
        const int k = q * KGROUP + j;
        const uint32_t c = static_cast<uint32_t>(k ^ g) << 4;  // swizzled 16-byte chunk
        widen01(lds32(a_tile + c), cur[j][0], cur[j][2]);
        widen01(lds32(a_tile + 8 * BK + c), cur[j][1], cur[j][3]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KGROUP; ++j) {
        const int k = q * KGROUP + j;  // box k / 4, 32 bytes a k-step inside it
        wgmma_bf16<N>(acc, cur[j], desc_sw128(x_tile + (k / 4) * BOX_BYTES + 32 * (k % 4)));
      }
      wgmma_commit();
      fence_regs(acc);
      // the group before this one is done, and its fragments are free
      wgmma_wait<1>();
      fence_regs(acc);
      fence_frags(a[(q + 1) % 2]);
      // at a stage's first group that was the previous stage's last
      if (q == 0 && kt > 0 && lane == 0) mbar_arrive(blk.empty((kt - 1) % R::STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator layout as in the int8 kernel; with three pieces, columns
  // [0, 64) hold the hi sums, [64, 128) mid and [128, 192) lo
  constexpr int OUT = N / PIECES;
  const int row = blk.m0 + wg * 64 + 16 * warp + g;
  float* __restrict__ out = (blk.user_dir ? out_u : out_i) + chunk * OUT + 2 * t;
#pragma unroll
  for (int j = 0; j < OUT / 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = acc[4 * j + e];
      if constexpr (PIECES == 3) {
        v[e] = (acc[4 * (j + 16) + e] * 0x1p-16f + acc[4 * (j + 8) + e] * 0x1p-8f) + v[e];
      }
    }
    if (row < blk.m_rows) {
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * ld_out + 8 * j) =
          make_float2(v[0], v[1]);
    }
    if (row + 8 < blk.m_rows) {
      *reinterpret_cast<float2*>(out + static_cast<long long>(row + 8) * ld_out + 8 * j) =
          make_float2(v[2], v[3]);
    }
  }
}

// The float kernel's operand in one pass (dense_dual.py `float_operand`,
// whose torch version is its plain one): x (n, d) f32 or bf16, row pitch
// ld_x values, to out (rows_out, n_pad) bf16, K-major, the contraction
// index permuted in groups of 16 and zero past n and d. With pieces = 3
// row 192 g + 64 q + c holds piece q (hi, mid, lo: each remainder cut to
// its top 16 bits, then scaled by 2^8) of column 64 g + c. One thread
// writes 8 values of one row; its reads hit L2, where x stays.
__global__ void __launch_bounds__(256)
float_operand_kernel(const void* __restrict__ x, int x_is_f32, long long ld_x, int n, int d,
                     int pieces, uint16_t* __restrict__ out, int n_pad) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;  // 8 positions: 8m..8m+7
  if (m >= n_pad / 8) return;
  const int r = blockIdx.y;
  const int q = pieces == 3 ? (r % 192) / 64 : 0;
  const int col = pieces == 3 ? (r / 192) * 64 + r % 64 : r;
  const int src0 = 16 * (m / 2) + 2 * (m % 2);  // position 8h + 2t + j holds 4t + 2h + j
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    uint32_t bits[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int src = src0 + 2 * e + j;  // t = e / 2
      bits[j] = 0;
      if (src < n && col < d) {
        const long long at = static_cast<long long>(src) * ld_x + col;
        if (!x_is_f32) {
          bits[j] = static_cast<const uint16_t*>(x)[at];
        } else {
          float v = static_cast<const float*>(x)[at];
          for (int k = 0; k < q; ++k) {
            v = (v - __uint_as_float(__float_as_uint(v) & 0xFFFF0000u)) * 256.f;
          }
          bits[j] = __float_as_uint(v) >> 16;
        }
      }
    }
    w[e / 2] = bits[0] | (bits[1] << 16);
  }
  *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * n_pad + 8 * m) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) array of uint8 (esize 1) or bf16 (esize 2) with a row
// pitch of `pitch` bytes, read in boxes of box_rows rows x 128 bytes with
// the 128-byte swizzle; reads past the array's edges fill zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, int esize, const void* base,
              long long rows, long long cols, long long pitch, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arguments both kernels take; see the C interface below.
struct Args {
  const void *b, *bt, *xut, *xit;
  long long ldb, ldbt, ldxu, ldxi;
  void *out_u, *out_i;
  int ld_out, n_u, n_i, chunks;
  cudaStream_t stream;
};

struct Maps {
  CUtensorMap b, bt, xi, xu;
};

// Encodes the four tensor maps (operand rows: chunks * n, read in boxes of
// n rows; xu_cols, xi_cols values a row, esize bytes a value) and raises
// the kernel's shared-memory limit to `smem`. Returns 0 or the C
// interface's error code.
int prepare(const Args& a, int n, int esize, long long xu_cols, long long xi_cols,
            const void* kernel, int smem, Maps* m) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const long long rows = static_cast<long long>(a.chunks) * n;
  if (!make_map(encode, &m->b, 1, a.b, a.n_u, a.n_i, a.ldb, BM) ||
      !make_map(encode, &m->bt, 1, a.bt, a.n_i, a.n_u, a.ldbt, BM) ||
      !make_map(encode, &m->xi, esize, a.xit, rows, xi_cols, a.ldxi, n) ||
      !make_map(encode, &m->xu, esize, a.xut, rows, xu_cols, a.ldxu, n)) {
    return -3;
  }
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

dim3 grid_of(const Args& a) {
  return dim3((a.n_u + BM - 1) / BM + (a.n_i + BM - 1) / BM, a.chunks);
}

// int8 operands: the maps stop at the contraction's end, past which TMA
// fills zeros.
template <int N>
int launch_s8(const Args& a) {
  constexpr int SMEM = Ring<N * BK>::SMEM;
  Maps m;
  const int rc = prepare(a, N, 1, a.n_u, a.n_i,
                         reinterpret_cast<const void*>(dual_s8_kernel<N>), SMEM, &m);
  if (rc != 0) return rc;
  dual_s8_kernel<N><<<grid_of(a), THREADS, SMEM, a.stream>>>(
      m.b, m.bt, m.xi, m.xu, static_cast<int*>(a.out_u), static_cast<int*>(a.out_i), a.ld_out,
      a.n_u, a.n_i, (a.n_u + BM - 1) / BM);
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands, zero-padded by the wrapper to whole stages: every box
// lies inside its array.
template <int N, int PIECES>
int launch_float(const Args& a) {
  constexpr int SMEM = Ring<2 * N * 128>::SMEM;
  Maps m;
  const int rc = prepare(a, N, 2, (a.n_u + BK - 1) / BK * BK, (a.n_i + BK - 1) / BK * BK,
                         reinterpret_cast<const void*>(dual_float_kernel<N, PIECES>), SMEM, &m);
  if (rc != 0) return rc;
  dual_float_kernel<N, PIECES><<<grid_of(a), F_THREADS, SMEM, a.stream>>>(
      m.b, m.bt, m.xi, m.xu, static_cast<float*>(a.out_u), static_cast<float*>(a.out_i),
      a.ld_out, a.n_u, a.n_i, (a.n_u + BM - 1) / BM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// b (n_u, n_i) and bt (n_i, n_u) int8, the same 0/1 block and its
// transpose, each with a row pitch (ld*, bytes) that is a multiple of 16
// and a 16-byte aligned base. The operands are K-major: xut
// (chunks * n, n_u) and xit (chunks * n, n_i), each chunk of n rows one
// output chunk, pitches ldxu, ldxi (bytes, multiples of 16); out_u (n_u,
// ld_out) and out_i (n_i, ld_out), ld_out even, written in columns
// [0, chunks * n). Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), -1 for a chunk width it is not built
// for, -2 when cuTensorMapEncodeTiled cannot be found, -3 when a tensor map
// is refused.
//
// int8: xut, xit int8; out int32 exact.
int selfrec_dual_s8(const void* b, long long ldb, const void* bt, long long ldbt,
                    const void* xut, long long ldxu, const void* xit, long long ldxi,
                    void* out_u, void* out_i, int ld_out, int n_u, int n_i, int n, int chunks,
                    void* stream) {
  const Args a{b, bt, xut, xit, ldb, ldbt, ldxu, ldxi, out_u, out_i, ld_out, n_u, n_i,
               chunks, static_cast<cudaStream_t>(stream)};
  switch (n) {
    case 64: return launch_s8<64>(a);
    case 128: return launch_s8<128>(a);
    case 192: return launch_s8<192>(a);
    default: return -1;
  }
}

// float: xut, xit bf16 with the contraction index permuted in groups of 16
// (position 8h + 2t + j holds index 4t + 2h + j) and padded with zeros to a
// multiple of 128 (the pitch, in values, is that width); out f32. With
// pieces = 3 (n = 192), each chunk's rows are an f32 operand's hi, mid and
// lo pieces of 64 columns and it writes 64 output columns, x == hi +
// 2^-8 mid + 2^-16 lo; with pieces = 1 the operand is bf16 as it is.
int selfrec_dual_float(const void* b, long long ldb, const void* bt, long long ldbt,
                       const void* xut, long long ldxu, const void* xit, long long ldxi,
                       int pieces, void* out_u, void* out_i, int ld_out, int n_u, int n_i,
                       int n, int chunks, void* stream) {
  const Args a{b, bt, xut, xit, ldb, ldbt, ldxu, ldxi, out_u, out_i, ld_out, n_u, n_i,
               chunks, static_cast<cudaStream_t>(stream)};
  if (ldxu < 2LL * ((n_u + BK - 1) / BK * BK) || ldxi < 2LL * ((n_i + BK - 1) / BK * BK)) {
    return -1;
  }
  if (pieces == 3) return n == 192 ? launch_float<192, 3>(a) : -1;
  if (pieces != 1) return -1;
  switch (n) {
    case 64: return launch_float<64, 1>(a);
    case 128: return launch_float<128, 1>(a);
    case 192: return launch_float<192, 1>(a);
    default: return -1;
  }
}

// x (n, d) f32 (x_is_f32 = 1) or bf16 with row pitch ld_x values; out
// (rows_out, n_pad) bf16 contiguous, n_pad a multiple of 128, rows_out the
// plan's operand width (pieces = 3: three rows a column of x, in groups of
// 64 columns). Returns cudaGetLastError().
int selfrec_float_operand(const void* x, int x_is_f32, long long ld_x, int n, int d,
                          int pieces, void* out, int rows_out, int n_pad, void* stream) {
  if (n_pad % BK || rows_out > 65535) return -1;
  const dim3 grid((n_pad / 8 + 255) / 256, rows_out);
  float_operand_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_is_f32, ld_x, n, d, pieces, static_cast<uint16_t*>(out), n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
