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
// int8 kernel, `dual_s8_kernel`.
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8 dense) at yelp2018 scale
// (U = 31,667, I = 38,048): one read of the 1.2 GB block is 0.36 ms, so
// D = 64 is bound by bytes; D = 192 does 4*U*I*D = 9.3e11 int8 operations,
// 0.47 ms, and is bound by operations.
// The trade. int8 `wgmma` takes both operands K-major from shared memory,
// and B is K-major for only one of the two products. So the block is kept
// twice, as B and as B^T (`DenseAdj.a_iu`, made once per block, in
// `refactor_view` too), and the kernel is two plain GEMMs in one launch:
// blocks [0, tiles_u) make out_u from B and xi^T, blocks [tiles_u, ...)
// make out_i from B^T and xu^T. It reads 2.4 GB a launch instead of 1.2 GB,
// a floor of 0.72 ms at 3.35 TB/s, above the 0.47 ms operation bound at
// D = 192. In exchange each block owns its output rows over the whole
// contraction: no atomics, no transposes in shared memory, one write of
// each output, and the operand is read as one K-major (D, n) tile a stage.
// Design:
// - 192 output rows a block: three consumer warpgroups of 64 rows each,
//   and one producer warp whose lane 0 keeps TMA loads in flight. Every
//   block reads the whole K-major operand from L2 (7.3 MB at D = 192), so
//   taller blocks cut that traffic: at 192 rows it is 2.4 GB a launch, as
//   much as the block's own bytes, and the 364 blocks fill 2.76 waves of
//   the 132 SMs.
// - A stage is the (192 rows x 128 bytes) tile of B or B^T and the
//   (D x 128 bytes) tile of xi^T or xu^T, both copied by TMA with the
//   128-byte swizzle that `wgmma` reads; 6 stages at D = 64, 4 at D = 192,
//   with full/empty mbarriers between producer and consumers.
// - Each stage is four `wgmma.m64nDk32.s32.s8.s8` a warpgroup, the sums
//   kept in registers for the whole contraction; a stage is released as
//   soon as the next one's products are issued.
// - Ragged edges: TMA fills rows and columns past U, I with zeros, which
//   add nothing, and the epilogue writes only rows below U or I. Row
//   pitches must be multiples of 16 bytes (the wrapper sees to it).
//
// float kernel, `dual_float_kernel`: a simple kernel that is right, for a
// variant that no model path runs. The same two-GEMM split over B and B^T;
// 128 output rows by 64 columns a block, 8 warps of `mma.sync.m16n8k16`
// bf16 with f32 sums. B tiles are widened from int8 to bf16 in shared
// memory (exact for 0/1 and every int8). bf16 operands are used as they
// are. f32 operands are split into three bf16 pieces, hi + mid + lo, which
// carry 24 bits of mantissa; each piece's products go into a sum of its
// own, and the three sums are added at the end: f32 accuracy without TF32.
//
// Plain C interface, loaded with ctypes (selfrec_tpu_torch/ops/dense_dual.py).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// int8: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int CONSUMER_WGS = 3;        // consumer warpgroups, 64 output rows each
constexpr int BM = 64 * CONSUMER_WGS;  // output rows a block
constexpr int BK = 128;                // contraction bytes a stage (one swizzle row)
constexpr int CONSUMER_THREADS = 128 * CONSUMER_WGS;
constexpr int S8_THREADS = CONSUMER_THREADS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK;

template <int D>
struct S8Cfg {
  static constexpr int X_BYTES = D * BK;
  static constexpr int STAGE = A_BYTES + X_BYTES;
  static constexpr int STAGES = (200 * 1024) / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(X_BYTES % 1024 == 0, "tiles must stay 1024-byte aligned");
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

// wgmma.m64nNk32 s8 x s8 -> s32, both operands from shared memory, the sums
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

template <int D>
__device__ __forceinline__ void wgmma_s8(int (&d)[D / 2], uint64_t da, uint64_t db) {
  if constexpr (D == 64) {
    wgmma_s8_n64(d, da, db);
  } else {
    static_assert(D == 192, "built for D = 64 and 192");
    wgmma_s8_n192(d, da, db);
  }
}

template <int D>
__global__ void __launch_bounds__(S8_THREADS, 1)
dual_s8_kernel(const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_bt,
               const __grid_constant__ CUtensorMap map_xit,
               const __grid_constant__ CUtensorMap map_xut, int* __restrict__ out_u,
               int* __restrict__ out_i, int n_u, int n_i, int tiles_u) {
  using Cfg = S8Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  const uint32_t bars = base + Cfg::STAGES * Cfg::STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (Cfg::STAGES + s); };

  const bool user_dir = static_cast<int>(blockIdx.x) < tiles_u;
  const int m0 = (user_dir ? blockIdx.x : blockIdx.x - tiles_u) * BM;
  const CUtensorMap* map_a = user_dir ? &map_b : &map_bt;
  const CUtensorMap* map_x = user_dir ? &map_xit : &map_xut;
  const int m_rows = user_dir ? n_u : n_i;
  const int nk = ((user_dir ? n_i : n_u) + BK - 1) / BK;
  int* __restrict__ out = user_dir ? out_u : out_i;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WGS);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {  // producer warp
    if (threadIdx.x == CONSUMER_THREADS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % Cfg::STAGES;
        if (kt >= Cfg::STAGES) mbar_wait(empty(s), ((kt / Cfg::STAGES) - 1) & 1);
        const uint32_t a_dst = base + s * Cfg::STAGE;
        mbar_expect_tx(full(s), Cfg::STAGE);
        tma_load_2d(a_dst, map_a, kt * BK, m0, full(s));
        tma_load_2d(a_dst + A_BYTES, map_x, kt * BK, 0, full(s));
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  int acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Cfg::STAGES;
    mbar_wait(full(s), (kt / Cfg::STAGES) & 1);
    const uint32_t a_tile = base + s * Cfg::STAGE + wg * 64 * BK;
    const uint32_t x_tile = base + s * Cfg::STAGE + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      wgmma_s8<D>(acc, desc_sw128(a_tile + 32 * kk), desc_sw128(x_tile + 32 * kk));
    }
    wgmma_commit();
    fence_regs(acc);
    // the previous stage's products are done once at most one group is open
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((kt - 1) % Cfg::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator layout of m64nN: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8); in each 8-column block j, columns 8j + 2(lane%4) + {0,1}
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < m_rows) {
      *reinterpret_cast<int2*>(out + static_cast<long long>(row) * D + 8 * j + col) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
    }
    if (row + 8 < m_rows) {
      *reinterpret_cast<int2*>(out + static_cast<long long>(row + 8) * D + 8 * j + col) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

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

// A (rows, cols) uint8 array with a row pitch of `pitch` bytes, read in
// boxes of box_rows x 128 bytes with the 128-byte swizzle; reads past the
// array's edges fill zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows,
              long long cols, long long pitch, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_s8(const void* b, long long ldb, const void* bt, long long ldbt, const void* xut,
              long long ldxu, const void* xit, long long ldxi, int* out_u, int* out_i, int n_u,
              int n_i, cudaStream_t stream) {
  using Cfg = S8Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap mb, mbt, mxi, mxu;
  if (!make_map(encode, &mb, b, n_u, n_i, ldb, BM) ||
      !make_map(encode, &mbt, bt, n_i, n_u, ldbt, BM) ||
      !make_map(encode, &mxi, xit, D, n_i, ldxi, D) ||
      !make_map(encode, &mxu, xut, D, n_u, ldxu, D)) {
    return -3;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      dual_s8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_u = (n_u + BM - 1) / BM;
  const int tiles_i = (n_i + BM - 1) / BM;
  dual_s8_kernel<D><<<tiles_u + tiles_i, S8_THREADS, Cfg::SMEM, stream>>>(
      mb, mbt, mxi, mxu, out_u, out_i, n_u, n_i, tiles_u);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 / f32 operands: mma.sync bf16
// ---------------------------------------------------------------------------

constexpr int FM = 128;                 // output rows a block (8 warps x 16)
constexpr int FN = 64;                  // output columns a block
constexpr int FK = 32;                  // contraction a step
constexpr int F_THREADS = 256;
constexpr int A_PITCH = FK * 2 + 16;    // bytes a row of the bf16 B tile (conflict-free ldmatrix)
constexpr int X_PITCH = FN * 2 + 16;    // bytes a row of an operand tile

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight operand values at p (row-major, 16-byte aligned) as PIECES packed
// bf16 rows of 16 bytes: the values themselves for bf16; hi, mid, lo with
// hi + mid + lo == v to f32 rounding for f32.
template <typename T, int PIECES>
__device__ __forceinline__ void load_pieces(const T* p, bool valid, uint4 (&out)[PIECES]);

template <>
__device__ __forceinline__ void load_pieces<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                              bool valid, uint4 (&out)[1]) {
  out[0] = valid ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

template <>
__device__ __forceinline__ void load_pieces<float, 3>(const float* p, bool valid,
                                                      uint4 (&out)[3]) {
  float v[8];
  if (valid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  }
  uint32_t w[3][4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    float r0 = v[e], r1 = v[e + 1];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(r0);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(r1);
      w[q][e / 2] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
      r0 -= __bfloat162float(h0);
      r1 -= __bfloat162float(h1);
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) out[q] = make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
}

template <typename T, int PIECES>
__global__ void __launch_bounds__(F_THREADS)
dual_float_kernel(const int8_t* __restrict__ b, long long ldb, const int8_t* __restrict__ bt,
                  long long ldbt, const T* __restrict__ xu, const T* __restrict__ xi,
                  float* __restrict__ out_u, float* __restrict__ out_i, int n_u, int n_i,
                  int d, int tiles_u) {
  __shared__ __align__(16) uint8_t sa[FM * A_PITCH];
  __shared__ __align__(16) uint8_t sx[PIECES][FK * X_PITCH];

  const bool user_dir = static_cast<int>(blockIdx.x) < tiles_u;
  const int m0 = (user_dir ? blockIdx.x : blockIdx.x - tiles_u) * FM;
  const int n0 = blockIdx.y * FN;
  const int8_t* __restrict__ a = user_dir ? b : bt;
  const long long lda = user_dir ? ldb : ldbt;
  const T* __restrict__ x = user_dir ? xi : xu;
  float* __restrict__ out = user_dir ? out_u : out_i;
  const int m_rows = user_dir ? n_u : n_i;
  const int k_len = user_dir ? n_i : n_u;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // loaders: B tile row tid/2, bytes 16*(tid%2); operand row tid/8, values 8*(tid%8)
  const int a_r = tid / 2, a_c = 16 * (tid % 2);
  const int x_r = tid / 8, x_c = 8 * (tid % 8);
  const long long a_row = m0 + a_r;

  // one sum per piece: added into one accumulator, the small pieces'
  // products would be cut at the large sum's last bit on every step
  float acc[PIECES][FN / 8][4];
#pragma unroll
  for (int q = 0; q < PIECES; ++q)
#pragma unroll
    for (int n = 0; n < FN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.f;

  for (int k0 = 0; k0 < k_len; k0 += FK) {
    // B tile: 16 int8 -> 16 bf16
    uint32_t wa[8];
    {
      int8_t v[16];
      const int kc = k0 + a_c;
      if (a_row < m_rows && kc + 16 <= k_len) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(a + a_row * lda + kc));
        *reinterpret_cast<int4*>(v) = q;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = (a_row < m_rows && kc + e < k_len) ? a[a_row * lda + kc + e] : 0;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) wa[e] = pack_bf16(static_cast<float>(v[2 * e]),
                                                   static_cast<float>(v[2 * e + 1]));
    }
    uint4 wx[PIECES];
    const int xk = k0 + x_r;
    load_pieces<T, PIECES>(x + static_cast<long long>(xk < k_len ? xk : 0) * d + n0 + x_c,
                           xk < k_len, wx);

    __syncthreads();  // the previous step's reads are done
    *reinterpret_cast<uint4*>(sa + a_r * A_PITCH + 2 * a_c) =
        make_uint4(wa[0], wa[1], wa[2], wa[3]);
    *reinterpret_cast<uint4*>(sa + a_r * A_PITCH + 2 * a_c + 16) =
        make_uint4(wa[4], wa[5], wa[6], wa[7]);
#pragma unroll
    for (int q = 0; q < PIECES; ++q)
      *reinterpret_cast<uint4*>(&sx[q][x_r * X_PITCH + 2 * x_c]) = wx[q];
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < FK / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, smem_u32(sa + (16 * warp + lane % 16) * A_PITCH +
                               2 * (16 * ks + 8 * (lane / 16))));
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
#pragma unroll
        for (int n = 0; n < FN / 8; n += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(&sx[q][(16 * ks + lane % 16) * X_PITCH +
                                                2 * (8 * n + 8 * (lane / 16))]));
          mma_bf16(acc[q][n], af, bf[0], bf[1]);
          mma_bf16(acc[q][n + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // the pieces' sums, smallest first
#pragma unroll
  for (int q = PIECES - 2; q >= 0; --q)
#pragma unroll
    for (int n = 0; n < FN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][n][e] += acc[q + 1][n][e];
  const int g = lane / 4, t = lane % 4;
  const long long row = m0 + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < FN / 8; ++n) {
    const int col = n0 + 8 * n + 2 * t;
    if (row < m_rows)
      *reinterpret_cast<float2*>(out + row * d + col) = make_float2(acc[0][n][0], acc[0][n][1]);
    if (row + 8 < m_rows)
      *reinterpret_cast<float2*>(out + (row + 8) * d + col) =
          make_float2(acc[0][n][2], acc[0][n][3]);
  }
}

template <typename T, int PIECES>
int launch_float(const int8_t* b, long long ldb, const int8_t* bt, long long ldbt, const T* xu,
                 const T* xi, float* out_u, float* out_i, int n_u, int n_i, int d,
                 cudaStream_t stream) {
  const int tiles_u = (n_u + FM - 1) / FM;
  const int tiles_i = (n_i + FM - 1) / FM;
  const dim3 grid(tiles_u + tiles_i, d / FN);
  dual_float_kernel<T, PIECES><<<grid, F_THREADS, 0, stream>>>(b, ldb, bt, ldbt, xu, xi, out_u,
                                                               out_i, n_u, n_i, d, tiles_u);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Widths the int8 kernel is built for; the wrapper checks D against it.
int selfrec_dual_s8_supports(int d) { return d == 64 || d == 192; }

// b (n_u, n_i) and bt (n_i, n_u) int8, the same block and its transpose;
// xut (d, n_u) and xit (d, n_i) int8, the operands transposed; each with a
// row pitch (ld*, bytes) that is a multiple of 16 and a 16-byte aligned
// base. out_u (n_u, d) and out_i (n_i, d) int32 contiguous, fully written.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success), -1 for an unsupported width, -2 when
// cuTensorMapEncodeTiled cannot be found, -3 when a tensor map is refused.
int selfrec_dual_s8(const void* b, long long ldb, const void* bt, long long ldbt,
                    const void* xut, long long ldxu, const void* xit, long long ldxi,
                    void* out_u, void* out_i, int n_u, int n_i, int d, void* stream) {
  auto* ou = static_cast<int*>(out_u);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_s8<64>(b, ldb, bt, ldbt, xut, ldxu, xit, ldxi, ou, oi, n_u, n_i, s);
    case 192: return launch_s8<192>(b, ldb, bt, ldbt, xut, ldxu, xit, ldxi, ou, oi, n_u, n_i, s);
    default: return -1;
  }
}

// b, bt as above (row pitches multiples of 16 bytes); xu (n_u, d), xi
// (n_i, d) contiguous bf16 (x_is_bf16 = 1) or f32, 16-byte aligned, d a
// multiple of 64; out_u (n_u, d), out_i (n_i, d) f32 contiguous, fully
// written. Returns as selfrec_dual_s8; -1 for a width it does not take.
int selfrec_dual_float(const void* b, long long ldb, const void* bt, long long ldbt,
                       const void* xu, const void* xi, int x_is_bf16, void* out_u,
                       void* out_i, int n_u, int n_i, int d, void* stream) {
  if (d <= 0 || d % FN != 0) return -1;
  const auto* pb = static_cast<const int8_t*>(b);
  const auto* pbt = static_cast<const int8_t*>(bt);
  auto* ou = static_cast<float*>(out_u);
  auto* oi = static_cast<float*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch_float<__nv_bfloat16, 1>(pb, ldb, pbt, ldbt,
                                          static_cast<const __nv_bfloat16*>(xu),
                                          static_cast<const __nv_bfloat16*>(xi), ou, oi, n_u,
                                          n_i, d, s);
  }
  return launch_float<float, 3>(pb, ldb, pbt, ldbt, static_cast<const float*>(xu),
                                static_cast<const float*>(xi), ou, oi, n_u, n_i, d, s);
}

}  // extern "C"
