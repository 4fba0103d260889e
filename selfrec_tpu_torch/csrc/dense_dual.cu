// Dual-direction dense bipartite propagation, int8 x int8 -> int32, for
// Hopper (sm_90a). Kernel K1 of the port.
//
// Replaces: selfrec_tpu/ops/dense_dual.py:122-235 (Pallas `_dual_kernel`,
// `_dual_call`, `dual_matmul`), int8 variant. Computes
//
//     out_u = B @ xi      (U, I) x (I, D) -> (U, D) int32
//     out_i = B^T @ xu    (I, U) x (U, D) -> (I, D) int32
//
// with B the (U, I) 0/1 int8 incidence and xu, xi per-channel-quantized
// int8 operands. Sums are exact: |products| <= 127 and the row counts are far
// below 2^31 / 127.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8 dense) at yelp2018 scale
// (U = 31,668, I = 38,048): one read of the 1.2 GB block is 0.36 ms, so
// D = 64 is bound by bytes; D = 192 does 4*U*I*D = 9.3e11 int8 operations,
// 0.47 ms, and is bound by operations.
//
// Design:
// - Each block owns a stripe of TU = 128 rows of B and walks a range of
//   TI = 128-column tiles. Every B tile is read from device memory ONCE, kept
//   in shared memory both as loaded and transposed, and feeds both products
//   (what the TPU kernel does with one VMEM tile).
// - out_u for the stripe accumulates in registers across the whole walk and
//   is added to device memory once at the end. The TPU kernel carried out_i
//   across U-chunks through HBM aliasing; Hopper blocks run in no order, so
//   each tile's out_i partial is added with int32 atomics, which are exact
//   in any order. Zero partials are skipped: B is very sparse, so most
//   partials of a tile are zero.
// - Products use mma.sync m16n8k32 s8.s8.s32 with ldmatrix fragment loads.
//   Shared-memory rows are 128 bytes with the 16-byte chunk index XORed by
//   (row ^ row >> 2) & 7, which keeps both the ldmatrix reads and the
//   transposed 4x4-byte stores free of bank conflicts.
// - Global loads for tile k+1 are issued into registers before tile k is
//   computed, so their latency hides behind the tensor work.
// - Ragged edges are masked in the kernel: rows or columns past U, I read as
//   zero and are never written. There is no padding of the operands.
//
// Plain C interface, loaded with ctypes (selfrec_tpu_torch/ops/dense_dual.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TU = 128;      // B rows per block (user direction)
constexpr int TI = 128;      // B columns per loop step (item direction)
constexpr int THREADS = 256; // 8 warps
constexpr int ROWB = 128;    // bytes per shared-memory row, every buffer

__device__ __forceinline__ int swz(int row, int byte) {
  const int chunk = ((byte >> 4) ^ (row ^ (row >> 2))) & 7;
  return row * ROWB + (chunk << 4) + (byte & 15);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const uint8_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: w[k] holds row k (byte j = column j); t[j] gets
// column j (byte k = row k).
__device__ __forceinline__ void transpose4x4(const uint32_t w[4], uint32_t t[4]) {
  const uint32_t m0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t m1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t m2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t m3 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(m0, m1, 0x5410);
  t[1] = __byte_perm(m0, m1, 0x7632);
  t[2] = __byte_perm(m2, m3, 0x5410);
  t[3] = __byte_perm(m2, m3, 0x7632);
}

// Four bytes of row `row` starting at column `col`; zero past the edges.
// ALIGNED: the row pitch and base allow 4-byte loads. STREAM: the data is
// read once (the block), so it is loaded with the evict-first hint.
template <bool ALIGNED, bool STREAM>
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ base,
                                              long long row, int col,
                                              long long n_rows, int n_cols,
                                              long long ld) {
  if (row >= n_rows || col >= n_cols) return 0u;
  const int8_t* q = base + row * ld + col;
  if (ALIGNED && col + 3 < n_cols) {
    const unsigned int* p = reinterpret_cast<const unsigned int*>(q);
    return STREAM ? __ldcs(p) : __ldg(p);
  }
  uint32_t w = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (col + k < n_cols) w |= static_cast<uint32_t>(static_cast<uint8_t>(q[k])) << (8 * k);
  return w;
}

// A warp covers 4 row-blocks x 8 column-blocks of 4x4 bytes per step: the
// global loads fill whole 32-byte sectors and the transposed stores land in
// 32 distinct banks.
template <int NC>  // column blocks (of 4 bytes) in the region
__device__ __forceinline__ void block_of(int q, int lane, int& br, int& bc) {
  constexpr int WC = NC / 8;
  br = 4 * (q / WC) + (lane >> 3);
  bc = 8 * (q % WC) + (lane & 7);
}

template <int D, bool B_ALIGNED>
__global__ void __launch_bounds__(THREADS, (D <= 64 ? 2 : 1))
dual_s8_kernel(const int8_t* __restrict__ b, const int8_t* __restrict__ xu,
               const int8_t* __restrict__ xi, int* __restrict__ out_u,
               int* __restrict__ out_i, int n_u, int n_i, long long ldb,
               int tiles_per_split) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int NT = D / 8;                         // n8 tiles across D
  constexpr int B_STEPS = (TU / 16) * (TI / 32) / 8;  // warp steps per B tile
  constexpr int X_STEPS = (TI / 16) * (D / 32) / 8;   // warp steps per xi tile
  constexpr int U_STEPS = (TU / 16) * (D / 32) / 8;   // warp steps for xu

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sB = smem;                 // [TU][TI]  B tile as loaded
  uint8_t* sBT = sB + TU * ROWB;      // [TI][TU]  B tile transposed
  uint8_t* sXiT = sBT + TI * ROWB;    // [D][TI]   xi tile transposed
  uint8_t* sXuT = sXiT + D * ROWB;    // [D][TU]   xu stripe transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long u0 = static_cast<long long>(blockIdx.x) * TU;
  const int n_tiles = (n_i + TI - 1) / TI;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  if (tile_begin >= tile_end) return;

  // xu stripe -> sXuT, once per block
#pragma unroll
  for (int s = 0; s < U_STEPS; ++s) {
    int br, bc;
    block_of<D / 4>(warp + 8 * s, lane, br, bc);
    uint32_t w[4], tr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = load_word<true, false>(xu, u0 + 4 * br + k, 4 * bc, n_u, D, D);
    transpose4x4(w, tr);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint32_t*>(sXuT + swz(4 * bc + k, 4 * br)) = tr[k];
  }

  uint32_t rb[B_STEPS][4];
  uint32_t rx[X_STEPS][4];

  auto load_tile = [&](int tile) {
    const int i0 = tile * TI;
#pragma unroll
    for (int s = 0; s < B_STEPS; ++s) {
      int br, bc;
      block_of<TI / 4>(warp + 8 * s, lane, br, bc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rb[s][k] = load_word<B_ALIGNED, true>(b, u0 + 4 * br + k, i0 + 4 * bc,
                                              n_u, n_i, ldb);
    }
#pragma unroll
    for (int s = 0; s < X_STEPS; ++s) {
      int br, bc;
      block_of<D / 4>(warp + 8 * s, lane, br, bc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rx[s][k] = load_word<true, false>(xi, static_cast<long long>(i0) + 4 * br + k,
                                          4 * bc, n_i, D, D);
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int s = 0; s < B_STEPS; ++s) {
      int br, bc;
      block_of<TI / 4>(warp + 8 * s, lane, br, bc);
      uint32_t tr[4];
      transpose4x4(rb[s], tr);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        *reinterpret_cast<uint32_t*>(sB + swz(4 * br + k, 4 * bc)) = rb[s][k];
        *reinterpret_cast<uint32_t*>(sBT + swz(4 * bc + k, 4 * br)) = tr[k];
      }
    }
#pragma unroll
    for (int s = 0; s < X_STEPS; ++s) {
      int br, bc;
      block_of<D / 4>(warp + 8 * s, lane, br, bc);
      uint32_t tr[4];
      transpose4x4(rx[s], tr);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<uint32_t*>(sXiT + swz(4 * bc + k, 4 * br)) = tr[k];
    }
  };

  int acc_u[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_u[n][k] = 0;

  // ldmatrix lane roles: A fragments take rows (l & 7) + 8 * bit3 and the
  // 16-byte half bit4; B fragments take n-tile bit4 and the half bit3
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_half = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_half = 16 * ((lane >> 3) & 1);

  load_tile(tile_begin);
  store_tile();
  __syncthreads();

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    if (tile + 1 < tile_end) load_tile(tile + 1);

    // user direction: rows 16*warp of the stripe, K = the tile's TI columns
#pragma unroll
    for (int ks = 0; ks < TI / 32; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sB + swz(16 * warp + a_row, 32 * ks + a_half));
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t f[4];
        ldmatrix_x4(f, sXiT + swz(8 * n + b_row, 32 * ks + b_half));
        mma_s8(acc_u[n], a, f[0], f[1]);
        mma_s8(acc_u[n + 1], a, f[2], f[3]);
      }
    }

    // item direction: rows 16*warp of the transposed tile, K = the stripe's
    // TU rows; D in chunks of 64 columns to bound the registers
    uint32_t at[TU / 32][4];
#pragma unroll
    for (int ks = 0; ks < TU / 32; ++ks)
      ldmatrix_x4(at[ks], sBT + swz(16 * warp + a_row, 32 * ks + a_half));
    const long long row0 = static_cast<long long>(tile) * TI + 16 * warp + g;
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += 8) {
      int acc_i[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc_i[n][k] = 0;
#pragma unroll
      for (int ks = 0; ks < TU / 32; ++ks) {
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t f[4];
          ldmatrix_x4(f, sXuT + swz(8 * (c0 + n) + b_row, 32 * ks + b_half));
          mma_s8(acc_i[n], at[ks], f[0], f[1]);
          mma_s8(acc_i[n + 1], at[ks], f[2], f[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * (c0 + n) + 2 * t;
        if (row0 < n_i) {
          int* o = out_i + row0 * D + col;
          if (acc_i[n][0]) atomicAdd(o, acc_i[n][0]);
          if (acc_i[n][1]) atomicAdd(o + 1, acc_i[n][1]);
        }
        if (row0 + 8 < n_i) {
          int* o = out_i + (row0 + 8) * D + col;
          if (acc_i[n][2]) atomicAdd(o, acc_i[n][2]);
          if (acc_i[n][3]) atomicAdd(o + 1, acc_i[n][3]);
        }
      }
    }

    __syncthreads();
    if (tile + 1 < tile_end) store_tile();
    __syncthreads();
  }

  const long long urow = u0 + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (urow < n_u) {
      int* o = out_u + urow * D + col;
      if (acc_u[n][0]) atomicAdd(o, acc_u[n][0]);
      if (acc_u[n][1]) atomicAdd(o + 1, acc_u[n][1]);
    }
    if (urow + 8 < n_u) {
      int* o = out_u + (urow + 8) * D + col;
      if (acc_u[n][2]) atomicAdd(o, acc_u[n][2]);
      if (acc_u[n][3]) atomicAdd(o + 1, acc_u[n][3]);
    }
  }
}

template <int D, bool B_ALIGNED>
int launch(const int8_t* b, const int8_t* xu, const int8_t* xi, int* out_u,
           int* out_i, int n_u, int n_i, long long ldb, int n_sm,
           cudaStream_t stream) {
  const int smem = (TU + TI + 2 * D) * ROWB;
  auto kernel = dual_s8_kernel<D, B_ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_x = (n_u + TU - 1) / TU;
  const int n_tiles = (n_i + TI - 1) / TI;
  // split the item range so that about two waves of blocks fill the card
  const int per_sm = D <= 64 ? 2 : 1;
  int splits = (2 * n_sm * per_sm + blocks_x - 1) / blocks_x;
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  dim3 grid(blocks_x, splits);
  kernel<<<grid, THREADS, smem, stream>>>(b, xu, xi, out_u, out_i, n_u, n_i,
                                          ldb, tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const int8_t* b, const int8_t* xu, const int8_t* xi, int* out_u,
             int* out_i, int n_u, int n_i, long long ldb, int n_sm,
             cudaStream_t stream) {
  const bool aligned =
      ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  return aligned
             ? launch<D, true>(b, xu, xi, out_u, out_i, n_u, n_i, ldb, n_sm, stream)
             : launch<D, false>(b, xu, xi, out_u, out_i, n_u, n_i, ldb, n_sm, stream);
}

}  // namespace

extern "C" {

// Widths the kernel is built for; the wrapper checks D against it.
int selfrec_dual_s8_supports(int d) { return d == 64 || d == 192; }

// out_u (n_u, d) and out_i (n_i, d) int32 must be zero-filled by the caller;
// xu (n_u, d), xi (n_i, d) int8 contiguous; b (n_u, n_i) int8 with row pitch
// ldb bytes. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or -1 for an unsupported width.
int selfrec_dual_s8(const void* b, const void* xu, const void* xi, void* out_u,
                    void* out_i, int n_u, int n_i, int d, long long ldb,
                    int n_sm, void* stream) {
  const auto* pb = static_cast<const int8_t*>(b);
  const auto* pu = static_cast<const int8_t*>(xu);
  const auto* pi = static_cast<const int8_t*>(xi);
  auto* ou = static_cast<int*>(out_u);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_d<64>(pb, pu, pi, ou, oi, n_u, n_i, ldb, n_sm, s);
    case 192: return launch_d<192>(pb, pu, pi, ou, oi, n_u, n_i, ldb, n_sm, s);
    default: return -1;
  }
}

}  // extern "C"
