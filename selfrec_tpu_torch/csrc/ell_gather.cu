// Weighted ELL gather plus sorted segment-sum, f32 or bf16 rows in, f32
// out, for Hopper (sm_90a). Kernel K2 of the port.
//
// Replaces: selfrec_tpu/ops/spmm_pallas.py:62-142 (Pallas `_spmm_kernel`,
// `_pallas_partial`, `PallasEll.apply`), the function that the JAX
// package's ELL path computes with an XLA gather, an einsum and a
// segment_sum (selfrec_tpu/ops/spmm_ell.py:133-189, 286-297). For P passes
// of width D over one row-split ELL layout (V virtual rows of K slots):
//
//   out[r, p*D + d] = sum over the virtual rows v of r, in order, and
//                     k < K of  w[p, v, k] * x[vidx[v, k], p*D + d]
//
// Pad slots point at row 0 with weight 0; rows that own no virtual row come
// out zero. Sums are f32; bf16 rows are widened exactly before the multiply.
//
// Bound on an H100 SXM (3.35 TB/s): the compulsory bytes (vidx, w, x, the
// row metadata, out, each once) at yelp2018 scale and P = 3, D = 64 are
// about 0.16 GB, 0.05 ms; 2*V*K*P*D f32 operations take less. The gathers
// themselves move V*K rows of P*D values (2.6 GB at that shape), most of
// them from L2: the degree skew concentrates them on the popular rows.
//
// Design. The layout's rows are classified once, on the host, when it is
// built (spmm_ell.py `row_work`): a row that owns at most 8 virtual rows is
// one work item, and a longer row is cut into items of 8 virtual rows. The
// items tile [0, V) in order, so an item is a contiguous run of K-slots.
// - Pass one gives each item a group of lanes across its P*D columns (4
//   columns a lane, 16-byte f32 or 8-byte bf16 loads, neighbouring lanes on
//   neighbouring addresses) that walks the item's slots in order with 8
//   gathers in flight per lane. A short row's item writes its output row
//   directly: 95% of the rows of the yelp2018 graph never touch a partial.
//   A long row's item writes one f32 partial row.
// - Pass two, only over the long rows, adds each row's partials in order.
//   No item holds more than 8 virtual rows, so neither pass waits on the
//   1,093-virtual-row row of the skewed graph, and the partial buffer is a
//   few MB instead of a (V, P*D) round trip.
// - Deterministic: no atomics; every sum runs in a fixed order, so repeated
//   runs give identical bits.
// - The partial buffer is scratch that the caller allocates once per layout.
//
// Plain C interface, loaded with ctypes (selfrec_tpu_torch/ops/ell_gather.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float4 load4(const float* x, long long i4) {
  return __ldg(reinterpret_cast<const float4*>(x) + i4);
}

// four bf16 values (8 bytes); a bf16 is the upper half of an f32, and the
// lower address sits in the lower half of each 32-bit word
__device__ __forceinline__ float4 load4(const uint16_t* x, long long i4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(x) + i4);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Pass one: block (bx, by) = by work items, bx lanes across c4 = P*D/4
// column groups each. w is (P, V, K), so pass p's weights of a slot s sit
// at p*V*K + s; the lane's pass is its column / D.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ell_items_kernel(const int* __restrict__ vidx, const float* __restrict__ w,
                 const T* __restrict__ x, const int* __restrict__ item_ptr,
                 const int* __restrict__ item_dst, float* __restrict__ out,
                 float* __restrict__ partial, int n_items, int n_vrows, int k,
                 int c4, int d4) {
  const int item = blockIdx.x * blockDim.y + threadIdx.y;
  if (item >= n_items) return;
  const long long s_begin = static_cast<long long>(__ldg(item_ptr + item)) * k;
  const long long s_end = static_cast<long long>(__ldg(item_ptr + item + 1)) * k;
  const int dst = __ldg(item_dst + item);
  float4* o = reinterpret_cast<float4*>(dst >= 0 ? out : partial) +
              static_cast<long long>(dst >= 0 ? dst : ~dst) * c4;
  const long long pass_stride = static_cast<long long>(n_vrows) * k;
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    const float* wp = w + (c / d4) * pass_stride;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    long long s = s_begin;
    for (; s + UNROLL <= s_end; s += UNROLL) {
      float ws[UNROLL];
      float4 xs[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ws[u] = __ldg(wp + s + u);
        xs[u] = load4(x, static_cast<long long>(__ldg(vidx + s + u)) * c4 + c);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma4(acc, ws[u], xs[u]);
    }
    for (; s < s_end; ++s) {
      fma4(acc, __ldg(wp + s), load4(x, static_cast<long long>(__ldg(vidx + s)) * c4 + c));
    }
    o[c] = acc;
  }
}

// Pass two: block (bx, by) = by long rows; each lane adds its column group
// over the row's partial slots in order.
__global__ void __launch_bounds__(THREADS)
ell_long_rows_kernel(const float* __restrict__ partial, const int* __restrict__ long_rows,
                     const int* __restrict__ long_ptr, float* __restrict__ out,
                     int n_long, int c4) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n_long) return;
  const int begin = __ldg(long_ptr + r);
  const int end = __ldg(long_ptr + r + 1);
  const float4* p = reinterpret_cast<const float4*>(partial);
  float4* o = reinterpret_cast<float4*>(out) + static_cast<long long>(__ldg(long_rows + r)) * c4;
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = begin;
    for (; s + UNROLL <= end; s += UNROLL) {
      float4 ps[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) ps[u] = __ldg(p + static_cast<long long>(s + u) * c4 + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) add4(acc, ps[u]);
    }
    for (; s < end; ++s) add4(acc, __ldg(p + static_cast<long long>(s) * c4 + c));
    o[c] = acc;
  }
}

template <typename T>
int launch(const int* vidx, const float* w, const T* x, const int* item_ptr,
           const int* item_dst, const int* long_rows, const int* long_ptr,
           float* partial, float* out, int n_vrows, int k, int n_items, int n_long,
           int c4, int d4, cudaStream_t stream) {
  const int bx = c4 < THREADS ? c4 : THREADS;
  const dim3 block(bx, THREADS / bx);
  if (n_items > 0) {
    const dim3 grid((n_items + block.y - 1) / block.y);
    ell_items_kernel<T><<<grid, block, 0, stream>>>(vidx, w, x, item_ptr, item_dst, out,
                                                    partial, n_items, n_vrows, k, c4, d4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_long > 0) {
    const dim3 grid((n_long + block.y - 1) / block.y);
    ell_long_rows_kernel<<<grid, block, 0, stream>>>(partial, long_rows, long_ptr, out,
                                                     n_long, c4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vidx (n_vrows * k) int32, every entry < rows of x; w (n_passes, n_vrows, k)
// f32; x (rows, n_passes * d) f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1),
// contiguous and 16-byte (f32) or 8-byte (bf16) aligned; item_ptr
// (n_items + 1) int32, non-decreasing from 0 to n_vrows; item_dst (n_items)
// int32, an output row or ~slot; long_rows (n_long) and long_ptr (n_long + 1)
// int32 over the slots; partial (slots, n_passes * d) f32 scratch; out
// (rows, n_passes * d) f32, fully written (every row is the destination of
// one item or one long row). Launches both passes on `stream` without
// synchronising and returns cudaGetLastError() (0 on success), or -1 for
// arguments the kernel does not take.
int selfrec_ell_gather_sum(const void* vidx, const void* w, const void* x,
                           int x_is_bf16, const void* item_ptr, const void* item_dst,
                           const void* long_rows, const void* long_ptr, void* partial,
                           void* out, int n_vrows, int k, int n_items, int n_long,
                           int n_passes, int d, void* stream) {
  if (k < 1 || n_passes < 1 || d < 4 || d % 4 != 0 || n_vrows < 0 || n_items < 0 ||
      n_long < 0) {
    return -1;
  }
  const int c4 = n_passes * (d / 4);
  const auto* pv = static_cast<const int*>(vidx);
  const auto* pw = static_cast<const float*>(w);
  const auto* pip = static_cast<const int*>(item_ptr);
  const auto* pid = static_cast<const int*>(item_dst);
  const auto* plr = static_cast<const int*>(long_rows);
  const auto* plp = static_cast<const int*>(long_ptr);
  auto* pp = static_cast<float*>(partial);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch(pv, pw, static_cast<const uint16_t*>(x), pip, pid, plr, plp, pp, po,
                  n_vrows, k, n_items, n_long, c4, d / 4, s);
  }
  return launch(pv, pw, static_cast<const float*>(x), pip, pid, plr, plp, pp, po, n_vrows,
                k, n_items, n_long, c4, d / 4, s);
}

}  // extern "C"
