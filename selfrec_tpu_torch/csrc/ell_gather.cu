// Weighted ELL gather plus sorted segment-sum, f32 or bf16 rows in, f32
// out, for Hopper (sm_90a). Kernel K2 of the port.
//
// Replaces: selfrec_tpu/ops/spmm_pallas.py:62-142 (Pallas `_spmm_kernel`,
// `_pallas_partial`, `PallasEll.apply`), the function that the JAX
// package's ELL path computes with an XLA gather, an einsum and a
// segment_sum (selfrec_tpu/ops/spmm_ell.py:133-189, 286-297). For P passes
// of width D over one row-split ELL layout (V virtual rows of K slots):
//
//   partial[v, p*D + d] = sum_k w[p, v, k] * x[vidx[v, k], p*D + d]
//   out[r, :]           = sum_{v = row_ptr[r]}^{row_ptr[r+1]-1} partial[v, :]
//
// Pad slots point at row 0 with weight 0; rows that own no virtual row come
// out zero. Sums are f32; bf16 rows are widened exactly before the multiply.
//
// Bound on an H100 SXM (3.35 TB/s): the compulsory bytes (vidx, w, x,
// row_ptr, out, each once) at yelp2018 scale and P = 3, D = 64 are about
// 0.16 GB, 0.05 ms; 2*V*K*P*D f32 operations take less. The gathers
// themselves move V*K rows of P*D values, 2.6 GB at that shape: x (54 MB
// at width 192) no longer fits the 50 MB L2, so most of them go to HBM.
//
// Design:
// - Two phases, as the TPU kernel split them, so that the degree skew costs
//   nothing in phase one: one destination can own over a thousand virtual
//   rows while most own one or two. Phase one gives each virtual row a
//   group of lanes across its P*D columns (4 columns a lane, 16-byte f32 or
//   8-byte bf16 loads, neighbouring lanes on neighbouring addresses) and
//   writes one f32 partial row. Phase two gives each destination row a lane
//   group that sums its contiguous run of partials in order.
// - Gathers are issued UNROLL at a time before any of them is used, so that
//   each lane keeps several row loads in flight.
// - Deterministic: no atomics; every sum runs in a fixed order, so repeated
//   runs give identical bits.
// - The partial buffer (V, P*D) f32 is scratch allocated by the caller.
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

// Phase one: block (bx, by) = by virtual rows, bx lanes across c4 = P*D/4
// column groups each. w is (P, V, K); the lane's pass is its column / D.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ell_gather_kernel(const int* __restrict__ vidx, const float* __restrict__ w,
                  const T* __restrict__ x, float* __restrict__ partial,
                  int n_vrows, int k, int c4, int d4) {
  const int v = blockIdx.x * blockDim.y + threadIdx.y;
  if (v >= n_vrows) return;
  const int* idx = vidx + static_cast<long long>(v) * k;
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    const float* wv = w + (static_cast<long long>(c / d4) * n_vrows + v) * k;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = 0;
    for (; s + UNROLL <= k; s += UNROLL) {
      float ws[UNROLL];
      float4 xs[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ws[u] = __ldg(wv + s + u);
        xs[u] = load4(x, static_cast<long long>(__ldg(idx + s + u)) * c4 + c);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma4(acc, ws[u], xs[u]);
    }
    for (; s < k; ++s) {
      fma4(acc, __ldg(wv + s),
           load4(x, static_cast<long long>(__ldg(idx + s)) * c4 + c));
    }
    reinterpret_cast<float4*>(partial)[static_cast<long long>(v) * c4 + c] = acc;
  }
}

// Phase two: block (bx, by) = by destination rows; each lane sums its column
// group over the row's virtual rows in order.
__global__ void __launch_bounds__(THREADS)
ell_segsum_kernel(const float* __restrict__ partial, const int* __restrict__ row_ptr,
                  float* __restrict__ out, int n_rows, int c4) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  const int begin = __ldg(row_ptr + r);
  const int end = __ldg(row_ptr + r + 1);
  const float4* p = reinterpret_cast<const float4*>(partial);
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int v = begin;
    for (; v + UNROLL <= end; v += UNROLL) {
      float4 ps[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ps[u] = __ldg(p + static_cast<long long>(v + u) * c4 + c);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) add4(acc, ps[u]);
    }
    for (; v < end; ++v) add4(acc, __ldg(p + static_cast<long long>(v) * c4 + c));
    reinterpret_cast<float4*>(out)[static_cast<long long>(r) * c4 + c] = acc;
  }
}

template <typename T>
int launch(const int* vidx, const float* w, const T* x, const int* row_ptr,
           float* partial, float* out, int n_vrows, int k, int n_rows, int c4,
           int d4, cudaStream_t stream) {
  const int bx = c4 < THREADS ? c4 : THREADS;
  const dim3 block(bx, THREADS / bx);
  if (n_vrows > 0) {
    const dim3 grid((n_vrows + block.y - 1) / block.y);
    ell_gather_kernel<T><<<grid, block, 0, stream>>>(vidx, w, x, partial,
                                                     n_vrows, k, c4, d4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows > 0) {
    const dim3 grid((n_rows + block.y - 1) / block.y);
    ell_segsum_kernel<<<grid, block, 0, stream>>>(partial, row_ptr, out, n_rows,
                                                  c4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vidx (n_vrows * k) int32, every entry < rows of x; w (n_passes, n_vrows, k)
// f32; x (rows, n_passes * d) f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1),
// contiguous and 16-byte (f32) or 8-byte (bf16) aligned; row_ptr (n_rows + 1)
// int32, non-decreasing from 0 to n_vrows; partial (n_vrows, n_passes * d)
// f32 scratch; out (n_rows, n_passes * d) f32, fully written. Launches both
// phases on `stream` without synchronising and returns cudaGetLastError()
// (0 on success), or -1 for arguments the kernel does not take.
int selfrec_ell_gather_sum(const void* vidx, const void* w, const void* x,
                           int x_is_bf16, const void* row_ptr, void* partial,
                           void* out, int n_vrows, int k, int n_rows,
                           int n_passes, int d, void* stream) {
  if (k < 1 || n_passes < 1 || d < 4 || d % 4 != 0 || n_vrows < 0 || n_rows < 0) {
    return -1;
  }
  const int c4 = n_passes * (d / 4);
  const auto* pv = static_cast<const int*>(vidx);
  const auto* pw = static_cast<const float*>(w);
  const auto* pr = static_cast<const int*>(row_ptr);
  auto* pp = static_cast<float*>(partial);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch(pv, pw, static_cast<const uint16_t*>(x), pr, pp, po, n_vrows, k,
                  n_rows, c4, d / 4, s);
  }
  return launch(pv, pw, static_cast<const float*>(x), pr, pp, po, n_vrows, k,
                n_rows, c4, d / 4, s);
}

}  // extern "C"
