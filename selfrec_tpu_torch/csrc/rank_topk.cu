// Full-catalog masked top-k of the eval, f32 scores on the CUDA cores, for
// Hopper (sm_90a): the eval ranking's two kernels.
//
// Replaces no TPU kernel. The JAX package ranks with an XLA dot, a select
// against the resident rated incidence and lax.top_k
// (selfrec_tpu/ops/ranking.py `_topk_all_blocks_dense`); the port ran the
// same three library calls per block of 1,024 users, writing and re-reading
// the whole (users, items) f32 score matrix. Here the score matrix never
// leaves the chip:
//
//   rank_partial: out[u, s, :] = the best k keys of slice s of the catalog
//                 for test user u, descending
//   rank_merge:   scores[u, :], ids[u, :] = the best k of out[u, :, :]
//
// A user's score of item i is sum over d of ut[d, u] * it[d, i] in f32 FMAs
// (no TF32, no bf16 pieces), set to exactly MASK_VALUE (-1e9) where
// rated[uids[u], i] != 0. A (value, item) pair is ranked by one int64 key:
// the value's bits mapped to a signed integer of the same total order (-0.0
// below +0.0) in the high word, the complement of the item id in the low
// word. Keys are distinct, so "descending key" is lax.top_k's order: value
// descending, ties by the lowest id (ops/rank_topk.py `sort_keys`).
//
// Bound on an H100 SXM at the eval of yelp2018 (31,667 test users, 38,048
// items, D 64, k 20): 2 * 31,667 * 38,048 * 64 = 154.2 GFLOP of f32 FMA at
// 67 TFLOP/s is 2.30 ms; the compulsory bytes (the two embedding tables,
// the rated bytes of the candidates, the candidates and the answer) take
// under 0.02 ms at 3.35 TB/s. So rank_partial is an FMA kernel.
//
// Design of rank_partial. A CTA takes BM = 128 test users and one slice of
// whole BN = 128-item tiles of the catalog, tile by tile:
// - scores: its 256 threads each own an 8 x 8 register tile (rows
//   ty*4+{0..3} and 64+ty*4+{0..3}, columns tx*4+{0..3} and 64+tx*4+{0..3});
//   the contraction runs in chunks of BK = 16 through a 4-stage cp.async
//   ring that holds a chunk of users and a chunk of items, both D-major
//   (the wrapper hands the tables transposed and zero-padded, so any D
//   takes the kernel in the same shared memory). The ring is exactly one
//   tile of f32 scores, and takes them when the tile's products are done;
// - selection: warp w takes rows 16w .. 16w + 15 of the tile, a lane four
//   items. A quick pass tests every score against its row's current k-th
//   value; only rows where one reaches it go on. There a winner is appended
//   to the row's 16-slot candidate buffer as a raw key (ballots give the
//   slots); a full buffer is merged into the row's sorted list at once by
//   the warp (ranks by counting: unique keys make every rank exact), which
//   raises the row's k-th value and key, and what did not fit is tested
//   again. The merge reads each candidate's rated byte (the incidence is
//   read only there, never row by row) and sets a rated item to exactly
//   MASK_VALUE. A row's k-th value at or below MASK_VALUE admits every
//   score, so a rated item is never lost to the prefilter, and a user with
//   fewer than k unrated items gets the rated ones at MASK_VALUE, lowest id
//   first;
// - a slice's first tile first sets each row's k-th value to a floor: the
//   k-th largest of the tile's 128 values, rated items at MASK_VALUE (each
//   counted against the warp's 128), so it adds about k candidates, not 128.
// Past the first tiles a row gains a few candidates in a tile, so the quick
// pass is most of the selection. Each slice pays its first tiles again, so
// the wrapper takes as few slices as fill the card's resident CTAs once.
// The lists (k keys a row) stay in shared memory for the whole slice and are
// written once, (n, slices, k) keys, padded with NO_KEY. 64 KB of ring,
// 16 KB of candidates and k KB of lists: two CTAs an SM at k 20.
//
// rank_merge: one warp a user; lane s holds the head of slice s's sorted
// list, and k rounds of a warp max over the heads pop the answer in order.
// It reads 8 * slices * k bytes a user. Given the test users' ground truth
// (a CSR, items sorted within each user), its epilogue tests the answer:
// lane l keeps the ids of places l, l + 32, ... (at most K_MAX / 32) and
// binary-searches each in the user's slice, so hits[u, q] is 1 exactly where
// id q is a ground-truth item of user u. The host then reads n * k bytes of
// answers in place of building n * k keys and searching them itself.
//
// Plain C interface, loaded with ctypes (selfrec_tpu_torch/ops/rank_topk.py).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char s_dyn[];  // rank_partial's ring and lists

namespace {

constexpr int BM = 128;       // test users a CTA
constexpr int BN = 128;       // items a tile
constexpr int BK = 16;        // contraction indices a ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // 16 x 16 threads of 8 x 8 scores
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int CAND = 16;      // candidate slots a row
constexpr int K_MAX = 128;
constexpr int MERGE_WARPS = 8;
constexpr float MASK_VALUE = -1e9f;
constexpr long long NO_KEY = LLONG_MIN;  // below every key of a real item
constexpr int RING_BYTES = sizeof(float) * STAGES * BK * (BM + BN);
static_assert(RING_BYTES == sizeof(float) * BM * BN, "the ring holds one tile of scores");

__device__ __forceinline__ long long make_key(float v, unsigned id) {
  const int bits = __float_as_int(v);
  const unsigned ord = static_cast<unsigned>(bits < 0 ? bits ^ 0x7FFFFFFF : bits);
  return static_cast<long long>((static_cast<unsigned long long>(ord) << 32) |
                                (0xFFFFFFFFu - id));
}

__device__ __forceinline__ float key_value(long long key) {
  const int ord = static_cast<int>(key >> 32);
  return __int_as_float(ord < 0 ? ord ^ 0x7FFFFFFF : ord);
}

__device__ __forceinline__ long long key_id(long long key) {
  return static_cast<long long>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFll));
}

// the value a score must reach to be looked at: the row's k-th value, or
// -inf while that is at or below the mask value (a rated item then enters
// at MASK_VALUE whatever its score) or the row is not full
__device__ __forceinline__ float prefilter(float kth) {
  return kth <= MASK_VALUE ? -INFINITY : kth;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// Per-row state of the CTA's users in static shared memory (20 KB); the ring
// (which holds the tile's scores during the selection) and the lists (k
// keys a row, descending) in dynamic shared memory.
__shared__ long long s_cand[BM][CAND];  // candidates since the row's last merge
__shared__ long long s_thr_key[BM];     // the k-th key, NO_KEY while the row is not full
__shared__ long long s_mask_off[BM];    // the user's offset into rated, -1 for a padded row
__shared__ float s_thr_f[BM];           // the k-th value; before the row is full -inf or a floor
__shared__ int s_list_cnt[BM];
__shared__ int s_cand_cnt[BM];

__device__ __forceinline__ float* ring() { return reinterpret_cast<float*>(s_dyn); }

__device__ __forceinline__ long long* row_list(int r, int k) {
  return reinterpret_cast<long long*>(s_dyn + RING_BYTES) + r * k;
}

// chunk c of a tile into ring stage c % STAGES: BK contraction rows of the
// CTA's BM users, then of the tile's BN items
__device__ __forceinline__ void load_chunk(const float* __restrict__ ut,
                                           const float* __restrict__ it, long long n_pad,
                                           long long i_pad, int c, int m0, int n0, int tid) {
  float* as = ring() + (c % STAGES) * BK * (BM + BN);
  float* bs = as + BK * BM;
#pragma unroll
  for (int q = 0; q < (BK * BM / 4) / THREADS; ++q) {
    const int idx = tid + q * THREADS;
    const int row = idx / (BM / 4);
    const int c4 = (idx % (BM / 4)) * 4;
    cp_async16(as + row * BM + c4, ut + (c * BK + row) * n_pad + m0 + c4);
    cp_async16(bs + row * BN + c4, it + (c * BK + row) * i_pad + n0 + c4);
  }
}

// Merge row r's `c` buffered candidates into its list, by one warp (KW =
// ceil(k / 32) list entries a lane). A lane takes one candidate: it reads
// the candidate's rated byte (the row's reads in flight together), raises a
// rated item's value to MASK_VALUE and drops what no longer beats the k-th
// key. Ranks are counts of larger keys: among the candidates by shuffles,
// in the sorted list by binary search.
template <int KW>
__device__ __forceinline__ void merge_row(const int8_t* __restrict__ rated, int r, int c, int k,
                                          int lane) {
  const int len = s_list_cnt[r];
  const long long tk = s_thr_key[r];
  long long* lst = row_list(r, k);
  long long x = NO_KEY;
  if (lane < c) {
    x = s_cand[r][lane];
    const long long item = key_id(x);
    if (rated[s_mask_off[r] + item]) x = make_key(MASK_VALUE, static_cast<unsigned>(item));
    if (x <= tk) x = NO_KEY;
  }
  long long e[KW];
  int epos[KW];
#pragma unroll
  for (int m = 0; m < KW; ++m) {
    const int idx = lane + 32 * m;
    e[m] = idx < len ? lst[idx] : NO_KEY;
    epos[m] = idx;
  }
  int pos = 0;
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    const long long xj = __shfl_sync(0xFFFFFFFFu, x, j);
    pos += xj > x;
#pragma unroll
    for (int m = 0; m < KW; ++m) epos[m] += xj > e[m];
  }
  int lo = 0, hi = x == NO_KEY ? 0 : len;  // list entries above x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lst[mid] > x) lo = mid + 1; else hi = mid;
  }
  pos += lo;
  const int now = min(k, len + __popc(__ballot_sync(0xFFFFFFFFu, x != NO_KEY)));
  __syncwarp();
  if (x != NO_KEY && pos < k) lst[pos] = x;
#pragma unroll
  for (int m = 0; m < KW; ++m) {
    if (lane + 32 * m < len && epos[m] < k) lst[epos[m]] = e[m];
  }
  __syncwarp();
  if (lane == 0) {
    s_list_cnt[r] = now;
    s_cand_cnt[r] = 0;
    if (now == k) {
      s_thr_key[r] = lst[k - 1];
      s_thr_f[r] = key_value(lst[k - 1]);
    }
  }
  __syncwarp();
}

// The selection of one row of a tile by one warp, from the scores in the
// ring: lane l looks at items n0 + 4l .. 4l + 3. A score that reaches the
// row's prefilter and whose key beats the row's k-th key (unless the row is
// open: its k-th value at or below MASK_VALUE, or not full) is appended as
// it is, in lane order; the merge applies the mask. A full buffer is merged
// at once, and what did not fit is tested again against the new k-th.
template <int KW>
__device__ __forceinline__ void select_row(const int8_t* __restrict__ rated, const float (&v)[4],
                                           int r, int n0, int n_items, int k, int lane) {
  const int item0 = n0 + 4 * lane;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  unsigned left = 0xFu;  // this lane's scores still to be tested
  while (true) {
    const float thr = s_thr_f[r];
    const float t = prefilter(thr);
    const bool open = !(thr > MASK_VALUE);
    unsigned want = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bool in = ((left >> u) & 1u) && item0 + u < n_items && !(v[u] < t);
      // at the k-th value itself (or NaN) the ids decide
      if (in && !open && !(v[u] > thr)) in = make_key(v[u], item0 + u) > s_thr_key[r];
      want |= static_cast<unsigned>(in) << u;
    }
    unsigned ballot[4];
    int total = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ballot[u] = __ballot_sync(0xFFFFFFFFu, (want >> u) & 1u);
      total += __popc(ballot[u]);
    }
    if (total == 0) return;
    const int cnt = s_cand_cnt[r];
    int slot = cnt;
    left = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if ((want >> u) & 1u) {
        const int at = slot + __popc(ballot[u] & below);
        if (at < CAND) s_cand[r][at] = make_key(v[u], item0 + u);
        else left |= 1u << u;
      }
      slot += __popc(ballot[u]);
    }
    if (cnt + total < CAND) {
      if (lane == 0) s_cand_cnt[r] = cnt + total;  // read again after a __syncthreads
      return;
    }
    __syncwarp();  // the candidates are in place for the merging lanes
    merge_row<KW>(rated, r, CAND, k, lane);
    if (!__any_sync(0xFFFFFFFFu, left)) return;
  }
}

// On a slice's first tile: row r's k-th value floor becomes the k-th largest
// of the tile's 128 values, rated items at MASK_VALUE (each value counted
// against the warp's 128), so the tile adds about k candidates, not 128.
__device__ __forceinline__ void first_tile_floor(const int8_t* __restrict__ rated,
                                                 const float (&v)[4], int r, int n0,
                                                 int n_items, int k, int lane) {
  const int item0 = n0 + 4 * lane;
  const long long off = s_mask_off[r];
  float w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    w[u] = item0 + u < n_items ? (rated[off + item0 + u] ? MASK_VALUE : v[u]) : -INFINITY;
  int at_least[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int src = 0; src < 32; ++src) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = __shfl_sync(0xFFFFFFFFu, w[q], src);
#pragma unroll
      for (int u = 0; u < 4; ++u) at_least[u] += x >= w[u];
    }
  }
  float floor = -INFINITY;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (at_least[u] >= k) floor = fmaxf(floor, w[u]);
#pragma unroll
  for (int o = 16; o; o >>= 1) floor = fmaxf(floor, __shfl_xor_sync(0xFFFFFFFFu, floor, o));
  if (lane == 0) s_thr_f[r] = floor;
  __syncwarp();
}

// The selection of a tile: warp w takes rows [16w, 16w + 16), rows from
// `rows_valid` on being padding. A quick pass over all 16 (their loads in
// flight together) finds the rows where some score reaches the prefilter;
// only those go through select_row.
template <int KW>
__device__ __forceinline__ void select_tile(const int8_t* __restrict__ rated, bool first, int n0,
                                            int n_items, int rows_valid, int k, int warp,
                                            int lane) {
  constexpr int ROWS = BM / WARPS;
  const int r0 = warp * ROWS;
  unsigned rows = 0;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const float4 v4 = reinterpret_cast<const float4*>(ring() + (r0 + q) * BN)[lane];
    const float t = prefilter(s_thr_f[r0 + q]);
    const bool pass = !(v4.x < t) || !(v4.y < t) || !(v4.z < t) || !(v4.w < t);
    rows |= static_cast<unsigned>(__any_sync(0xFFFFFFFFu, pass) || first) << q;
  }
  const int valid = min(ROWS, max(0, rows_valid - r0));
  rows &= valid == ROWS ? 0xFFFFu : (1u << valid) - 1u;
#pragma unroll 1
  for (; rows; rows &= rows - 1) {
    const int r = r0 + __ffs(rows) - 1;
    const float4 v4 = reinterpret_cast<const float4*>(ring() + r * BN)[lane];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    if (first) first_tile_floor(rated, v, r, n0, n_items, k, lane);
    select_row<KW>(rated, v, r, n0, n_items, k, lane);
  }
}

// grid (slices, n_pad / BM), THREADS threads, partial_smem(k) bytes; KW = ceil(k / 32)
template <int KW>
__global__ void __launch_bounds__(THREADS, 2)
rank_partial_kernel(const float* __restrict__ ut, const float* __restrict__ it,
                    const int8_t* __restrict__ rated, long long ld_rated,
                    const long long* __restrict__ uids, int n, int n_items, int dp,
                    long long n_pad, long long i_pad, int k, int tiles_per_slice, int n_tiles,
                    long long* __restrict__ out) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int tile0 = slice * tiles_per_slice;
  const int tile1 = min(tile0 + tiles_per_slice, n_tiles);
  const int kchunks = dp / BK;

  for (int r = tid; r < BM; r += THREADS) {
    const bool valid = m0 + r < n;
    s_list_cnt[r] = 0;
    s_cand_cnt[r] = 0;
    s_thr_f[r] = -INFINITY;
    s_thr_key[r] = NO_KEY;
    s_mask_off[r] = valid ? uids[m0 + r] * ld_rated : -1;
  }
  for (int tile = tile0; tile < tile1; ++tile) {
    const int n0 = tile * BN;
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < kchunks) load_chunk(ut, it, n_pad, i_pad, c, m0, n0, tid);
      cp_async_commit();
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < kchunks; ++c) {
      cp_async_wait_ring();
      __syncthreads();  // chunk c landed for every thread; the stage refilled below is free
      if (c + STAGES - 1 < kchunks) load_chunk(ut, it, n_pad, i_pad, c + STAGES - 1, m0, n0, tid);
      cp_async_commit();
      const float* a = ring() + (c % STAGES) * BK * (BM + BN);
      const float* b = a + BK * BM;
#pragma unroll
      for (int d = 0; d < BK; ++d) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + d * BM + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(a + d * BM + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + d * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(b + d * BN + 64 + tx * 4);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with the ring: it takes the scores
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float* row = ring() + ((i < 4 ? 0 : 60) + ty * 4 + i) * BN;
      reinterpret_cast<float4*>(row)[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(row)[16 + tx] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    select_tile<KW>(rated, tile == tile0, n0, n_items, n - m0, k, warp, lane);
    __syncthreads();  // the ring is free for the next tile
  }
#pragma unroll 1
  for (int r = warp * (BM / WARPS); r < (warp + 1) * (BM / WARPS); ++r) {
    const int c = s_cand_cnt[r];
    if (c > 0) merge_row<KW>(rated, r, c, k, lane);  // what the last tiles left buffered
  }
  __syncthreads();
  const int slices = gridDim.x;
  for (int idx = tid; idx < BM * k; idx += THREADS) {
    const int r = idx / k, q = idx % k;
    if (m0 + r < n) {
      out[(static_cast<long long>(m0 + r) * slices + slice) * k + q] =
          q < s_list_cnt[r] ? row_list(r, k)[q] : NO_KEY;
    }
  }
}

// one warp a user; grid ceil(n / MERGE_WARPS) of MERGE_WARPS warps; HITS:
// the ground-truth test of the answer
template <bool HITS>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
rank_merge_kernel(const long long* __restrict__ keys, int n, int slices, int k,
                  float* __restrict__ scores, long long* __restrict__ ids,
                  const long long* __restrict__ gt_off, const int* __restrict__ gt_items,
                  uint8_t* __restrict__ hits) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (u >= n) return;
  const long long* row = keys + static_cast<long long>(u) * slices * k;
  int p = 0;
  long long head = lane < slices ? row[lane * k] : NO_KEY;
  long long mine[K_MAX / 32];  // HITS: the ids of places lane, lane + 32, ...
  for (int q = 0; q < k; ++q) {
    long long best = head;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = other > best ? other : best;
    }
    if (lane < slices && head == best) {
      ++p;
      head = p < k ? row[lane * k + p] : NO_KEY;
    }
    if (lane == 0) {
      scores[static_cast<long long>(u) * k + q] = key_value(best);
      ids[static_cast<long long>(u) * k + q] = key_id(best);
    }
    if constexpr (HITS) {
#pragma unroll
      for (int m = 0; m < K_MAX / 32; ++m)
        if (q == lane + 32 * m) mine[m] = key_id(best);
    }
  }
  if constexpr (HITS) {
    const long long lo0 = gt_off[u], hi0 = gt_off[u + 1];
#pragma unroll
    for (int m = 0; m < K_MAX / 32; ++m) {
      const int q = lane + 32 * m;
      if (q < k) {
        long long lo = lo0, hi = hi0;  // the first item of the slice not below mine[m]
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (gt_items[mid] < mine[m]) lo = mid + 1; else hi = mid;
        }
        hits[static_cast<long long>(u) * k + q] = lo < hi0 && gt_items[lo] == mine[m];
      }
    }
  }
}

// dynamic shared memory of rank_partial: the ring and the lists
size_t partial_smem(int k) {
  return RING_BYTES + sizeof(long long) * BM * static_cast<size_t>(k);
}

template <int KW>
int launch_partial(dim3 grid, size_t smem, cudaStream_t stream, const void* ut, const void* it,
                   const void* rated, long long ld_rated, const void* uids, int n, int n_items,
                   int dp, long long n_pad, long long i_pad, int k, int tiles_per_slice,
                   long long n_tiles, void* out) {
  cudaError_t err = cudaFuncSetAttribute(rank_partial_kernel<KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_partial_kernel<KW><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(ut), static_cast<const float*>(it),
      static_cast<const int8_t*>(rated), ld_rated, static_cast<const long long*>(uids), n,
      n_items, dp, n_pad, i_pad, k, tiles_per_slice, static_cast<int>(n_tiles),
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ut (dp, n_pad) and it (dp, i_pad) f32, the test users' and the items'
// embeddings transposed and zero-padded, 16-byte aligned; rated (>= max uid
// + 1, >= n_items) int8 with row stride ld_rated; uids (n) int64, each a row
// of rated; out (n, slices, k) int64 keys. dp a multiple of 16, n_pad of
// 128 and >= n, i_pad of 128 and > n_items - 128; slices whole tiles of
// tiles_per_slice (the last may be shorter) cover the i_pad / 128 tiles,
// none empty. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or -1 for arguments it does not take.
int selfrec_rank_partial(const void* ut, const void* it, const void* rated, long long ld_rated,
                         const void* uids, int n, int n_items, int dp, long long n_pad,
                         long long i_pad, int k, int tiles_per_slice, int slices, void* out,
                         void* stream) {
  const long long n_tiles = i_pad / BN;
  if (n < 1 || n_items < 1 || k < 1 || k > K_MAX || dp < BK || dp % BK != 0 ||
      n_pad % BM != 0 || n_pad < n || i_pad % BN != 0 || i_pad < n_items ||
      i_pad - n_items >= BN || tiles_per_slice < 1 || slices < 1 || slices > 65535 ||
      static_cast<long long>(slices) * tiles_per_slice < n_tiles ||
      static_cast<long long>(slices - 1) * tiles_per_slice >= n_tiles) {
    return -1;
  }
  const size_t smem = partial_smem(k);
  const dim3 grid(slices, static_cast<unsigned>(n_pad / BM));
  auto* st = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch_partial<1>(grid, smem, st, ut, it, rated, ld_rated, uids, n, n_items,
                                     dp, n_pad, i_pad, k, tiles_per_slice, n_tiles, out);
    case 2: return launch_partial<2>(grid, smem, st, ut, it, rated, ld_rated, uids, n, n_items,
                                     dp, n_pad, i_pad, k, tiles_per_slice, n_tiles, out);
    case 3: return launch_partial<3>(grid, smem, st, ut, it, rated, ld_rated, uids, n, n_items,
                                     dp, n_pad, i_pad, k, tiles_per_slice, n_tiles, out);
    default: return launch_partial<4>(grid, smem, st, ut, it, rated, ld_rated, uids, n, n_items,
                                      dp, n_pad, i_pad, k, tiles_per_slice, n_tiles, out);
  }
}

// keys (n, slices, k) int64 from selfrec_rank_partial, slices <= 32;
// scores (n, k) f32 and ids (n, k) int64, fully written. gt_off (n + 1)
// int64 and gt_items int32, each row's items ascending, and hits (n, k)
// uint8, fully written: all three or none (then no test). Returns as above.
int selfrec_rank_merge(const void* keys, int n, int slices, int k, void* scores, void* ids,
                       const void* gt_off, const void* gt_items, void* hits, void* stream) {
  const int given = (gt_off != nullptr) + (gt_items != nullptr) + (hits != nullptr);
  if (n < 1 || slices < 1 || slices > 32 || k < 1 || k > K_MAX || (given != 0 && given != 3))
    return -1;
  const unsigned grid = (n + MERGE_WARPS - 1) / MERGE_WARPS;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const long long*>(keys);
  auto* sp = static_cast<float*>(scores);
  auto* ip = static_cast<long long*>(ids);
  const auto* op = static_cast<const long long*>(gt_off);
  const auto* gp = static_cast<const int*>(gt_items);
  auto* hp = static_cast<uint8_t*>(hits);
  if (given) {
    rank_merge_kernel<true><<<grid, MERGE_WARPS * 32, 0, st>>>(kp, n, slices, k, sp, ip, op, gp,
                                                                hp);
  } else {
    rank_merge_kernel<false><<<grid, MERGE_WARPS * 32, 0, st>>>(kp, n, slices, k, sp, ip, op,
                                                                 gp, hp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
