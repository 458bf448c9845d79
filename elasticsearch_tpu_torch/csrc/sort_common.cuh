// A block-wide bitonic sort, shared by the rank-fusion kernels (K10, K11),
// the IVF window (K7) and the segment top-k (K19).
//
// One block sorts one row of n2 keys (n2 a power of two) in place,
// ascending under a comparator: the rank-fusion kernels sort SortKeys by
// the lexicographic order (r, k2, k3, c), K7 and K19 packed u64 keys. The
// keys live in shared memory when a row fits, else in the block's slice of
// a device-memory workspace (the code is the same: the barriers order the
// block's global accesses as they order its shared ones). Keys that are
// equal are the same bits (a SortKey's c is its entry's position; a packed
// key holds its index or is the empty key), so the result does not depend
// on the schedule.
#pragma once

#include "topk_common.cuh"

struct SortKey {
  int r;      // region: the first key
  float k2;
  int k3;
  int c;      // the entry's position in its row
};

__device__ __forceinline__ bool skey_less(const SortKey& a,
                                          const SortKey& b) {
  if (a.r != b.r) return a.r < b.r;
  if (a.k2 != b.k2) return a.k2 < b.k2;
  if (a.k3 != b.k3) return a.k3 < b.k3;
  return a.c < b.c;
}

struct SortKeyLess {
  __device__ __forceinline__ bool operator()(const SortKey& a,
                                             const SortKey& b) const {
    return skey_less(a, b);
  }
};

struct U64Less {
  __device__ __forceinline__ bool operator()(unsigned long long a,
                                             unsigned long long b) const {
    return a < b;
  }
};

// Every thread of the block calls it; ends with a barrier. A row of at
// most 64 keys is sorted by warp 0 alone, after one block barrier.
template <typename Key, typename Less>
__device__ void block_bitonic_sort(Key* a, int n2, Less less) {
  const bool warp_only = n2 <= 64;
  if (warp_only) __syncthreads();  // the block's writes of the row
  if (!warp_only || threadIdx.x < 32) {
    const int tn = warp_only ? 32 : blockDim.x;
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (warp_only)
          __syncwarp();
        else
          __syncthreads();
        for (int t = threadIdx.x; t < (n2 >> 1); t += tn) {
          // the pair (i, i + stride) with bit ``stride`` of i clear
          const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
          const int j = i + stride;
          const bool up = (i & size) == 0;
          const Key x = a[i], y = a[j];
          if (up ? less(y, x) : less(x, y)) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
    }
    if (warp_only) __syncwarp();
  }
  __syncthreads();
}

__device__ __forceinline__ void block_bitonic_sort(SortKey* a, int n2) {
  block_bitonic_sort(a, n2, SortKeyLess());
}

__device__ __forceinline__ void block_bitonic_sort(unsigned long long* a,
                                                   int n2) {
  block_bitonic_sort(a, n2, U64Less());
}

// Smallest power of two >= n (n >= 1).
__host__ __device__ __forceinline__ int es_pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Device-memory workspace for rows of n entries sorted as SortKeys: 0 when
// a row fits the shared memory a block may have.
static long long es_sort_workspace_bytes(int n, int rows) {
  size_t row = (size_t)es_pow2_at_least(n > 0 ? n : 1) * sizeof(SortKey);
  return row <= (size_t)es_max_shared_bytes() ? 0
                                              : (long long)(row * rows);
}
