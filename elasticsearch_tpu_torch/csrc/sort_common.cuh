// A block-wide bitonic sort, shared by the rank-fusion kernels (K10, K11).
//
// One block sorts one row of n2 keys (n2 a power of two) in place,
// ascending under the lexicographic order (r, k2, k3, c). The keys live in
// shared memory when a row fits, else in the block's slice of a
// device-memory workspace (the code is the same: __syncthreads orders the
// block's global accesses as it orders its shared ones). A key's c is its
// entry's position, so keys are unique and the result does not depend on
// the schedule.
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

// Every thread of the block calls it; ends with a barrier.
__device__ void block_bitonic_sort(SortKey* a, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n2 >> 1); t += blockDim.x) {
        // the pair (i, i + stride) with bit ``stride`` of i clear
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        SortKey x = a[i], y = a[j];
        if (up ? skey_less(y, x) : skey_less(x, y)) {
          a[i] = y;
          a[j] = x;
        }
      }
    }
  }
  __syncthreads();
}

// Smallest power of two >= n (n >= 1).
static inline int es_pow2_at_least(int n) {
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
