// K3: row-wise tie-stable top-k over candidate lists.
//
// Replaces elasticsearch_tpu/ops/tiered_bm25.py:merge_topk_lists (exact
// union of two top-k lists, a doc present in both keeps its higher score),
// parallel/dist_search.py:_global_topk_reduce (cross-shard top-k over
// shard-major lists, ids globalised as s * n_pad + local) and the final
// stage of ops/topk.py:batched_blockwise_topk / the running top-k of
// ops/tiered_bm25.py:dense_stream_topk (here: the reduce of K2's per-tile
// partial lists).
//
// One block per row, held in shared memory when it fits, else in the
// row's slice of a device-memory workspace (the code is the same). A row is
// the concatenation [a | b] of two lists
// (b may be empty). Column c's id is id + (c / seg_len) * seg_stride (the
// shard globalisation; seg_stride 0 leaves ids as they are). Entries whose
// value is -inf, or whose id is >= fill_id, take no part. With dedup, an
// entry is dropped when another entry has its id and a higher value (or the
// same value at an earlier column). The k outputs are then selected one by
// one, each the best key strictly worse than the previous, under the total
// order (value desc, id asc, column asc): the order lax.top_k gives over
// doc-ascending lists and lax.sort gives in merge_topk_lists. Rows with
// fewer than k entries pad with (-inf, fill_id). With out_sel, each output
// also records its column in [a | b] (0 on padded slots): the payload
// channels of _global_topk_reduce (the rescore secondaries) follow the
// selection through one gather.
//
// Bound: the card's memory rate (8 bytes per entry read, 8 per output);
// the k selection passes re-read the row from L1/L2.

#include "topk_common.cuh"

#define K3_THREADS 256

struct Key {
  float v;
  int id;
  int c;
};

__device__ __forceinline__ bool kbetter(const Key& a, const Key& b) {
  if (a.v != b.v) return a.v > b.v;
  if (a.id != b.id) return a.id < b.id;
  return a.c < b.c;
}

__device__ __forceinline__ Key shfl_key(const Key& k, int delta) {
  Key o;
  o.v = __shfl_down_sync(0xffffffffu, k.v, delta);
  o.id = __shfl_down_sync(0xffffffffu, k.id, delta);
  o.c = __shfl_down_sync(0xffffffffu, k.c, delta);
  return o;
}

__global__ void __launch_bounds__(K3_THREADS)
topk_merge_kernel(const float* __restrict__ a_vals,
                  const int* __restrict__ a_ids, int ma,
                  const float* __restrict__ b_vals,
                  const int* __restrict__ b_ids, int mb, int k, int dedup,
                  int seg_len, int seg_stride, int fill_id,
                  float* __restrict__ out_vals, int* __restrict__ out_ids,
                  int* __restrict__ out_sel, float* workspace) {
  extern __shared__ unsigned char smem[];
  __shared__ Key warp_best[K3_THREADS / 32];
  __shared__ Key best;

  const int r = blockIdx.x;
  const int m = ma + mb;
  const int tid = threadIdx.x;
  float* sv = workspace != nullptr ? workspace + (size_t)r * 2 * m
                                   : reinterpret_cast<float*>(smem);  // [m]
  int* sid = reinterpret_cast<int*>(sv + m);                          // [m]

  for (int c = tid; c < m; c += K3_THREADS) {
    float v;
    int id;
    if (c < ma) {
      v = a_vals[(size_t)r * ma + c];
      id = a_ids[(size_t)r * ma + c];
    } else {
      v = b_vals[(size_t)r * mb + (c - ma)];
      id = b_ids[(size_t)r * mb + (c - ma)];
    }
    id += (c / seg_len) * seg_stride;
    if (!(v > -CUDART_INF_F) || id >= fill_id) v = -CUDART_INF_F;
    sv[c] = v;
    sid[c] = id;
  }
  __syncthreads();
  if (dedup) {
    // drop dominated duplicates in place. An id's best entry (highest
    // value, then lowest column) is never dropped, so every other entry
    // of the id still finds it; a value another thread has already set to
    // -inf can neither drop an entry nor keep one.
    volatile float* vv = sv;
    for (int c = tid; c < m; c += K3_THREADS) {
      float v = vv[c];
      int id = sid[c];
      if (!(v > -CUDART_INF_F)) continue;
      for (int c2 = 0; c2 < m; ++c2) {
        if (c2 == c || sid[c2] != id) continue;
        float v2 = vv[c2];
        if (v2 > v || (v2 == v && c2 < c)) {
          vv[c] = -CUDART_INF_F;
          break;
        }
      }
    }
    __syncthreads();
  }

  Key prev{CUDART_INF_F, -2147483647 - 1, -1};   // better than any entry
  float* ov = out_vals + (size_t)r * k;
  int* oi = out_ids + (size_t)r * k;
  int* os = out_sel != nullptr ? out_sel + (size_t)r * k : nullptr;
  for (int j = 0; j < k; ++j) {
    Key mine{-CUDART_INF_F, 2147483647, 2147483647};
    for (int c = tid; c < m; c += K3_THREADS) {
      Key x{sv[c], sid[c], c};
      if (x.v > -CUDART_INF_F && kbetter(prev, x) && kbetter(x, mine))
        mine = x;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      Key o = shfl_key(mine, d);
      if (kbetter(o, mine)) mine = o;
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = mine;
    __syncthreads();
    if (tid == 0) {
      Key bst = warp_best[0];
      for (int w = 1; w < K3_THREADS / 32; ++w)
        if (kbetter(warp_best[w], bst)) bst = warp_best[w];
      best = bst;
      bool ok = bst.v > -CUDART_INF_F;
      ov[j] = ok ? bst.v : -CUDART_INF_F;
      oi[j] = ok ? bst.id : fill_id;
      if (os != nullptr) os[j] = ok ? bst.c : 0;
    }
    __syncthreads();
    prev = best;
    if (!(prev.v > -CUDART_INF_F)) {
      for (int j2 = j + 1 + tid; j2 < k; j2 += K3_THREADS) {
        ov[j2] = -CUDART_INF_F;
        oi[j2] = fill_id;
        if (os != nullptr) os[j2] = 0;
      }
      break;
    }
  }
}

// Bytes of device-memory workspace K3 needs for R rows of m entries: 0 when
// a row fits the card's shared memory.
extern "C" long long es_topk_merge_workspace_bytes(int m, int R) {
  size_t row = (size_t)m * 8;
  return row <= (size_t)es_max_shared_bytes() ? 0 : (long long)(row * R);
}

extern "C" int es_topk_merge(const float* a_vals, const int* a_ids, int ma,
                             const float* b_vals, const int* b_ids, int mb,
                             int R, int k, int dedup, int seg_len,
                             int seg_stride, int fill_id, float* out_vals,
                             int* out_ids, int* out_sel, void* workspace,
                             void* stream) {
  size_t shm = workspace != nullptr ? 0 : (size_t)(ma + mb) * 8;
  int e = es_set_shared(topk_merge_kernel, shm);
  if (e != 0) return e;
  topk_merge_kernel<<<R, K3_THREADS, shm, (cudaStream_t)stream>>>(
      a_vals, a_ids, ma, b_vals, b_ids, mb, k, dedup, seg_len, seg_stride,
      fill_id, out_vals, out_ids, out_sel, (float*)workspace);
  return (int)cudaGetLastError();
}
