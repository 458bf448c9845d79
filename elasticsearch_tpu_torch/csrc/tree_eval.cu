// K20: the tree walk of trained-model inference: every (tree, doc)'s leaf.
//
// Replaces elasticsearch_tpu/xpack/ml.py:_eval_trees (:380, a vmap over
// trees of a lax.fori_loop over `depth` levels). X is f32[n, F] (NaN where
// a feature is missing); feats/left/right/dleft are i32[T, N] and thresh
// f32[T, N], one row a tree padded to N nodes (feat < 0 marks a leaf).
// out[t, doc] (i32[T, n]) is the node index the walk holds after `depth`
// levels, starting at node 0.
//
// The reference's index rules, kept exactly:
//  - a node is read at idx after wrapping a negative idx once (idx + N) and
//    clamping to [0, N-1] (jnp indexing clamps out-of-range reads);
//  - a leaf (feat < 0) keeps idx; since the walk then never moves, the loop
//    stops there, which gives the same idx as the remaining levels would;
//  - a feature index >= F reads NaN (take_along_axis fills);
//  - a NaN feature goes left iff dleft != 0, else left iff x < thresh (f32);
//  - the stored idx is the raw child index, which may be negative or >= N:
//    the host's leaf gather applies numpy's rules to it.
//
// One thread per (tree, doc); the grid covers (doc tiles, trees), threads
// along docs so the output row is written coalesced. A tree's five node
// arrays (20 bytes a node) go into shared memory when they fit in the 48 KB
// a block has without opting in (N <= 2457), else the walk reads them from
// device memory through the read-only cache.
//
// Bound: bytes. One call reads X once (4 n F), 20 bytes of each split node
// and 4 (its feat) of each leaf, and writes 4 T n; the depth-long chain of
// dependent reads makes it latency bound at small n.

#include "topk_common.cuh"

#define K20_THREADS 256
#define K20_SMEM_NODES 2457      // 20 bytes a node in 48 KB
#define K20_MAX_GRID_Y 65535

template <bool kShared>
__global__ void __launch_bounds__(K20_THREADS)
k20_tree_eval(const float* __restrict__ X, int n, int F,
              const int* __restrict__ feats,
              const float* __restrict__ thresh,
              const int* __restrict__ left, const int* __restrict__ right,
              const int* __restrict__ dleft, int T, int N, int depth,
              int* __restrict__ out) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int doc = blockIdx.x * K20_THREADS + tid;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const size_t base = (size_t)t * N;
    const int* tf = feats + base;
    const float* tt = thresh + base;
    const int* tl = left + base;
    const int* tr = right + base;
    const int* td = dleft + base;
    if (kShared) {
      int* sf = smem;
      float* st = reinterpret_cast<float*>(sf + N);
      int* sl = sf + 2 * N;
      int* sr = sf + 3 * N;
      int* sd = sf + 4 * N;
      __syncthreads();           // the previous tree's reads are done
      for (int j = tid; j < N; j += K20_THREADS) {
        sf[j] = tf[j];
        st[j] = tt[j];
        sl[j] = tl[j];
        sr[j] = tr[j];
        sd[j] = td[j];
      }
      __syncthreads();
      tf = sf;
      tt = st;
      tl = sl;
      tr = sr;
      td = sd;
    }
    if (doc >= n) continue;
    const float* x = X + (size_t)doc * F;
    int idx = 0;
    for (int level = 0; level < depth; ++level) {
      // wrap once (in two's complement, as the reference's int32 add), clamp
      int j = idx < 0 ? (int)((unsigned)idx + (unsigned)N) : idx;
      j = min(max(j, 0), N - 1);
      const int f = kShared ? tf[j] : __ldg(tf + j);
      if (f < 0) break;
      const float xv = f < F ? __ldg(x + f) : CUDART_NAN_F;
      bool go_left;
      if (isnan(xv))
        go_left = (kShared ? td[j] : __ldg(td + j)) != 0;
      else
        go_left = xv < (kShared ? tt[j] : __ldg(tt + j));
      idx = go_left ? (kShared ? tl[j] : __ldg(tl + j))
                    : (kShared ? tr[j] : __ldg(tr + j));
    }
    out[(size_t)t * n + doc] = idx;
  }
}

// Needs n, T, depth >= 0 and F, N >= 1, else returns ES_ERR_SIZE.
extern "C" int es_tree_eval(const float* X, int n, int F, const int* feats,
                            const float* thresh, const int* left,
                            const int* right, const int* dleft, int T,
                            int N, int depth, int* out, void* stream) {
  if (n < 0 || F < 1 || T < 0 || N < 1 || depth < 0) return ES_ERR_SIZE;
  if (n == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + K20_THREADS - 1) / K20_THREADS, min(T, K20_MAX_GRID_Y));
  if (N <= K20_SMEM_NODES) {
    k20_tree_eval<true><<<grid, K20_THREADS, (size_t)N * 20, st>>>(
        X, n, F, feats, thresh, left, right, dleft, T, N, depth, out);
  } else {
    k20_tree_eval<false><<<grid, K20_THREADS, 0, st>>>(
        X, n, F, feats, thresh, left, right, dleft, T, N, depth, out);
  }
  return (int)cudaGetLastError();
}
