// K20: the tree walk of trained-model inference: every (tree, doc)'s leaf.
//
// Replaces elasticsearch_tpu/xpack/ml.py:_eval_trees (:380, a vmap over
// trees of a lax.fori_loop over `depth` levels). X is f32[n, F] (NaN where
// a feature is missing). The trees come packed (ops: xpack/ml.py
// pack_tree_nodes, built once a model): nodes is i32[T, N, 4], one 16-byte
// record a node, one row a tree padded to N nodes:
//   .x  min(feat, F) << 1 | (dleft != 0), or -1 for a leaf (feat < 0);
//   .y  thresh's f32 bits;
//   .z  left, .w right (raw child indices).
// Every feature index >= F reads NaN and so behaves alike; column F of a
// staged X row holds that NaN. out[t, doc] (i32[T, n]) is the node index
// the walk holds after `depth` levels, starting at node 0.
//
// The reference's index rules, kept exactly:
//  - a node is read at idx after wrapping a negative idx once (idx + N) and
//    clamping to [0, N-1] (jnp indexing clamps out-of-range reads);
//  - a leaf keeps idx; since the walk then never moves, the loop stops
//    there, which gives the same idx as the remaining levels would;
//  - a NaN feature goes left iff dleft != 0, else left iff x < thresh (f32);
//  - the stored idx is the raw child index, which may be negative or >= N:
//    the host's leaf gather applies numpy's rules to it.
//
// A level is one 16-byte read of the node (one __ldg of an int4: every load
// the level needs, issued at once) and one read of X from shared memory.
// Each thread interleaves K20_WALKS independent walks, so several chains of
// dependent reads are in flight a thread. Two shapes, picked by the C entry
// from n:
//   batch (n > K20_FEW_DOCS): a block stages a tile of K20_TILE docs' X
//     rows in shared memory once (a row of F + 1 floats: the NaN column,
//     which also staggers the rows across the banks), then walks a group
//     of trees over the tile: a warp's lanes take 32 of the tile's docs
//     (K20_DOC_WARPS warps along docs), each thread K20_WALKS trees at a
//     time, so an output row is written along docs, coalesced. The groups
//     are sized for about one wave of blocks over the card. The pack (4.1
//     MB for 500 trees of 511 nodes) stays in L2, a pass's trees in L1.
//   few docs (n <= K20_FEW_DOCS, the ingest processor's one doc): a walk
//     is a chain of `depth` dependent reads, so a block a tree first
//     stages the tree's records (coalesced 16-byte reads, all in flight at
//     once) and the n rows in shared memory, then a thread a doc walks
//     there: one round trip to L2 a block in place of one a level. At (k)
//     (500 trees of 511 nodes, one doc) that is 500 blocks of 8 KB, one
//     wave on an H100 (kernel_probe.py --kernels k20 --variants, by queued
//     events: 4.0 us; groups of 2 or 5 trees a block 4.1 and 4.5; the
//     batch shape at one doc, whose walks read the pack in device memory,
//     7.3). Where a tree and the rows pass 48 KB (N past 3,000 or so) the
//     batch shape takes the few docs.
// A batch tile's rows too wide to stage (K20_TILE (F + 1) floats past 48
// KB) are read from device memory through the read-only cache instead.
//
// Bound: bytes at a batch. One call reads X once (4 n F), 16 bytes of each
// split node visited and 4 of each leaf, and writes 4 T n; the depth-long
// chain of dependent reads makes it latency bound at small n. At (j)'s
// batch (500 trees, 1,024 docs) the scattered record reads hold it, about
// 4.6M of them, 13 us on an H100 against a 1.4 us bound: a block's pass
// of 32 trees is 256 KB of records, more than L1 holds (tiles of 64 to
// 256 docs with 16 to 4 trees a pass were slower: kernel_probe.py's
// K20_VARIANTS).

#include "topk_common.cuh"

#define K20_THREADS 256
#define K20_DOC_WARPS 1        // a batch block's warps along docs
#define K20_TILE (32 * K20_DOC_WARPS)  // docs a block tile
#define K20_WALKS 4            // walks a thread interleaves
#define K20_FEW_DOCS 8         // n up to which the few-docs shape runs
#define K20_FEW_THREADS 256
#define K20_BLOCKS_PER_SM 8    // a wave: 2,048 threads an SM
#define K20_STAGE_BYTES (48 * 1024)

// The value a walk reads for feature f (f <= F) of a row: a staged row
// holds NaN at column F, a row in device memory is read only below it.
template <bool kStaged>
__device__ __forceinline__ float k20_x(const float* row, int f, int F) {
  if (kStaged) return row[f];
  return f < F ? __ldg(row + f) : CUDART_NAN_F;
}

// A node record: from shared memory where the tree is staged, else through
// the read-only cache.
template <bool kShared>
__device__ __forceinline__ int4 k20_node(const int4* p) {
  if (kShared) return *p;
  return __ldg(p);
}

// Walks nw (<= K20_WALKS) trees x rows at once: walk i starts at node 0 of
// tree[i] over row[i]; idx[i] returns its node index after depth levels.
template <bool kStaged, bool kSharedTrees = false>
__device__ __forceinline__ void k20_walk(const int4* const* tree,
                                         const float* const* row, int nw,
                                         int N, int F, int depth,
                                         int* idx) {
  bool live[K20_WALKS];
#pragma unroll
  for (int i = 0; i < K20_WALKS; ++i) {
    idx[i] = 0;
    live[i] = i < nw;
  }
  for (int level = 0; level < depth; ++level) {
    int4 nd[K20_WALKS];
#pragma unroll
    for (int i = 0; i < K20_WALKS; ++i) {
      if (live[i]) {
        // wrap once (in two's complement, as the reference's int32 add),
        // clamp
        int j = idx[i] < 0 ? (int)((unsigned)idx[i] + (unsigned)N) : idx[i];
        j = min(max(j, 0), N - 1);
        nd[i] = k20_node<kSharedTrees>(tree[i] + j);
      }
    }
    bool moved = false;
#pragma unroll
    for (int i = 0; i < K20_WALKS; ++i) {
      if (!live[i]) continue;
      const int f = nd[i].x;
      if (f < 0) {
        live[i] = false;
        continue;
      }
      const float xv = k20_x<kStaged>(row[i], f >> 1, F);
      const bool go_left =
          isnan(xv) ? (f & 1) != 0 : xv < __int_as_float(nd[i].y);
      idx[i] = go_left ? nd[i].z : nd[i].w;
      moved = true;
    }
    if (!moved) break;
  }
}

// Stages rows [d0, d0 + rows) of X (those below n) as rows of F + 1 floats,
// NaN in column F and in the rows past n.
__device__ __forceinline__ void k20_stage(float* xs, const float* X, int n,
                                          int F, int d0, int rows) {
  const int stride = F + 1;
  for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
    const int r = i / stride;
    const int c = i - r * stride;
    const int d = d0 + r;
    xs[i] = c < F && d < n ? X[(size_t)d * F + c] : CUDART_NAN_F;
  }
}

// The batch shape: grid (doc tiles, tree groups of `per_group` trees).
template <bool kStaged>
__global__ void __launch_bounds__(K20_THREADS)
k20_batch(const float* __restrict__ X, int n, int F,
          const int4* __restrict__ nodes, int T, int N, int depth,
          int per_group, int* __restrict__ out) {
  extern __shared__ float xs[];
  // warp w takes the tile's docs 32 (w % K20_DOC_WARPS) on and the trees
  // K20_WALKS (w / K20_DOC_WARPS) on in each pass of the group
  const int warp = threadIdx.x >> 5;
  const int slot = (warp % K20_DOC_WARPS) * 32 + (threadIdx.x & 31);
  const int d0 = blockIdx.x * K20_TILE;
  if (kStaged) {
    k20_stage(xs, X, n, F, d0, K20_TILE);
    __syncthreads();
  }
  const int doc = d0 + slot;
  if (doc >= n) return;
  const float* r = kStaged ? xs + slot * (F + 1) : X + (size_t)doc * F;
  const float* rows[K20_WALKS];
#pragma unroll
  for (int i = 0; i < K20_WALKS; ++i) rows[i] = r;
  const int t_end = min(T, (blockIdx.y + 1) * per_group);
  const int step = K20_THREADS / 32 / K20_DOC_WARPS * K20_WALKS;
  for (int t0 = blockIdx.y * per_group + warp / K20_DOC_WARPS * K20_WALKS;
       t0 < t_end; t0 += step) {
    const int nw = min(K20_WALKS, t_end - t0);
    const int4* tree[K20_WALKS];
#pragma unroll
    for (int i = 0; i < K20_WALKS; ++i)
      tree[i] = nodes + (size_t)min(t0 + i, T - 1) * N;
    int idx[K20_WALKS];
    k20_walk<kStaged>(tree, rows, nw, N, F, depth, idx);
#pragma unroll
    for (int i = 0; i < K20_WALKS; ++i)
      if (i < nw) out[(size_t)(t0 + i) * n + doc] = idx[i];
  }
}

// The few-docs shape: block t stages tree t's records and the n (<=
// K20_FEW_DOCS) rows, then thread d < n walks doc d in shared memory.
__global__ void __launch_bounds__(K20_FEW_THREADS)
k20_few(const float* __restrict__ X, int n, int F,
        const int4* __restrict__ nodes, int N, int depth,
        int* __restrict__ out) {
  extern __shared__ int4 sn[];
  const int4* src = nodes + (size_t)blockIdx.x * N;
  // four 16-byte reads a thread in flight before their stores
  for (int i0 = threadIdx.x; i0 < N; i0 += 4 * K20_FEW_THREADS) {
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * K20_FEW_THREADS;
      if (i < N) v[k] = __ldg(src + i);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * K20_FEW_THREADS;
      if (i < N) sn[i] = v[k];
    }
  }
  float* xs = reinterpret_cast<float*>(sn + N);
  k20_stage(xs, X, n, F, 0, n);
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= n) return;
  const int4* tree[K20_WALKS];
  const float* rows[K20_WALKS];
#pragma unroll
  for (int w = 0; w < K20_WALKS; ++w) {
    tree[w] = sn;
    rows[w] = xs + d * (F + 1);
  }
  int idx[K20_WALKS];
  k20_walk<true, true>(tree, rows, 1, N, F, depth, idx);
  out[(size_t)blockIdx.x * n + d] = idx[0];
}

// Trees a group of the batch shape: the fewest that keep the grid's blocks
// near one wave (K20_BLOCKS_PER_SM an SM), in whole passes of a block's
// walks.
static int k20_per_group(int n, int T) {
  const long long tiles = (n + K20_TILE - 1) / K20_TILE;
  const int pass = K20_THREADS / 32 / K20_DOC_WARPS * K20_WALKS;
  const long long target = (long long)es_sm_count() * K20_BLOCKS_PER_SM;
  long long groups = (target + tiles - 1) / tiles;
  const long long most = (T + pass - 1) / pass;
  if (groups > most) groups = most;
  if (groups < 1) groups = 1;
  long long per = (T + groups - 1) / groups;
  per = (per + pass - 1) / pass * pass;
  // grid.y holds at most 65,535 groups
  while ((T + per - 1) / per > 65535) per += pass;
  return (int)per;
}

// Needs n, T, depth >= 0, F >= 1 and N >= 1, else returns ES_ERR_SIZE.
// nodes: T x N packed 16-byte records (see the head of this file).
extern "C" int es_tree_eval(const float* X, int n, int F, const void* nodes,
                            int T, int N, int depth, int* out,
                            void* stream) {
  if (n < 0 || F < 1 || T < 0 || N < 1 || depth < 0) return ES_ERR_SIZE;
  if (n == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* nd = (const int4*)nodes;
  // the few-docs shape where a tree and the rows fit the stage, else the
  // batch shape, which walks any n over any tree
  const size_t few = (size_t)N * 16 + (size_t)n * (F + 1) * sizeof(float);
  if (n <= K20_FEW_DOCS && few <= K20_STAGE_BYTES) {
    k20_few<<<T, K20_FEW_THREADS, few, st>>>(X, n, F, nd, N, depth, out);
    return (int)cudaGetLastError();
  }
  const int per = k20_per_group(n, T);
  const dim3 grid((n + K20_TILE - 1) / K20_TILE, (T + per - 1) / per);
  const size_t shm = (size_t)K20_TILE * (F + 1) * sizeof(float);
  if (shm <= K20_STAGE_BYTES)
    k20_batch<true><<<grid, K20_THREADS, shm, st>>>(X, n, F, nd, T, N,
                                                    depth, per, out);
  else
    k20_batch<false><<<grid, K20_THREADS, 0, st>>>(X, n, F, nd, T, N,
                                                   depth, per, out);
  return (int)cudaGetLastError();
}
