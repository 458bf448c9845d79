// K14: masked bucket counts and sums.
//
// Replaces elasticsearch_tpu/ops/aggs.py:masked_bucket_counts (:73) and
// masked_bucket_sums (:88): the reference builds an [M, nb] one-hot of
// each pair's bucket id and reduces it (a sum of ints, or mv @ onehot).
// Here each pair whose doc the mask holds (jnp.take with fill, as K12) and
// whose id lies in [0, nb) adds to its bucket; other pairs add nothing.
//
// Bound: bytes (4 bytes of id, 4 of doc and 4 of value a pair, streamed
// once; the mask gathered at random, a 32-byte sector a pair as in K12).
// The one-hot's nb compares a pair become one shared-memory update.
//
// Counts: each block keeps a private int histogram of nb <= 4096 buckets
// (16 KB) in shared memory, updated with shared atomics, and adds it into
// the output with global atomics at the end. Integers: exact in any order.
//
// Sums use no float atomics, so they are the same bits on every run. Each
// warp keeps its own f64 histogram (four warps a block: 128 KB at nb =
// 4096). At each step a warp reads 32 neighbouring pairs; lanes with the
// same bucket find each other (__match_any_sync) and the lowest of them
// adds the group's values in lane order. The block then adds its four
// warp rows in warp order into a partial row [block, nb] in device memory,
// and a second pass adds the rows in block order and rounds to f32 once.
// Block b always takes the same contiguous range of pairs (the grid is a
// function of M alone).

#include "agg_common.cuh"
#include "topk_common.cuh"

#define K14_COUNT_THREADS 256
#define K14_SUM_THREADS 128
#define K14_SUM_WARPS (K14_SUM_THREADS / 32)
#define K14_MAX_BLOCKS 1024

__global__ void __launch_bounds__(K14_COUNT_THREADS)
k14_count_kernel(const int* __restrict__ ids, const int* __restrict__ docs,
                 long long Mp, const unsigned char* __restrict__ mask,
                 int n_pad, int nb, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < nb; b += K14_COUNT_THREADS) hist[b] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * K14_COUNT_THREADS;
  for (long long i = (long long)blockIdx.x * K14_COUNT_THREADS + threadIdx.x;
       i < Mp; i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < nb && es_gather_mask(mask, n_pad, docs[i]))
      atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += K14_COUNT_THREADS)
    if (hist[b] != 0) atomicAdd(&out[b], hist[b]);
}

__global__ void __launch_bounds__(K14_SUM_THREADS)
k14_sum_kernel(const int* __restrict__ ids, const int* __restrict__ docs,
               const float* __restrict__ vals, long long Mp,
               long long per_block, const unsigned char* __restrict__ mask,
               int n_pad, int nb, double* __restrict__ partial) {
  extern __shared__ double wh[];                 // [K14_SUM_WARPS][nb]
  __shared__ float stage[K14_SUM_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < K14_SUM_WARPS * nb; b += K14_SUM_THREADS)
    wh[b] = 0.0;
  __syncthreads();
  double* mine = wh + (size_t)warp * nb;
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = min(lo + per_block, Mp);
  for (long long base = lo; base < hi; base += K14_SUM_THREADS) {
    const long long i = base + warp * 32 + lane;
    int key = -1;
    float v = 0.0f;
    if (i < hi) {
      const int id = ids[i];
      if (id >= 0 && id < nb && es_gather_mask(mask, n_pad, docs[i])) {
        key = id;
        v = vals[i];
      }
    }
    const unsigned grp = __match_any_sync(0xffffffffu, key);
    stage[warp][lane] = v;
    __syncwarp();
    if (key >= 0 && lane == __ffs(grp) - 1) {
      double acc = mine[key];
      for (unsigned g = grp; g != 0; g &= g - 1)
        acc += (double)stage[warp][__ffs(g) - 1];
      mine[key] = acc;
    }
    __syncwarp();
  }
  __syncthreads();
  double* row = partial + (size_t)blockIdx.x * nb;
  for (int b = threadIdx.x; b < nb; b += K14_SUM_THREADS) {
    double s = wh[b];
    for (int w = 1; w < K14_SUM_WARPS; ++w) s += wh[(size_t)w * nb + b];
    row[b] = s;
  }
}

__global__ void k14_sum_rows_kernel(const double* __restrict__ partial,
                                    int n_rows, int nb,
                                    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  double s = 0.0;
  for (int r = 0; r < n_rows; ++r) s += partial[(size_t)r * nb + b];
  out[b] = (float)s;
}

// Blocks of the sums pass and the pairs each takes (a multiple of a
// block's step): a function of Mp alone, so the order of the sums is.
static void k14_sum_grid(long long Mp, int* blocks, long long* per_block) {
  long long nb = (Mp + K14_SUM_THREADS - 1) / K14_SUM_THREADS;
  if (nb > K14_MAX_BLOCKS) nb = K14_MAX_BLOCKS;
  if (nb < 1) nb = 1;
  long long per = (Mp + nb - 1) / nb;
  per = (per + K14_SUM_THREADS - 1) / K14_SUM_THREADS * K14_SUM_THREADS;
  *blocks = (int)nb;
  *per_block = per;
}

// Workspace bytes: the sums pass's partial rows; 0 for counts.
extern "C" long long es_agg_bucket_reduce_workspace_bytes(int Mp, int nb,
                                                          int sums) {
  if (!sums) return 0;
  int blocks;
  long long per;
  k14_sum_grid(Mp, &blocks, &per);
  return 8LL * blocks * nb;
}

extern "C" int es_agg_bucket_reduce(const int* ids, const int* docs,
                                    const float* vals, int Mp,
                                    const unsigned char* mask, int n_pad,
                                    int nb, int sums, void* out,
                                    void* workspace, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb <= 0 || nb > 4096) return ES_ERR_ARG;
  if (!sums) {
    cudaMemsetAsync(out, 0, sizeof(int) * (size_t)nb, st);
    if (Mp > 0) {
      const size_t shm = sizeof(int) * (size_t)nb;
      int e = es_set_shared(k14_count_kernel, shm);
      if (e != 0) return e;
      long long grid = ((long long)Mp + K14_COUNT_THREADS - 1) /
                       K14_COUNT_THREADS;
      if (grid > K14_MAX_BLOCKS) grid = K14_MAX_BLOCKS;
      k14_count_kernel<<<(unsigned)grid, K14_COUNT_THREADS, shm, st>>>(
          ids, docs, Mp, mask, n_pad, nb, (int*)out);
    }
    return (int)cudaGetLastError();
  }
  int blocks;
  long long per;
  k14_sum_grid(Mp, &blocks, &per);
  const size_t shm = sizeof(double) * (size_t)K14_SUM_WARPS * nb;
  int e = es_set_shared(k14_sum_kernel, shm);
  if (e != 0) return e;
  double* partial = (double*)workspace;
  k14_sum_kernel<<<blocks, K14_SUM_THREADS, shm, st>>>(
      ids, docs, vals, Mp, per, mask, n_pad, nb, partial);
  k14_sum_rows_kernel<<<(nb + 255) / 256, 256, 0, st>>>(partial, blocks, nb,
                                                        (float*)out);
  return (int)cudaGetLastError();
}
