// K14: masked bucket counts and sums.
//
// Replaces elasticsearch_tpu/ops/aggs.py:masked_bucket_counts (:73) and
// masked_bucket_sums (:88): the reference builds an [M, nb] one-hot of
// each pair's bucket id and reduces it (a sum of ints, or mv @ onehot).
// Here each pair whose doc the mask holds (jnp.take with fill, as K12) and
// whose id lies in [0, nb) adds to its bucket; other pairs add nothing.
//
// Bound: bytes (4 bytes of id a pair, 4 of doc a pair with an id in
// range, 4 of value a matched pair, the mask bytes the docs touch). The
// one-hot's nb compares a pair become one shared-memory update.
//
// Counts: each block keeps a private int histogram of nb <= 4096 buckets
// (16 KB) in shared memory, updated with shared atomics, and adds it into
// the output with global atomics at the end. Integers: exact in any order.
//
// Sums use no float atomics, so they are the same bits on every run. The
// grid is K14_SUM_BLOCKS blocks, a constant (3 blocks an SM of the H100's
// 132: one wave at nb <= 1,024), fewer only when Mp is small, so the
// order of the sums is a function of Mp and nb alone. The pairs go in
// steps of K14_STEP, dealt round the blocks and, within a block, round
// its warps (step k to block k mod grid), so every block holds as many
// padded pairs as another. A lane takes four consecutive pairs of each of
// K14_VECS vectors of a step, with 16-byte loads where the columns are
// 16-byte aligned; the
// docs only of a vector with a bucket id in range, the values only of a
// vector with a match. Every mask gather of a step is issued before any
// of its adds. Each warp keeps its own f64 histogram row (K14_ROW_WORDS
// f64 words a block: 8 warps at nb <= 1,024, fewer above). For each of a
// step's pair slots in turn, the lanes stage the slot's values in 32
// floats of shared memory, lanes with the same bucket find each other
// (__match_any_sync) and the lowest of them adds the group's values in
// lane order. The block adds its warp rows in warp order into a partial
// row [block, nb] in device memory; a second kernel, a block per 32
// buckets, adds each bucket's rows in a fixed order (eight runs of rows
// in order, then the eight runs in order) and rounds to f32 once.

#include <stdint.h>

#include "agg_common.cuh"
#include "topk_common.cuh"

#define K14_COUNT_THREADS 256
#define K14_MAX_BLOCKS 1024
#define K14_SUM_BLOCKS 396
#define K14_SUM_WARPS 8
#define K14_ROW_WORDS 8192
#define K14_VECS 4
#define K14_SLOTS (4 * K14_VECS)
#define K14_STEP (32 * K14_SLOTS)
#define K14_ROWS_WARPS 8

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

// Pairs i0 .. i0 + 3 of a column: one 16-byte load where all four lie
// below hi and the columns are aligned (VEC), else a load a pair below
// hi; `fill` past it.
template <bool VEC, typename T, typename T4>
__device__ __forceinline__ void k14_load4(const T* __restrict__ p,
                                          long long i0, long long hi,
                                          T* out, T fill) {
  if (VEC && i0 + 3 < hi) {
    const T4 q = __ldcs((const T4*)(p + i0));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = i0 + j < hi ? __ldcs(p + i0 + j) : fill;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(K14_SUM_WARPS * 32, 3)
k14_sum_kernel(const int* __restrict__ ids, const int* __restrict__ docs,
               const float* __restrict__ vals, long long Mp,
               const unsigned char* __restrict__ mask, int n_pad, int nb,
               double* __restrict__ partial) {
  extern __shared__ double wh[];       // [warps][nb], then each warp's stage
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = (float*)(wh + (size_t)warps * nb) + warp * 32;
  for (int b = threadIdx.x; b < warps * nb; b += blockDim.x) wh[b] = 0.0;
  __syncthreads();
  double* mine = wh + (size_t)warp * nb;
  const long long steps = (Mp + K14_STEP - 1) / K14_STEP;
  for (long long k = blockIdx.x + (long long)gridDim.x * warp; k < steps;
       k += (long long)gridDim.x * warps) {
    const long long base = k * K14_STEP;
    int key[K14_SLOTS], doc[K14_SLOTS];
    float v[K14_SLOTS];
#pragma unroll
    for (int u = 0; u < K14_VECS; ++u)
      k14_load4<VEC, int, int4>(ids, base + 128 * u + 4 * lane, Mp,
                                 key + 4 * u, -1);
    bool any = false;
#pragma unroll
    for (int u = 0; u < K14_VECS; ++u) {
      bool in = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int& k = key[4 * u + j];
        k = k >= 0 && k < nb ? k : -1;
        in |= k >= 0;
      }
      if (in)
        k14_load4<VEC, int, int4>(docs, base + 128 * u + 4 * lane, Mp,
                                  doc + 4 * u, 0);
      else
#pragma unroll
        for (int j = 0; j < 4; ++j) doc[4 * u + j] = 0;
      any |= in;
    }
    if (!__any_sync(0xffffffffu, any)) continue;   // padding, ids past nb
    // every gather of the step, then the values of vectors with a match
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s)
      if (key[s] >= 0 && !es_gather_mask(mask, n_pad, doc[s])) key[s] = -1;
    any = false;
#pragma unroll
    for (int u = 0; u < K14_VECS; ++u) {
      const bool hit = key[4 * u] >= 0 || key[4 * u + 1] >= 0 ||
                       key[4 * u + 2] >= 0 || key[4 * u + 3] >= 0;
      if (hit)
        k14_load4<VEC, float, float4>(vals, base + 128 * u + 4 * lane, Mp,
                                      v + 4 * u, 0.0f);
      else
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * u + j] = 0.0f;
      any |= hit;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s) {
      stage[lane] = v[s];
      __syncwarp();
      const unsigned grp = __match_any_sync(0xffffffffu, key[s]);
      if (key[s] >= 0 && lane == __ffs(grp) - 1) {
        double acc = mine[key[s]];
        for (unsigned g = grp; g != 0; g &= g - 1)
          acc += (double)stage[__ffs(g) - 1];
        mine[key[s]] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  double* row = partial + (size_t)blockIdx.x * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    double s = wh[b];
    for (int w = 1; w < warps; ++w) s += wh[(size_t)w * nb + b];
    row[b] = s;
  }
}

// A block per 32 buckets: warp w adds its run of rows in order, then warp
// 0 adds the eight runs in order and rounds once.
__global__ void __launch_bounds__(K14_ROWS_WARPS * 32)
k14_sum_rows_kernel(const double* __restrict__ partial, int n_rows, int nb,
                    float* __restrict__ out) {
  __shared__ double runs[K14_ROWS_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (n_rows + K14_ROWS_WARPS - 1) / K14_ROWS_WARPS;
  const int r1 = min((warp + 1) * per, n_rows);
  double s = 0.0;
  if (b < nb) {
#pragma unroll 8
    for (int r = warp * per; r < r1; ++r) s += partial[(size_t)r * nb + b];
  }
  runs[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && b < nb) {
    double t = runs[0][lane];
    for (int w = 1; w < K14_ROWS_WARPS; ++w) t += runs[w][lane];
    out[b] = (float)t;
  }
}

// Blocks of the sums pass: a function of Mp alone, so the order of the
// sums is one of Mp and nb (the warps a block, k14_sum_warps).
static int k14_sum_blocks(long long Mp) {
  const long long steps = (Mp + K14_STEP - 1) / K14_STEP;
  if (steps > K14_SUM_BLOCKS) return K14_SUM_BLOCKS;
  return steps < 1 ? 1 : (int)steps;
}

// Warps a block of the sums pass: its rows take K14_ROW_WORDS f64 words.
static int k14_sum_warps(int nb) {
  const int w = K14_ROW_WORDS / nb;
  return w > K14_SUM_WARPS ? K14_SUM_WARPS : (w < 1 ? 1 : w);
}

// Workspace bytes: the sums pass's partial rows; 0 for counts.
extern "C" long long es_agg_bucket_reduce_workspace_bytes(int Mp, int nb,
                                                          int sums) {
  if (!sums) return 0;
  return 8LL * k14_sum_blocks(Mp) * nb;
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
  const int blocks = k14_sum_blocks(Mp);
  const int warps = k14_sum_warps(nb);
  const size_t shm = sizeof(double) * (size_t)warps * nb +
                     sizeof(float) * (size_t)warps * 32;
  const bool vec =
      (((uintptr_t)ids | (uintptr_t)docs | (uintptr_t)vals) & 15) == 0;
  auto kernel = vec ? k14_sum_kernel<true> : k14_sum_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  double* partial = (double*)workspace;
  kernel<<<blocks, warps * 32, shm, st>>>(ids, docs, vals, Mp, mask, n_pad,
                                          nb, partial);
  k14_sum_rows_kernel<<<(nb + 31) / 32, K14_ROWS_WARPS * 32, 0, st>>>(
      partial, blocks, nb, (float*)out);
  return (int)cudaGetLastError();
}
