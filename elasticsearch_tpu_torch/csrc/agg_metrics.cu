// K15: masked metrics (count, sum, min, max) over a pair column.
//
// Replaces elasticsearch_tpu/ops/aggs.py:masked_metrics (:100): over the
// pairs whose doc the mask holds (jnp.take with fill, as K12), the count,
// the value sum, min and max; +inf / -inf when nothing matches.
//
// Bound: bytes (4 bytes of doc and 4 of value a pair, streamed once; the
// mask gathered at random, a 32-byte sector a pair as in K12). A
// grid-stride pass keeps (count, sum, min, max) in registers, reduces them
// across the block with cub's fixed tree and writes one partial a block;
// one block then reduces the partials in a fixed order. The grid is a
// function of M alone, so the sum is the same bits on every run.
//
// The count is an integer converted to f32 once: equal to the reference's
// f32 sum of ones below 2^24 matched pairs and exact above it, where the
// reference's rounds. The sum accumulates in f64 and rounds to f32 once.
// Min and max are selections: bitwise.

#include <cub/block/block_reduce.cuh>

#include "agg_common.cuh"
#include "topk_common.cuh"

#define K15_THREADS 256
#define K15_MAX_BLOCKS 1024

struct K15Part {
  long long cnt;
  double sum;
  float mn, mx;
};

struct K15Op {
  __device__ __forceinline__ K15Part operator()(const K15Part& a,
                                                const K15Part& b) const {
    return K15Part{a.cnt + b.cnt, a.sum + b.sum, fminf(a.mn, b.mn),
                   fmaxf(a.mx, b.mx)};
  }
};

__global__ void __launch_bounds__(K15_THREADS)
k15_pass_kernel(const int* __restrict__ docs, const float* __restrict__ vals,
                long long Mp, const unsigned char* __restrict__ mask,
                int n_pad, K15Part* __restrict__ parts) {
  typedef cub::BlockReduce<K15Part, K15_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  K15Part p{0, 0.0, CUDART_INF_F, -CUDART_INF_F};
  const long long stride = (long long)gridDim.x * K15_THREADS;
  for (long long i = (long long)blockIdx.x * K15_THREADS + threadIdx.x;
       i < Mp; i += stride) {
    if (es_gather_mask(mask, n_pad, docs[i])) {
      const float v = vals[i];
      p.cnt += 1;
      p.sum += (double)v;
      p.mn = fminf(p.mn, v);
      p.mx = fmaxf(p.mx, v);
    }
  }
  const K15Part r = Reduce(tmp).Reduce(p, K15Op());
  if (threadIdx.x == 0) parts[blockIdx.x] = r;
}

__global__ void __launch_bounds__(K15_THREADS)
k15_final_kernel(const K15Part* __restrict__ parts, int n_parts,
                 float* __restrict__ out) {
  typedef cub::BlockReduce<K15Part, K15_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  K15Part p{0, 0.0, CUDART_INF_F, -CUDART_INF_F};
  const K15Op op;
  for (int i = threadIdx.x; i < n_parts; i += K15_THREADS) p = op(p, parts[i]);
  const K15Part r = Reduce(tmp).Reduce(p, op);
  if (threadIdx.x == 0) {
    out[0] = (float)r.cnt;
    out[1] = (float)r.sum;
    out[2] = r.mn;
    out[3] = r.mx;
  }
}

static int k15_blocks(long long Mp) {
  long long g = (Mp + K15_THREADS - 1) / K15_THREADS;
  return (int)(g < 1 ? 1 : (g > K15_MAX_BLOCKS ? K15_MAX_BLOCKS : g));
}

// Workspace bytes: one partial a block of the first pass.
extern "C" long long es_agg_metrics_workspace_bytes(int Mp) {
  return (long long)sizeof(K15Part) * k15_blocks(Mp);
}

extern "C" int es_agg_metrics(const int* docs, const float* vals, int Mp,
                              const unsigned char* mask, int n_pad,
                              float* out, void* workspace, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = k15_blocks(Mp);
  K15Part* parts = (K15Part*)workspace;
  k15_pass_kernel<<<blocks, K15_THREADS, 0, st>>>(docs, vals, Mp, mask,
                                                  n_pad, parts);
  k15_final_kernel<<<1, K15_THREADS, 0, st>>>(parts, blocks, out);
  return (int)cudaGetLastError();
}
