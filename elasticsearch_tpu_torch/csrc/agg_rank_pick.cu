// K13: masked rank pick over the count prefix (percentiles) and the HLL
// register max.
//
// Replaces elasticsearch_tpu/ops/aggs.py:_rank_pick (:138) and the tail of
// masked_register_max (:369), both over K12's masked-count prefix c
// (c[i] = masked pairs before pair i, non-decreasing).
//
// Pick mode, one thread per (bucket, rank): the r-th masked value of run
// o sits at lower_bound(c, c[off[o]] + r + 1) - 1 (jnp.searchsorted, side
// left), clipped to [0, M); the two ranks lo and hi are gathered and
// interpolated as fma(f, b, (1 - f) * a), the form XLA:CPU compiles the
// reference's (1 - f) * a + f * b into at config #3's [10, 3] shape.
//
// Register mode, one thread per register v: the run's count is
// c[off[v+1]] - c[off[v]]; its last masked pair (rhos ascend within the
// run, so it holds the max) is lower_bound(c, c[off[v+1]]) - 1; 0 where
// the count is 0.
//
// Bound: latency. A thread does two dependent binary searches of about
// log2(M) steps over a prefix far larger than L2, a few hundred bytes in
// all; B * R is tens of threads on the percentile route. The design keeps
// it to one launch with no shared state, so a pick costs one kernel's
// latency.

#include "topk_common.cuh"

#define K13_THREADS 128

__device__ __forceinline__ long long k13_lower_bound(const int* __restrict__ c,
                                                     long long n, int tgt) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (c[mid] < tgt) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long k13_index(const int* __restrict__ c,
                                               long long n_c, int tgt,
                                               long long M) {
  const long long i = k13_lower_bound(c, n_c, tgt) - 1;
  return i < 0 ? 0 : (i > M - 1 ? M - 1 : i);
}

__global__ void __launch_bounds__(K13_THREADS)
k13_pick_kernel(const int* __restrict__ c, long long n_c,
                const int* __restrict__ offsets, int V,
                const float* __restrict__ vals, long long M,
                const int* __restrict__ ordinals,
                const int* __restrict__ lo, const int* __restrict__ hi,
                const float* __restrict__ frac, int B, int R,
                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * K13_THREADS + threadIdx.x;
  if (i >= (long long)B * R) return;
  const int o = min(max(ordinals[i / R], 0), V);
  const int base = c[offsets[o]];
  const float a = vals[k13_index(c, n_c, base + lo[i] + 1, M)];
  const float b = vals[k13_index(c, n_c, base + hi[i] + 1, M)];
  const float f = frac[i];
  out[i] = __fmaf_rn(f, b, __fmul_rn(__fsub_rn(1.0f, f), a));
}

__global__ void __launch_bounds__(K13_THREADS)
k13_register_kernel(const int* __restrict__ c, long long n_c,
                    const int* __restrict__ offsets, int V,
                    const int* __restrict__ rhos, long long M,
                    int* __restrict__ out) {
  const int v = blockIdx.x * K13_THREADS + threadIdx.x;
  if (v >= V) return;
  const int st = c[offsets[v]];
  const int en = c[offsets[v + 1]];
  out[v] = en > st ? rhos[k13_index(c, n_c, en, M)] : 0;
}

// mode 0: pick (vals f32[M], out f32[B, R]); mode 1: registers (vals =
// rhos i32[M], out i32[V]). V = len(offsets) - 1.
extern "C" int es_agg_rank_pick(const int* c, int n_c, const int* offsets,
                                int V, const void* vals, int M,
                                const int* ordinals, const int* lo,
                                const int* hi, const float* frac, int B,
                                int R, int mode, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    const long long n = (long long)B * R;
    if (n > 0)
      k13_pick_kernel<<<(unsigned)((n + K13_THREADS - 1) / K13_THREADS),
                        K13_THREADS, 0, st>>>(
          c, n_c, offsets, V, (const float*)vals, M, ordinals, lo, hi, frac,
          B, R, (float*)out);
  } else if (mode == 1) {
    if (V > 0)
      k13_register_kernel<<<(V + K13_THREADS - 1) / K13_THREADS, K13_THREADS,
                            0, st>>>(c, n_c, offsets, V, (const int*)vals, M,
                                     (int*)out);
  } else {
    return ES_ERR_ARG;
  }
  return (int)cudaGetLastError();
}
