// K5: exact f32 re-score of the block-max pruned step's survivors.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:bisect_exact_scores (the
// re-score stage of parallel/dist_search.py:build_pruned_bm25_step).
//
// One thread per (query b, shard s, candidate r). For each term slot q the
// thread takes the lower bound of its candidate in the slot's doc-sorted
// run docs[start, start + len); the slot holds the doc when the bound is
// inside the run and the doc there equals it. Its contribution is
// idfw[q] * impact (round-to-nearest multiply, no FMA contraction), and the
// contributions are summed from the highest slot down with round-to-nearest
// adds: c[Q-1] + c[Q-2] + ... + c[0], the order in which the sorted-merge
// kernel (K1) sums a doc's group, so a survivor's score is bitwise K1's
// score of the same doc. Slots that miss add nothing (x + 0 == x). A
// candidate equal to n_pad is an empty slot: score 0, not found.
//
// Bound: the card's memory rate on the bisect reads (Q binary searches of
// about log2(len) steps per candidate, each step a dependent 4-byte read);
// at the serving shapes (R = 128 candidates, Q = 8, one shard) the launch
// is a few thousand threads, so it is latency bound on the dependent reads.

#include "topk_common.cuh"

#define K5_THREADS 128

__global__ void __launch_bounds__(K5_THREADS)
bisect_exact_scores_kernel(const int* __restrict__ docs,
                           const float* __restrict__ imps, int P,
                           const int* __restrict__ starts,
                           const int* __restrict__ lengths,
                           const float* __restrict__ idfw,
                           const int* __restrict__ cand, int B, int S, int Q,
                           int R, int n_pad, float* __restrict__ out_score,
                           unsigned char* __restrict__ out_found) {
  const long long t = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  if (t >= (long long)B * S * R) return;
  const long long bs = t / R;
  const int s = (int)(bs % S);
  const int b = (int)(bs / S);
  const int doc = cand[t];
  float score = 0.0f;
  bool any = false;
  if (doc < n_pad) {
    const int* ds = docs + (size_t)s * P;
    const float* is = imps + (size_t)s * P;
    for (int q = Q - 1; q >= 0; --q) {
      const int st = starts[bs * Q + q];
      const int end = st + lengths[bs * Q + q];
      int lo = st, hi = end;
      while (lo < hi) {
        int mid = lo + ((hi - lo) >> 1);
        if (ds[mid] < doc) lo = mid + 1; else hi = mid;
      }
      if (lo < end && ds[lo] == doc) {
        score = __fadd_rn(score, __fmul_rn(idfw[(size_t)b * Q + q], is[lo]));
        any = true;
      }
    }
  }
  out_score[t] = score;
  out_found[t] = any ? 1 : 0;
}

extern "C" int es_bisect_exact_scores(const int* docs, const float* imps,
                                      int P, const int* starts,
                                      const int* lengths, const float* idfw,
                                      const int* cand, int B, int S, int Q,
                                      int R, int n_pad, float* out_score,
                                      unsigned char* out_found,
                                      void* stream) {
  long long n = (long long)B * S * R;
  int blocks = (int)((n + K5_THREADS - 1) / K5_THREADS);
  bisect_exact_scores_kernel<<<blocks, K5_THREADS, 0,
                               (cudaStream_t)stream>>>(
      docs, imps, P, starts, lengths, idfw, cand, B, S, Q, R, n_pad,
      out_score, out_found);
  return (int)cudaGetLastError();
}
