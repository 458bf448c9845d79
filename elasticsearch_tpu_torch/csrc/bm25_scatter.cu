// K16: whole-segment BM25 scatter scorer.
//
// Replaces elasticsearch_tpu/ops/bm25.py:bm25_score_body (:40, jitted by
// _bm25_kernel / get_bm25_kernel): for each of Q postings runs (starts,
// lengths, at most L postings a run) every posting adds
//
//   ((idf * w) * (k1 + 1) * tf) / max(fma(k1, (1 - b) + (b * dl) / avgdl,
//                                          tf), 1e-9)
//
// into scores[doc] (f32[seg_pad]) and one into matched[doc] (i32[seg_pad]),
// with dl = doc_len[doc]. The FMA is where XLA:CPU contracts the reference's
// k1 * (...) + tf (settled by tests/test_torch_segment.py); every other step
// is one rounded f32 operation, written with the _rn intrinsics so that
// nvcc contracts nothing else.
//
// Index rules (the reference's jnp.take(mode="fill") and .at[].add(
// mode="drop")): a postings index or a doc in [-n, 0) wraps to index + n;
// any other index outside [0, n) reads the fill (doc seg_pad, tf 0, dl 0)
// or drops its update.
//
// Order of the sums: XLA applies the scatter's updates in (slot, position)
// order, so each doc's score is ((0 + c_slot0) + c_slot1) + ... Every run
// holds a doc at most once (SegmentBuilder builds runs doc-ascending), so
// one launch a slot, in slot order on one stream, adds without a race and
// with no float atomics: the same bits on every run.
//
// Bound: bytes. Each valid posting reads its doc id, tf and doc length
// (12 bytes) and updates one score and one count (8 bytes read, 8
// written); the outputs are zeroed once (8 bytes a doc). The launches walk
// the real postings (min(length, L) a slot), not Q * L padded slots.

#include "topk_common.cuh"

#define K16_THREADS 256
#define K16_MAX_BLOCKS 2048

__global__ void __launch_bounds__(K16_THREADS)
k16_slot_kernel(const int* __restrict__ docs, const float* __restrict__ tf,
                long long P, const float* __restrict__ doc_len, int n_dl,
                const int* __restrict__ starts,
                const int* __restrict__ lengths,
                const float* __restrict__ idf, const float* __restrict__ w,
                int q, int L, int seg_pad, float avgdl, float k1, float b,
                float* scores, int* matched) {
  const long long len = min(max(lengths[q], 0), L);
  const long long start = starts[q];
  // (idf * w) * (k1 + 1), then 1 - b: the reference's f32 scalars
  const float c0 = __fmul_rn(__fmul_rn(idf[q], w[q]), __fadd_rn(k1, 1.0f));
  const float omb = __fsub_rn(1.0f, b);
  const long long stride = (long long)gridDim.x * K16_THREADS;
  for (long long p = (long long)blockIdx.x * K16_THREADS + threadIdx.x;
       p < len; p += stride) {
    long long idx = start + p;
    if (idx < 0) idx += P;
    int doc = seg_pad;
    float t = 0.0f;
    if (idx >= 0 && idx < P) {
      doc = docs[idx];
      t = tf[idx];
    }
    const long long dd = doc < 0 ? (long long)doc + n_dl : (long long)doc;
    const float dl = (dd >= 0 && dd < n_dl) ? doc_len[dd] : 0.0f;
    const float x = __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl));
    const float norm = __fmaf_rn(k1, x, t);
    const float den = norm != norm ? norm : fmaxf(norm, 1e-9f);
    const float c = __fdiv_rn(__fmul_rn(c0, t), den);
    const long long sd = doc < 0 ? (long long)doc + seg_pad : (long long)doc;
    if (sd >= 0 && sd < seg_pad) {
      scores[sd] = __fadd_rn(scores[sd], c);
      matched[sd] += 1;
    }
  }
}

extern "C" int es_bm25_scatter(const int* docs, const float* tf, long long P,
                               const float* doc_len, int n_dl,
                               const int* starts, const int* lengths,
                               const float* idf, const float* w, int Q,
                               int L, int seg_pad, float avgdl, float k1,
                               float b, float* out_scores, int* out_matched,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out_scores, 0, sizeof(float) * (size_t)seg_pad, st);
  cudaMemsetAsync(out_matched, 0, sizeof(int) * (size_t)seg_pad, st);
  const long long want = ((long long)L + K16_THREADS - 1) / K16_THREADS;
  const int blocks = (int)max(1LL, min(want, (long long)K16_MAX_BLOCKS));
  for (int q = 0; q < Q; ++q) {
    k16_slot_kernel<<<blocks, K16_THREADS, 0, st>>>(
        docs, tf, P, doc_len, n_dl, starts, lengths, idf, w, q, L, seg_pad,
        avgdl, k1, b, out_scores, out_matched);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
