// K17: postings-run match counts.
//
// Replaces elasticsearch_tpu/ops/masks.py:_postings_match_kernel (:16,
// get_postings_match_kernel): the same gather of Q postings runs (starts,
// lengths, at most L postings a run) as K16, and for each valid posting
// one added to matched[doc] (i32[seg_pad]); callers derive masks (> 0 any,
// == Q all). A run may hold a doc more than once (a prefix query passes
// one run over several terms' postings): each occurrence counts.
//
// Index rules as K16 (the reference's jnp.take fill and .at[].add drop): a
// postings index or a doc in [-n, 0) wraps, any other index outside
// [0, n) reads the fill doc seg_pad or drops its update.
//
// Integer atomics: exact in any order, so one launch covers every slot
// (blockIdx.y a slot, a grid-stride loop over its real postings).
//
// Bound: bytes (4 bytes of doc id a valid posting, one 4-byte count
// updated, the output zeroed once).

#include "topk_common.cuh"

#define K17_THREADS 256
#define K17_MAX_BLOCKS 1024
#define K17_MAX_Y 65535

__global__ void __launch_bounds__(K17_THREADS)
k17_match_kernel(const int* __restrict__ docs, long long P,
                 const int* __restrict__ starts,
                 const int* __restrict__ lengths, int q0, int L,
                 int seg_pad, int* matched) {
  const int q = q0 + blockIdx.y;
  const long long len = min(max(lengths[q], 0), L);
  const long long start = starts[q];
  const long long stride = (long long)gridDim.x * K17_THREADS;
  for (long long p = (long long)blockIdx.x * K17_THREADS + threadIdx.x;
       p < len; p += stride) {
    long long idx = start + p;
    if (idx < 0) idx += P;
    const int doc = (idx >= 0 && idx < P) ? docs[idx] : seg_pad;
    const long long sd = doc < 0 ? (long long)doc + seg_pad : (long long)doc;
    if (sd >= 0 && sd < seg_pad) atomicAdd(&matched[sd], 1);
  }
}

extern "C" int es_postings_match(const int* docs, long long P,
                                 const int* starts, const int* lengths,
                                 int Q, int L, int seg_pad, int* out_matched,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out_matched, 0, sizeof(int) * (size_t)seg_pad, st);
  const long long want = ((long long)L + K17_THREADS - 1) / K17_THREADS;
  const int bx = (int)max(1LL, min(want, (long long)K17_MAX_BLOCKS));
  for (int q0 = 0; q0 < Q; q0 += K17_MAX_Y) {
    const dim3 grid(bx, min(Q - q0, K17_MAX_Y));
    k17_match_kernel<<<grid, K17_THREADS, 0, st>>>(
        docs, P, starts, lengths, q0, L, seg_pad, out_matched);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
