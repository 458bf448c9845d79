// K18: range mask over a (value, doc) pair column.
//
// Replaces elasticsearch_tpu/ops/masks.py:_range_mask_kernel (:34,
// get_range_mask_kernel): mask[doc] (bool[seg_pad]) is true when any of
// the doc's pairs has lo <= value <= hi. The reference's callers pass two
// column types: i32 ranks with i32 bounds (numeric fields,
// NumericFieldData.ranks_dev) and the keyword ordinals converted to f32
// with f32 bounds (past 2^24 ordinals that conversion rounds, and the
// comparison is on the rounded values, as the reference's). A NaN value
// is in no range.
//
// Index rule (the reference's .at[].max(mode="drop")): a doc in
// [-seg_pad, 0) wraps, any other doc outside [0, seg_pad) is dropped (pad
// pairs carry doc seg_pad). Every write stores 1, so the order of writes
// does not matter.
//
// Bound: bytes (4 bytes of value and 4 of doc a pair, one byte written a
// pair in range, the output zeroed once).

#include "topk_common.cuh"

#define K18_THREADS 256
#define K18_MAX_BLOCKS 2048

template <typename T>
__global__ void __launch_bounds__(K18_THREADS)
k18_range_kernel(const T* __restrict__ vals, const int* __restrict__ docs,
                 long long M, T lo, T hi, int seg_pad,
                 unsigned char* mask) {
  const long long stride = (long long)gridDim.x * K18_THREADS;
  for (long long i = (long long)blockIdx.x * K18_THREADS + threadIdx.x;
       i < M; i += stride) {
    const T v = vals[i];
    if (!(v >= lo && v <= hi)) continue;
    const int doc = docs[i];
    const long long sd = doc < 0 ? (long long)doc + seg_pad : (long long)doc;
    if (sd >= 0 && sd < seg_pad) mask[sd] = 1;
  }
}

// is_f32: 0 for i32 values (bounds lo_i, hi_i), 1 for f32 values (bounds
// lo_f, hi_f).
extern "C" int es_range_mask(const void* vals, int is_f32, int lo_i,
                             int hi_i, float lo_f, float hi_f,
                             const int* docs, long long M, int seg_pad,
                             unsigned char* out_mask, void* stream) {
  if (is_f32 != 0 && is_f32 != 1) return ES_ERR_ARG;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out_mask, 0, (size_t)seg_pad, st);
  if (M == 0) return (int)cudaGetLastError();
  const long long want = (M + K18_THREADS - 1) / K18_THREADS;
  const int blocks = (int)min(want, (long long)K18_MAX_BLOCKS);
  if (is_f32)
    k18_range_kernel<float><<<blocks, K18_THREADS, 0, st>>>(
        (const float*)vals, docs, M, lo_f, hi_f, seg_pad, out_mask);
  else
    k18_range_kernel<int><<<blocks, K18_THREADS, 0, st>>>(
        (const int*)vals, docs, M, lo_i, hi_i, seg_pad, out_mask);
  return (int)cudaGetLastError();
}
