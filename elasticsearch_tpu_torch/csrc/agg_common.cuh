// Shared piece of the aggregation kernels K12 (agg_masked_scan.cu), K14
// (agg_bucket_reduce.cu) and K15 (agg_metrics.cu): the mask gather at a
// pair's doc, elasticsearch_tpu/ops/aggs.py's jnp.take(mask, docs,
// mode="fill") rule. A doc in [-n_pad, 0) wraps to doc + n_pad; any other
// doc outside [0, n_pad) gathers false (the pad sentinel is n_pad). K12
// gathers the same rule from the mask packed one bit a doc
// (es_gather_bits).
#pragma once

__device__ __forceinline__ bool es_gather_mask(const unsigned char* mask,
                                               int n_pad, int doc) {
  long long d = doc < 0 ? (long long)doc + n_pad : (long long)doc;
  return d >= 0 && d < n_pad && mask[d] != 0;
}

// An L2 policy that keeps what it tags resident ahead of other lines.
__device__ __forceinline__ unsigned long long es_l2_evict_last() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// The same gather from the mask packed 32 docs a word (bit d & 31 of word
// d >> 5), the word read under the L2 policy ``pol``.
__device__ __forceinline__ bool es_gather_bits(const unsigned* bits,
                                               int n_pad, int doc,
                                               unsigned long long pol) {
  long long d = doc < 0 ? (long long)doc + n_pad : (long long)doc;
  if (d < 0 || d >= n_pad) return false;
  unsigned w;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(w)
      : "l"(bits + (d >> 5)), "l"(pol));
  return (w >> (d & 31)) & 1u;
}
