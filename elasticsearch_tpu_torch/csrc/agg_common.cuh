// Shared piece of the aggregation kernels K12 (agg_masked_scan.cu), K14
// (agg_bucket_reduce.cu) and K15 (agg_metrics.cu): the mask gather at a
// pair's doc, elasticsearch_tpu/ops/aggs.py's jnp.take(mask, docs,
// mode="fill") rule. A doc in [-n_pad, 0) wraps to doc + n_pad; any other
// doc outside [0, n_pad) gathers false (the pad sentinel is n_pad).
#pragma once

__device__ __forceinline__ bool es_gather_mask(const unsigned char* mask,
                                               int n_pad, int doc) {
  long long d = doc < 0 ? (long long)doc + n_pad : (long long)doc;
  return d >= 0 && d < n_pad && mask[d] != 0;
}
