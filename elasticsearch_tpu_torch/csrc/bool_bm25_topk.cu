// K9: bool-tree BM25 scoring + top-k for a batch of queries over the
// shards of one device.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:bool_bm25_topk_body, the
// per-(query, shard) stage of parallel/dist_search.py:build_bool_bm25_step
// and of build_fused_hybrid_step's text side. The reference merges the Q
// doc-sorted runs with a stable network and sums each doc group at the
// posting of the HIGHEST slot holding the doc, ((c_qmax + c_q') + c_q'')
// ... in descending slot order, with c_q = impact * idfw_q; it ORs the
// group's clause bits, and a doc is a hit iff it has every required bit,
// no prohibited bit and at least msm should bits among the low nc (the
// reference's unrolled popcount reads only those). Hits are counted and the
// k best, keyed (score desc, doc asc), returned; empty places hold (-inf,
// n_pad). Filter and must_not slots have idfw 0.0: their contributions are
// exact zeros added in the reference's order, and a filter-only doc is a
// hit at 0.0.
//
// Index rules (the reference's dynamic_slice of each run): a slot's start
// clamps to [0, P - L] and its length to [0, L]; docs >= n_pad never
// count; two slots may read the same run; empty slots are skipped.
// Assumed of every run: its valid prefix holds non-negative docs in
// strictly ascending order (the plane's postings are built so).
//
// Design: the doc tiles of tile_topk.cuh, with a slot word of the clause
// bit, ORed over a doc's slots (the K9Bool mode below); a hit has every
// required bit, no prohibited bit and at least msm should bits among the
// low nc, and counts.
//
// Bound: bytes. The function needs each valid posting of the batch once
// (doc and impact, 8 bytes), the slot tables and masks, and the lists and
// counts written. The tile cells, the edge searches (which find their
// probes in L2 once the first has run) and the merge stay on the chip.
// Measured on an H100 (PERF.md's K9 finding), the kernel is bound by its
// tiles' barriers and shared-memory steps, not by its loads: leaving the
// loads out saves about a tenth of its time at bool mix (c).

#include "tile_topk.cuh"

// A slot's word is its clause bit; a doc's group ORs them.
struct K9Bool {
  static constexpr int kSlotWords = 1;
  const int* cbits;   // i32[B, Q]
  const int* req;     // i32[B]: required, prohibited, should masks
  const int* neg;
  const int* shd;
  const int* msm;     // i32[B]: should clauses needed
  int nc;             // the should count reads the low nc bits
  struct Row {
    int req, neg, shd, msm;
  };
  __device__ Row row(int b, int) const {
    return Row{req[b], neg[b], shd[b] & (nc >= 32 ? -1 : (1 << nc) - 1),
               msm[b]};
  }
  __device__ void slot(int b, int, size_t, int q, int Q, int* words) const {
    words[q] = cbits[(size_t)b * Q + q];
  }
  __device__ int first(const int* words, int q) const { return words[q]; }
  __device__ int add(int cur, const int* words, int q) const {
    return cur | words[q];
  }
  __device__ bool offer(const Row& r, const int*, int, int bits, int,
                        float&, bool& counted) const {
    counted = (bits & r.req) == r.req && (bits & r.neg) == 0 &&
              __popc(bits & r.shd) >= r.msm;
    return counted;
  }
};

// Blocks of the tile kernel one SM holds at these sizes (0 when none
// fits): the plan's occupancy, for measurement.
extern "C" int es_bool_bm25_topk_blocks_per_sm(int Q, int k, int tshift,
                                               int W) {
  return tt_blocks_per_sm<K9Bool>(Q, k, tshift, W);
}

// cbits i32[B, Q] (each slot's clause bit), req / neg / shd / msm i32[B]
// (required, prohibited and should clause masks, the should-clause
// minimum), nc the bits the should count reads. The plan and part_* as
// tt_launch (tile_topk.cuh) takes them.
extern "C" int es_bool_bm25_topk(
    const int* docs, const float* imps, int P, const int* starts,
    const int* lengths, const float* idfw, const int* cbits, const int* req,
    const int* neg, const int* shd, const int* msm, int B, int S, int Q,
    int L, int n_pad, int k, int nc, int tshift, int tpb, int W, int G,
    float* part_vals, int* part_docs, int* part_count, float* out_vals,
    int* out_docs, int* out_count, void* stream) {
  const K9Bool mode{cbits, req, neg, shd, msm, nc};
  return tt_launch(mode, docs, imps, P, starts, lengths, idfw, B, S, Q, L,
                   n_pad, k, tshift, tpb, W, G, part_vals, part_docs,
                   part_count, out_vals, out_docs, out_count,
                   (cudaStream_t)stream);
}
