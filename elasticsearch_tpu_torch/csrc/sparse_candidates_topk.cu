// K1: sparse candidate scoring + top-k for a batch of queries over the
// shards of one device.
//
// Replaces elasticsearch_tpu/ops/sorted_merge.py:bm25_merge_candidates and
// bm25_topk_merge_body (the body of parallel/dist_search.py:
// build_bm25_topk_step), and inside ops/tiered_bm25.py:tiered_bm25_topk
// the per-query candidate stage with gather_dense_for_candidates fused in.
//
// The reference merges the Q doc-sorted runs with a stable log2(Q)-level
// network and sums each doc group with Q-1 shifted adds; that places a
// doc's group at the posting of the HIGHEST slot holding it and sums
// ((c_qmax + c_q') + c_q'') ... in descending slot order, round to nearest
// (no FMA contraction), and counts the slots holding the doc. A candidate
// then adds the dense tier's contributions accumulated from 0 in slot
// order j = 0..Q-1 (tiered_bm25.py:191-196) and counts those that are
// positive; it is a match iff its count reaches min_should_match. The k
// best matches, keyed (score desc, doc asc), are returned (empty places
// (-inf, n_pad)) with the number of matches less those the dense tier
// also matched (the tiered step's overlap rule).
//
// Index rules: a slot's start clamps to [0, P - L] and its length to
// [0, L]; docs >= n_pad never count; two slots may read the same run. Each
// run's valid prefix holds non-negative docs in strictly ascending order
// (the plane's postings are built so).
//
// Design: the doc tiles of tile_topk.cuh (the pruned route's fallback runs
// Q = 8 slots of up to 2^22 postings: the doc space splits over the card,
// and no posting searches the other runs), with a slot word counting the
// slots that hold a doc (the K1Sparse mode below). Once a tile is summed,
// each present doc gathers its dense-tier values; the dense layout
// [S, n_blk, T, C] keeps C consecutive docs of a row contiguous, so a
// tile's gathers coalesce where its docs are dense.
//
// Bound: bytes. The function needs each valid posting of the batch once
// (8 bytes), a dense value a candidate and weighted slot (2 bytes), and
// the lists and counts written; the tile cells, edge searches and the
// merge stay on the chip.

#include "tile_topk.cuh"

// A slot's word is 1; a doc's group counts its slots. The slot tables hold
// each slot's dense row (through u_ids when given) and weight.
struct K1Sparse {
  static constexpr int kSlotWords = 2;
  const __nv_bfloat16* dense;   // bf16[S, n_blk, T, C], or null
  const int* rid;               // i32[B, S, Q]
  const float* dw;              // f32[B, S, Q]
  const int* u_ids;             // i32[S, U], or null
  int msm, n_blk, T, C, U;
  struct Row {
    size_t dense_s;
  };
  __device__ Row row(int, int s) const {
    return Row{(size_t)s * n_blk * T};
  }
  __device__ void slot(int, int s, size_t oq, int q, int Q,
                       int* words) const {
    if (dense == nullptr) return;
    const int r = rid[oq];
    words[q] = u_ids != nullptr ? u_ids[(size_t)s * U + r] : r;
    words[Q + q] = __float_as_int(dw[oq]);
  }
  __device__ int first(const int*, int) const { return 1; }
  __device__ int add(int cur, const int*, int) const { return cur + 1; }
  __device__ bool offer(const Row& r, const int* words, int Q, int cnt,
                        int doc, float& sc, bool& counted) const {
    int dcnt = 0;
    if (dense != nullptr) {
      float add = 0.0f;
      const size_t col = r.dense_s + (size_t)(doc / C) * T;
      const int off = doc % C;
      for (int j = 0; j < Q; ++j) {
        const float wj = __int_as_float(words[Q + j]);
        if (!(wj > 0.0f)) continue;
        const float v =
            __bfloat162float(dense[(col + words[j]) * C + off]);
        if (v > 0.0f) {
          add = __fadd_rn(add, __fmul_rn(wj, v));
          ++dcnt;
        }
      }
      sc = __fadd_rn(sc, add);
    }
    const bool hit = cnt + dcnt >= msm;
    counted = hit && dcnt == 0;
    return hit;
  }
};

// Blocks of the tile kernel one SM holds at these sizes (0 when none
// fits): the plan's occupancy, for measurement.
extern "C" int es_sparse_candidates_topk_blocks_per_sm(int Q, int k,
                                                       int tshift, int W) {
  return tt_blocks_per_sm<K1Sparse>(Q, k, tshift, W);
}

// dense bf16[S, n_blk, T, C] (or null: no dense tier), rid / dw [B, S, Q],
// u_ids i32[S, U] (or null). The plan and part_* as tt_launch
// (tile_topk.cuh) takes them.
extern "C" int es_sparse_candidates_topk(
    const int* docs, const float* imps, int P, const int* starts,
    const int* lengths, const float* idfw, const void* dense,
    const int* rid, const float* dw, const int* u_ids, int B, int S, int Q,
    int L, int n_pad, int k, int msm, int n_blk, int T, int C, int U,
    int tshift, int tpb, int W, int G, float* part_vals, int* part_docs,
    int* part_count, float* out_vals, int* out_docs, int* out_count,
    void* stream) {
  const K1Sparse mode{(const __nv_bfloat16*)dense, rid, dw, u_ids, msm,
                      n_blk, T, C, U};
  return tt_launch(mode, docs, imps, P, starts, lengths, idfw, B, S, Q, L,
                   n_pad, k, tshift, tpb, W, G, part_vals, part_docs,
                   part_count, out_vals, out_docs, out_count,
                   (cudaStream_t)stream);
}
