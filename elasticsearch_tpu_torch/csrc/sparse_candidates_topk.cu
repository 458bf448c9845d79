// K1: sparse candidate scoring + top-k for a batch of queries over the
// shards of one device.
//
// Replaces elasticsearch_tpu/ops/sorted_merge.py:bm25_merge_candidates and
// bm25_topk_merge_body (the body of parallel/dist_search.py:
// build_bm25_topk_step), and inside ops/tiered_bm25.py:tiered_bm25_topk
// the per-query candidate stage with gather_dense_for_candidates fused in.
//
// One block per (query b, shard s); threads walk the Q*L postings of the
// query's runs (only the valid prefix of each run). The reference merges the
// Q doc-sorted runs with a stable log2(Q)-level network and sums each doc
// group with Q-1 shifted adds; that places a doc's group at the posting of
// the HIGHEST slot holding it and sums ((c_qmax + c_q') + c_q'') ... in
// descending slot order. Here each posting binary-searches its doc in the
// other runs instead: the posting in the highest slot that holds the doc
// owns the group and sums the lower slots' contributions in descending slot
// order with round-to-nearest adds and multiplies (no FMA contraction), so
// scores are bitwise those of the reference. The owner then adds the dense
// tier's contributions accumulated from 0 in slot order j = 0..Q-1
// (tiered_bm25.py:191-196), applies min_should_match, counts, and offers
// (score, doc) to a block-wide running top-k keyed (score desc, doc asc).
//
// Bound: data-dependent. The work is the valid postings of the batch
// (8 bytes each, read once), (Q-1) binary searches per posting in runs that
// sit in L2, and Q dense-row gathers per owner; at the serving shapes the
// card's memory rate bounds it (bytes: valid postings + gathered dense
// values). With one block per (b, s), a batch of 64 queries fills 64 of
// the card's 132 SMs: this simple form is latency bound on the searches.

#include "topk_common.cuh"

#define K1_THREADS 1024

__device__ __forceinline__ int lower_bound_run(const int* run, int n,
                                               int doc) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (run[mid] < doc) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// kTopShared: the running top-k sits in shared memory (a template argument,
// so the compiler addresses it as shared).
template <bool kTopShared>
__global__ void __launch_bounds__(K1_THREADS)
sparse_candidates_topk_kernel(
    const int* __restrict__ docs, const float* __restrict__ imps, int P,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    const float* __restrict__ idfw, const __nv_bfloat16* __restrict__ dense,
    const int* __restrict__ rid, const float* __restrict__ dw,
    const int* __restrict__ u_ids, int B, int S, int Q, int L, int n_pad,
    int k, int msm, int n_blk, int T, int C, int U,
    float* __restrict__ out_vals, int* __restrict__ out_docs,
    int* __restrict__ out_count) {
  // dynamic shared memory: the candidate buffer, the per-slot run table,
  // then the running top-k when it fits (else it lives in the output)
  extern __shared__ unsigned char smem[];
  float* buf_s = reinterpret_cast<float*>(smem);            // [THREADS]
  int* buf_d = reinterpret_cast<int*>(buf_s + K1_THREADS);   // [THREADS]
  int* st_q = buf_d + K1_THREADS;                            // [Q]
  int* ln_q = st_q + Q;                                      // [Q]
  int* row_q = ln_q + Q;                                     // [Q]
  int* pre_q = row_q + Q;                                    // [Q + 1]
  float* w_q = reinterpret_cast<float*>(pre_q + Q + 1);      // [Q]
  float* dw_q = w_q + Q;                                     // [Q]
  float* tail = dw_q + Q;
  __shared__ int filled, ncand[3], n_match, n_overlap;

  const int b = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const size_t o_bs = (size_t)b * S + s;
  float* top_s = kTopShared ? tail : out_vals + o_bs * k;
  int* top_d = kTopShared ? reinterpret_cast<int*>(tail + k)
                             : out_docs + o_bs * k;
  const int tid = threadIdx.x;
  const int* docs_s = docs + (size_t)s * P;
  const float* imps_s = imps + (size_t)s * P;

  for (int q = tid; q < Q; q += K1_THREADS) {
    size_t o = o_bs * Q + q;
    // dynamic_slice clamps the start so that start + L stays in the table
    int st = starts[o];
    st = st < 0 ? 0 : (st > P - L ? P - L : st);
    int ln = lengths[o];
    ln = ln < 0 ? 0 : (ln > L ? L : ln);
    st_q[q] = st;
    ln_q[q] = ln;
    w_q[q] = idfw[(size_t)b * Q + q];
    if (dense != nullptr) {
      int r = rid[o];
      row_q[q] = u_ids != nullptr ? u_ids[(size_t)s * U + r] : r;
      dw_q[q] = dw[o];
    }
  }
  if (tid == 0) {
    filled = 0;
    ncand[0] = 0;
    n_match = 0;
    n_overlap = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int q = 0; q < Q; ++q) {
      pre_q[q] = acc;
      acc += ln_q[q];
    }
    pre_q[Q] = acc;
  }
  __syncthreads();

  RunningTopK top{top_s, top_d, &filled, k};
  CandBuffer cand{buf_s, buf_d, ncand};
  const int total = pre_q[Q];
  const size_t dense_s = (size_t)s * n_blk * T;

  int round = 0;
  for (int base = 0; base < total; base += K1_THREADS, ++round) {
    cand.reset_next(round);
    int t = base + tid;
    if (t < total) {
      int q = 0;
      while (t >= pre_q[q + 1]) ++q;
      int i = t - pre_q[q];
      int doc = docs_s[st_q[q] + i];
      bool owner = doc < n_pad;
      for (int q2 = q + 1; owner && q2 < Q; ++q2) {
        int n2 = ln_q[q2];
        if (n2 == 0) continue;
        const int* run = docs_s + st_q[q2];
        int p = lower_bound_run(run, n2, doc);
        if (p < n2 && run[p] == doc) owner = false;
      }
      if (owner) {
        float sc = __fmul_rn(imps_s[st_q[q] + i], w_q[q]);
        int cnt = 1;
        for (int q2 = q - 1; q2 >= 0; --q2) {
          int n2 = ln_q[q2];
          if (n2 == 0) continue;
          const int* run = docs_s + st_q[q2];
          int p = lower_bound_run(run, n2, doc);
          if (p < n2 && run[p] == doc) {
            sc = __fadd_rn(sc, __fmul_rn(imps_s[st_q[q2] + p], w_q[q2]));
            ++cnt;
          }
        }
        int dcnt = 0;
        if (dense != nullptr) {
          float add = 0.0f;
          const size_t col = (size_t)(doc / C) * T;
          const int off = doc % C;
          for (int j = 0; j < Q; ++j) {
            float wj = dw_q[j];
            if (!(wj > 0.0f)) continue;
            float r = __bfloat162float(
                dense[(dense_s + col + row_q[j]) * C + off]);
            if (r > 0.0f) {
              add = __fadd_rn(add, __fmul_rn(wj, r));
              ++dcnt;
            }
          }
          sc = __fadd_rn(sc, add);
          cnt += dcnt;
        }
        if (cnt >= msm) {
          atomicAdd(&n_match, 1);
          if (dcnt > 0) atomicAdd(&n_overlap, 1);
          if (top.beats(sc, doc)) cand.push(round, sc, doc);
        }
      }
    }
    cand.flush(round, top);
  }
  __syncthreads();
  top.write(out_vals + o_bs * k, out_docs + o_bs * k, n_pad);
  if (tid == 0) out_count[o_bs] = n_match - n_overlap;
}

extern "C" int es_sparse_candidates_topk(
    const int* docs, const float* imps, int P, const int* starts,
    const int* lengths, const float* idfw, const void* dense,
    const int* rid, const float* dw, const int* u_ids, int B, int S, int Q,
    int L, int n_pad, int k, int msm, int n_blk, int T, int C, int U,
    float* out_vals, int* out_docs, int* out_count, void* stream) {
  size_t shm = (size_t)K1_THREADS * 8 + (size_t)Q * 24 + 4;
  const bool top_shared =
      shm + (size_t)k * 8 <= (size_t)es_max_shared_bytes();
  if (top_shared) shm += (size_t)k * 8;
  auto kernel = top_shared ? sparse_candidates_topk_kernel<true>
                           : sparse_candidates_topk_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  kernel<<<B * S, K1_THREADS, shm, (cudaStream_t)stream>>>(
      docs, imps, P, starts, lengths, idfw,
      (const __nv_bfloat16*)dense, rid, dw, u_ids, B, S, Q, L, n_pad, k, msm,
      n_blk, T, C, U, out_vals, out_docs, out_count);
  return (int)cudaGetLastError();
}
