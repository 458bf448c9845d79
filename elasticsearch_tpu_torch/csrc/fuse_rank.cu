// K10: rank fusion of a text and a kNN ranking in one id space.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:rrf_fuse_body and
// sum_fuse_body (with _dedupe_first, _rank_contrib, _fused_topk and
// knn_raw_to_score), i.e. the fusion in the `finish` stage of
// parallel/dist_search.py:build_fused_hybrid_step before its rescore.
//
// One block per query over n = na + nb entries (text list, then kNN
// list). An entry takes part iff its value is finite and its position is
// inside its list's window (wt / wk); its id unifies to
// (g / n_pad) * UP + g % n_pad, else it is the pad id. The reference finds
// duplicates with an n x n compare; here the block sorts (id, position) and
// a duplicate is the next key: an id's first occurrence (its text entry
// when it has one) scores, its kNN twin drops out. The score is the
// reference's f32 arithmetic, list a first:
//   rrf: 1 / ((rc + rank) + 1) for each list holding the id, summed;
//   sum: text score + knn_raw_to_score(raw) * kboost (0 for an absent side).
// A second sort orders (score desc, id asc); entries out of the fusion
// follow in (id asc, position asc) order at -inf (the reference leaves
// their order unspecified), with the pad id. sel is each output's
// position in [text | knn], 0 past the entries.
//
// Bound: tiny work per query (two sorts of n entries); latency bound at the
// serving windows, where a block per query fills 16 of 132 SMs.

#include "sort_common.cuh"

#define K10_THREADS 512

// knn_raw_to_score: 0 cosine / dot_product, 1 max_inner_product, 2 l2_norm
__device__ __forceinline__ float knn_score(float raw, int sim) {
  if (sim == 0) return __fdiv_rn(__fadd_rn(1.0f, raw), 2.0f);
  if (sim == 1)
    return raw < 0.0f ? __fdiv_rn(1.0f, __fsub_rn(1.0f, raw))
                      : __fadd_rn(raw, 1.0f);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, fmaxf(0.0f, -raw)));
}

__global__ void __launch_bounds__(K10_THREADS)
fuse_rank_kernel(const float* __restrict__ tv, const int* __restrict__ tg,
                 int na, const float* __restrict__ kv,
                 const int* __restrict__ kg, int nb,
                 const int* __restrict__ wt, const int* __restrict__ wk,
                 const float* __restrict__ rc,
                 const float* __restrict__ kboost, int n_pad_t, int n_pad_k,
                 int UP, int pad_id, int fusion, int sim, int n2, int k_out,
                 float* __restrict__ out_vals, int* __restrict__ out_ids,
                 int* __restrict__ out_sel, SortKey* workspace) {
  extern __shared__ unsigned char smem[];
  const int b = blockIdx.x;
  const int n = na + nb;
  const int tid = threadIdx.x;
  SortKey* a = workspace != nullptr ? workspace + (size_t)b * n2
                                    : reinterpret_cast<SortKey*>(smem);
  const float* tvb = tv + (size_t)b * na;
  const int* tgb = tg + (size_t)b * na;
  const float* kvb = kv + (size_t)b * nb;
  const int* kgb = kg + (size_t)b * nb;
  const int wtb = wt[b], wkb = wk[b];
  const float rcb = rc[b], kbb = kboost[b];

  // 1. (id, position); pads sort after every id, the fill after the pads
  for (int j = tid; j < n2; j += K10_THREADS) {
    SortKey key{1, 0.0f, 2147483647, j};
    if (j < n) {
      int uid = pad_id;
      if (j < na) {
        if (tvb[j] > -CUDART_INF_F && j < wtb) {
          int g = tgb[j];
          uid = (g / n_pad_t) * UP + g % n_pad_t;
        }
      } else {
        int p = j - na;
        if (kvb[p] > -CUDART_INF_F && p < wkb) {
          int g = kgb[p];
          uid = (g / n_pad_k) * UP + g % n_pad_k;
        }
      }
      key = SortKey{0, 0.0f, uid, j};
    }
    a[j] = key;
  }
  block_bitonic_sort(a, n2);

  // 2. the first occurrence of each id scores; k2 = -score, +inf for an
  // entry out of the fusion. Each thread writes only its own keys' k2 and
  // reads only r / k3 / c of its neighbours.
  for (int p = tid; p < n2; p += K10_THREADS) {
    if (a[p].r != 0) continue;
    const int uid = a[p].k3;
    float k2 = CUDART_INF_F;
    if (uid != pad_id && !(p > 0 && a[p - 1].k3 == uid)) {
      const int e = a[p].c;
      const int twin = (p + 1 < n2 && a[p + 1].r == 0 && a[p + 1].k3 == uid)
                           ? a[p + 1].c : -1;
      const int pa = e < na ? e : -1;
      const int pb = e < na ? (twin >= 0 ? twin - na : -1) : e - na;
      float sa = 0.0f, sb = 0.0f;
      if (fusion == 0) {
        if (pa >= 0)
          sa = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(rcb, (float)pa), 1.0f));
        if (pb >= 0)
          sb = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(rcb, (float)pb), 1.0f));
      } else {
        if (pa >= 0) sa = tvb[pa];
        if (pb >= 0) sb = __fmul_rn(knn_score(kvb[pb], sim), kbb);
      }
      k2 = -__fadd_rn(sa, sb);
    }
    a[p].k2 = k2;
  }
  __syncthreads();

  // 3. (score desc, id asc, position asc)
  block_bitonic_sort(a, n2);
  float* ov = out_vals + (size_t)b * k_out;
  int* oi = out_ids + (size_t)b * k_out;
  int* os = out_sel + (size_t)b * k_out;
  for (int i = tid; i < k_out; i += K10_THREADS) {
    float v = -CUDART_INF_F;
    int id = pad_id, sel = 0;
    if (i < n) {
      const SortKey key = a[i];
      sel = key.c;
      if (key.k2 != CUDART_INF_F) {
        v = -key.k2;
        id = key.k3;
      }
    }
    ov[i] = v;
    oi[i] = id;
    os[i] = sel;
  }
}

// Bytes of device-memory workspace for B rows of n entries: 0 when a row's
// keys fit shared memory.
extern "C" long long es_fuse_rank_workspace_bytes(int n, int B) {
  return es_sort_workspace_bytes(n, B);
}

// fusion: 0 rrf, 1 sum; sim: see knn_score.
extern "C" int es_fuse_rank(const float* tv, const int* tg, int na,
                            const float* kv, const int* kg, int nb,
                            const int* wt, const int* wk, const float* rc,
                            const float* kboost, int B, int n_pad_t,
                            int n_pad_k, int UP, int pad_id, int fusion,
                            int sim, int k_out, float* out_vals,
                            int* out_ids, int* out_sel, void* workspace,
                            void* stream) {
  if (fusion < 0 || fusion > 1 || sim < 0 || sim > 2) return ES_ERR_ARG;
  const int n2 = es_pow2_at_least(na + nb);
  size_t shm = workspace != nullptr ? 0 : (size_t)n2 * sizeof(SortKey);
  int e = es_set_shared(fuse_rank_kernel, shm);
  if (e != 0) return e;
  fuse_rank_kernel<<<B, K10_THREADS, shm, (cudaStream_t)stream>>>(
      tv, tg, na, kv, kg, nb, wt, wk, rc, kboost, n_pad_t, n_pad_k, UP,
      pad_id, fusion, sim, n2, k_out, out_vals, out_ids, out_sel,
      (SortKey*)workspace);
  return (int)cudaGetLastError();
}
