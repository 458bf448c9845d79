// K10: rank fusion of a text and a kNN ranking in one id space.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:rrf_fuse_body and
// sum_fuse_body (with _dedupe_first, _rank_contrib, _fused_topk and
// knn_raw_to_score), i.e. the fusion in the `finish` stage of
// parallel/dist_search.py:build_fused_hybrid_step before its rescore, and
// the rescore payload's gather by the fused order.
//
// One block per query over n = na + nb entries (text list, then kNN
// list). An entry takes part iff its value is finite and its position is
// inside its list's window (wt / wk); its id unifies to
// (g / n_pad) * UP + g % n_pad, else it is the pad id. An id's first
// occurrence (its text entry when it has one) scores, a later one drops
// out. The score is the reference's f32 arithmetic, list a first:
//   rrf: 1 / ((rc + rank) + 1) for each list holding the id, summed;
//   sum: text score + knn_raw_to_score(raw) * kboost (0 for an absent side).
// Output order: (score desc, id asc, position asc); entries out of the
// fusion follow in (id asc, position asc) order at -inf (the reference
// leaves their order unspecified), with the pad id. sel is each output's
// position in [text | knn], 0 past the entries. With the rescore payload
// (tsec, tfnd, ksec, kfnd) the launch also writes sec_f and fnd_f, the
// payload of [text | knn] at sel.
//
// Two paths, by n:
//   n <= K10_COUNT_MAX: ranking by counting. The block reads both lists
//     once into shared memory; a hash table of 2 K10_COUNT_MAX slots keyed
//     by id gives each id's first position and its first kNN position (its
//     twin) by shared atomics; each entry's key is (score desc as ordered
//     bits, id), and its output position is the count of entries whose
//     (key, position) is smaller, counted in chunks of 32 entries with one
//     shared atomic add a chunk; one scatter writes the outputs. Five
//     barriers. K10_COUNT_MAX = 512: the counting costs n^2 key compares a
//     query, n a thread of the 512 (at n = 512 about the instruction time of
//     the two bitonic sorts' 2 x 45 barrier-separated stages, at the
//     serving n = 256 a quarter of it), and the block's arrays take 24 KB
//     of static shared memory.
//   n > K10_COUNT_MAX: sorts of (id, position) keys and then of (score,
//     id, position) keys, in shared memory while a row's keys fit it, else
//     in a device-memory workspace (es_fuse_rank_workspace_bytes).
//
// Bound: tiny work per query; latency bound at the serving windows (n =
// 256), where a block per query fills 16 of 132 SMs.

#include "sort_common.cuh"

#define K10_THREADS 512
// the counting path's largest n, its threads, its hash table's slots
#define K10_COUNT_MAX 512
#define K10_COUNT_THREADS 512
#define K10_HASH (2 * K10_COUNT_MAX)
#define K10_EMPTY (-2147483647 - 1)

// knn_raw_to_score: 0 cosine / dot_product, 1 max_inner_product, 2 l2_norm
__device__ __forceinline__ float knn_score(float raw, int sim) {
  if (sim == 0) return __fdiv_rn(__fadd_rn(1.0f, raw), 2.0f);
  if (sim == 1)
    return raw < 0.0f ? __fdiv_rn(1.0f, __fsub_rn(1.0f, raw))
                      : __fadd_rn(raw, 1.0f);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, fmaxf(0.0f, -raw)));
}

// An entry's unified id, or pad_id when it is out of the fusion.
__device__ __forceinline__ int fuse_uid(const float* tvb, const int* tgb,
                                        int na, const float* kvb,
                                        const int* kgb, int wtb, int wkb,
                                        int j, int n_pad_t, int n_pad_k,
                                        int UP, int pad_id) {
  if (j < na) {
    if (tvb[j] > -CUDART_INF_F && j < wtb) {
      const int g = tgb[j];
      return (g / n_pad_t) * UP + g % n_pad_t;
    }
    return pad_id;
  }
  const int p = j - na;
  if (kvb[p] > -CUDART_INF_F && p < wkb) {
    const int g = kgb[p];
    return (g / n_pad_k) * UP + g % n_pad_k;
  }
  return pad_id;
}

// The fused score of an id from its text position pa and kNN position pb
// (-1: absent), in the reference's f32 order.
__device__ __forceinline__ float fuse_score(const float* tvb,
                                            const float* kvb, int pa, int pb,
                                            float rcb, float kbb, int fusion,
                                            int sim) {
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
  return __fadd_rn(sa, sb);
}

// The payload of output slot i from [text | knn] position src.
__device__ __forceinline__ void fuse_payload(
    int src, int na, int nb, int b, const float* tsec,
    const unsigned char* tfnd, const float* ksec, const unsigned char* kfnd,
    float* sec, unsigned char* fnd, size_t i) {
  if (src < na) {
    sec[i] = tsec[(size_t)b * na + src];
    fnd[i] = tfnd[(size_t)b * na + src];
  } else {
    sec[i] = ksec[(size_t)b * nb + (src - na)];
    fnd[i] = kfnd[(size_t)b * nb + (src - na)];
  }
}

// The counting path (n <= K10_COUNT_MAX), one block a query.
__global__ void __launch_bounds__(K10_COUNT_THREADS)
fuse_rank_count_kernel(
    const float* __restrict__ tv, const int* __restrict__ tg, int na,
    const float* __restrict__ kv, const int* __restrict__ kg, int nb,
    const int* __restrict__ wt, const int* __restrict__ wk,
    const float* __restrict__ rc, const float* __restrict__ kboost,
    const float* __restrict__ tsec, const unsigned char* __restrict__ tfnd,
    const float* __restrict__ ksec, const unsigned char* __restrict__ kfnd,
    int n_pad_t, int n_pad_k, int UP, int pad_id, int fusion, int sim,
    int k_out, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_sel, float* __restrict__ out_sec,
    unsigned char* __restrict__ out_fnd) {
  __shared__ unsigned long long key[K10_COUNT_MAX];
  __shared__ float val_s[K10_COUNT_MAX];
  __shared__ int uid_s[K10_COUNT_MAX];
  __shared__ int slot_s[K10_COUNT_MAX];
  __shared__ int rank[K10_COUNT_MAX];
  __shared__ int h_key[K10_HASH];
  __shared__ int h_first[K10_HASH];
  __shared__ int h_knn[K10_HASH];
  const int b = blockIdx.x;
  const int n = na + nb;
  const int tid = threadIdx.x;
  const float* tvb = tv + (size_t)b * na;
  const int* tgb = tg + (size_t)b * na;
  const float* kvb = kv + (size_t)b * nb;
  const int* kgb = kg + (size_t)b * nb;
  const int wtb = wt[b], wkb = wk[b];

  for (int h = tid; h < K10_HASH; h += K10_COUNT_THREADS) {
    h_key[h] = K10_EMPTY;
    h_first[h] = 2147483647;
    h_knn[h] = 2147483647;
  }
  for (int j = tid; j < n; j += K10_COUNT_THREADS) rank[j] = 0;
  __syncthreads();

  // 1. each entry's id, and its slot of the table: the id's first
  // position and first kNN position
  for (int j = tid; j < n; j += K10_COUNT_THREADS) {
    const int uid = fuse_uid(tvb, tgb, na, kvb, kgb, wtb, wkb, j, n_pad_t,
                             n_pad_k, UP, pad_id);
    int h = -1;
    if (uid != pad_id) {
      h = (int)(((unsigned)uid * 2654435761u) >> 22) & (K10_HASH - 1);
      for (;;) {
        const int prev = atomicCAS(&h_key[h], K10_EMPTY, uid);
        if (prev == K10_EMPTY || prev == uid) break;
        h = (h + 1) & (K10_HASH - 1);
      }
      atomicMin(&h_first[h], j);
      if (j >= na) atomicMin(&h_knn[h], j);
    }
    uid_s[j] = uid;
    slot_s[j] = h;
  }
  __syncthreads();

  // 2. the first occurrence of each id scores (k2 = -score), the rest
  // sort at k2 = +inf; the key is (k2's ordered bits, id)
  const float rcb = rc[b], kbb = kboost[b];
  for (int j = tid; j < n; j += K10_COUNT_THREADS) {
    const int uid = uid_s[j];
    const int h = slot_s[j];
    float k2 = CUDART_INF_F;
    if (h >= 0 && h_first[h] == j) {
      int pa, pb;
      if (j < na) {
        const int twin = h_knn[h];
        pa = j;
        pb = twin != 2147483647 ? twin - na : -1;
      } else {
        pa = -1;
        pb = j - na;
      }
      k2 = -fuse_score(tvb, kvb, pa, pb, rcb, kbb, fusion, sim);
    }
    val_s[j] = k2 != CUDART_INF_F ? -k2 : -CUDART_INF_F;
    // -0 and +0 are one score; the ordered bits keep float order
    unsigned u = __float_as_uint(k2 == 0.0f ? 0.0f : k2);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    key[j] = ((unsigned long long)u << 32) |
             (unsigned)(uid ^ (int)0x80000000);
  }
  __syncthreads();

  // 3. each entry's rank: the entries whose (key, position) is smaller,
  // counted a chunk of 32 at a time (one shared add a chunk)
  const int n_ch = (n + 31) >> 5;
  for (int it = tid; it < n_ch * n; it += K10_COUNT_THREADS) {
    const int c = it / n;
    const int i = it - c * n;
    const unsigned long long ki = key[i];
    const int j1 = min(n, (c + 1) << 5);
    int cnt = 0;
    for (int j = c << 5; j < j1; ++j) {
      const unsigned long long kj = key[j];
      cnt += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    if (cnt) atomicAdd(&rank[i], cnt);
  }
  __syncthreads();

  // 4. the scatter
  float* ov = out_vals + (size_t)b * k_out;
  int* oi = out_ids + (size_t)b * k_out;
  int* os = out_sel + (size_t)b * k_out;
  const bool payload = out_sec != nullptr;
  for (int j = tid; j < n; j += K10_COUNT_THREADS) {
    const int r = rank[j];
    if (r >= k_out) continue;
    const float v = val_s[j];
    ov[r] = v;
    oi[r] = v > -CUDART_INF_F ? uid_s[j] : pad_id;
    os[r] = j;
    if (payload)
      fuse_payload(j, na, nb, b, tsec, tfnd, ksec, kfnd, out_sec, out_fnd,
                   (size_t)b * k_out + r);
  }
  for (int i = n + tid; i < k_out; i += K10_COUNT_THREADS) {
    ov[i] = -CUDART_INF_F;
    oi[i] = pad_id;
    os[i] = 0;
    if (payload && n > 0)
      fuse_payload(0, na, nb, b, tsec, tfnd, ksec, kfnd, out_sec, out_fnd,
                   (size_t)b * k_out + i);
  }
}

// The sorting path (n > K10_COUNT_MAX), one block a query.
__global__ void __launch_bounds__(K10_THREADS)
fuse_rank_kernel(const float* __restrict__ tv, const int* __restrict__ tg,
                 int na, const float* __restrict__ kv,
                 const int* __restrict__ kg, int nb,
                 const int* __restrict__ wt, const int* __restrict__ wk,
                 const float* __restrict__ rc,
                 const float* __restrict__ kboost,
                 const float* __restrict__ tsec,
                 const unsigned char* __restrict__ tfnd,
                 const float* __restrict__ ksec,
                 const unsigned char* __restrict__ kfnd, int n_pad_t,
                 int n_pad_k, int UP, int pad_id, int fusion, int sim,
                 int n2, int k_out, float* __restrict__ out_vals,
                 int* __restrict__ out_ids, int* __restrict__ out_sel,
                 float* __restrict__ out_sec,
                 unsigned char* __restrict__ out_fnd, SortKey* workspace) {
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
    if (j < n)
      key = SortKey{0, 0.0f,
                    fuse_uid(tvb, tgb, na, kvb, kgb, wtb, wkb, j, n_pad_t,
                             n_pad_k, UP, pad_id),
                    j};
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
      k2 = -fuse_score(tvb, kvb, pa, pb, rcb, kbb, fusion, sim);
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
    if (out_sec != nullptr && n > 0)
      fuse_payload(sel, na, nb, b, tsec, tfnd, ksec, kfnd, out_sec, out_fnd,
                   (size_t)b * k_out + i);
  }
}

// Workspace bytes of B queries of n entries: none on the counting path, nor
// where a query's sort keys fit a block's shared memory.
extern "C" long long es_fuse_rank_workspace_bytes(int n, int B) {
  return n <= K10_COUNT_MAX ? 0 : es_sort_workspace_bytes(n, B);
}

// fusion: 0 rrf, 1 sum; sim: see knn_score. The payload (tsec, tfnd, ksec,
// kfnd in, out_sec, out_fnd out) is all given or all null. The sorting
// path needs a workspace of B rows of pow2(n) SortKeys when a row does not
// fit a block's shared memory (refused without it).
extern "C" int es_fuse_rank(const float* tv, const int* tg, int na,
                            const float* kv, const int* kg, int nb,
                            const int* wt, const int* wk, const float* rc,
                            const float* kboost, const float* tsec,
                            const unsigned char* tfnd, const float* ksec,
                            const unsigned char* kfnd, int B, int n_pad_t,
                            int n_pad_k, int UP, int pad_id, int fusion,
                            int sim, int k_out, float* out_vals,
                            int* out_ids, int* out_sel, float* out_sec,
                            unsigned char* out_fnd, void* workspace,
                            void* stream) {
  if (fusion < 0 || fusion > 1 || sim < 0 || sim > 2) return ES_ERR_ARG;
  const int given = (tsec != nullptr) + (tfnd != nullptr) +
                    (ksec != nullptr) + (kfnd != nullptr) +
                    (out_sec != nullptr) + (out_fnd != nullptr);
  if (given != 0 && given != 6) return ES_ERR_ARG;
  if (B == 0 || k_out == 0) return 0;
  const int n = na + nb;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= K10_COUNT_MAX) {
    fuse_rank_count_kernel<<<B, K10_COUNT_THREADS, 0, st>>>(
        tv, tg, na, kv, kg, nb, wt, wk, rc, kboost, tsec, tfnd, ksec, kfnd,
        n_pad_t, n_pad_k, UP, pad_id, fusion, sim, k_out, out_vals, out_ids,
        out_sel, out_sec, out_fnd);
    return (int)cudaGetLastError();
  }
  const int n2 = es_pow2_at_least(n);
  size_t shm = workspace != nullptr ? 0 : (size_t)n2 * sizeof(SortKey);
  int e = es_set_shared(fuse_rank_kernel, shm);
  if (e != 0) return e;
  fuse_rank_kernel<<<B, K10_THREADS, shm, st>>>(
      tv, tg, na, kv, kg, nb, wt, wk, rc, kboost, tsec, tfnd, ksec, kfnd,
      n_pad_t, n_pad_k, UP, pad_id, fusion, sim, n2, k_out, out_vals,
      out_ids, out_sel, out_sec, out_fnd, (SortKey*)workspace);
  return (int)cudaGetLastError();
}
