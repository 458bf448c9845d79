// K5: exact f32 re-score of candidates against each query's term runs.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:bisect_exact_scores (the
// re-score stage of parallel/dist_search.py:build_pruned_bm25_step, and the
// rescore query's scores in the bool and hybrid steps).
//
// A candidate's score is the sum over term slots q of idfw[q] * impact,
// where the slot's doc-sorted run docs[start, start + len) holds the
// candidate at its lower bound. The products round to nearest (no FMA
// contraction) and are summed from the highest slot down with round-to-
// nearest adds, c[Q-1] + c[Q-2] + ... + c[0], skipping the slots that miss:
// the order in which the sorted-merge kernel (K1) sums a doc's group, so a
// survivor's score is bitwise K1's score of the same doc. A candidate equal
// to n_pad (or, in the second list, one whose value is -inf) is an empty
// slot: score 0, not found.
//
// Work by (query, shard) pairs, every slot at once. A block takes RC
// candidates of one pair (the concatenation of both lists of a call: the
// hybrid rescore scores its text and its kNN candidates in one launch) and
// goes through the slots in chunks of at most K5_SLOTS, the highest first.
// For each chunk it:
//   1. stages each slot's pivots in shared memory, all loads in flight
//      together: the run itself when it holds at most T docs, else every
//      stride-th doc, stride = ceil(len / T). T = K5_PIVOTS = 128: the
//      staging is most of a call (a block reads Q * T scattered docs), and
//      on an H100 at mix (a)'s and the hybrid rescore's calls T = 128 took
//      0.6-0.8 of the card time of T = 1,024 (kernel_probe.py --kernels k5
//      --variants);
//   2. searches each (candidate, slot) in its slot's pivots (a binary
//      search in shared memory): a short run is decided there, a long one
//      leaves a segment of at most stride - 1 docs between two pivots;
//   3. finds each open segment's lower bound in global memory: groups of g
//      lanes (g the largest power of two up to 32 that lets every open
//      segment have a group at once) read g docs of the segment together,
//      a (g + 1)-ary search that needs ceil(log_{g+1}(stride)) dependent
//      reads (one at stride <= 32 with g = 32, about log2 of it at g = 1);
//   4. reads the impact of every found (candidate, slot), all at once, into
//      c[q][r] in shared memory;
//   5. adds each candidate's c from the chunk's highest slot down to the
//      sum carried from the chunks above it.
// One chunk holds every slot of a query up to Q = K5_SLOTS (256); a longer
// query stages its pivots chunk by chunk, with the same adds in the same
// order. RC (k5_rc) gives about one block an SM. Each run must hold its
// docs in non-decreasing order, as the plane's postings do (the
// reference's bisect assumes it too).
//
// Bound: latency. At the serving shapes (R = 128 candidates, Q = 8, one
// shard, 16 queries) the work is a few thousand searches; the chain a
// (candidate, slot) waits on is the pivots' load, the segment's reads and
// the impact's. RC = 16 at mix (a): 128 blocks.

#include "topk_common.cuh"

#define K5_THREADS 256
// pivots a slot at most (T): a power of two
#define K5_PIVOTS 128
// the pivot table's cells (128 KB), so the slots of a chunk
#define K5_PIVOT_CELLS 32768
#define K5_SLOTS (K5_PIVOT_CELLS / K5_PIVOTS)
// (candidate, slot) pairs a block: RC * min(Q, K5_SLOTS) <= K5_ITEMS
#define K5_ITEMS 2048
// loads a thread has in flight before it stores them (the pivots, the
// impacts)
#define K5_UNROLL 8
// the dynamic shared memory a block has without opting in to more
#define K5_SHARED_DEFAULT (48 * 1024)

// Shared memory of a block of RC candidates and chunks of Qc slots: the
// pivots, five words a slot (start, length, stride, pivots, idfw), three a
// candidate (doc, carried sum, found), four a (candidate, slot) (position,
// segment end, contribution, open-segment list), the list's count.
static size_t k5_shared_bytes(int Qc, int RC) {
  return 4 * ((size_t)Qc * K5_PIVOTS + 5 * (size_t)Qc + 3 * (size_t)RC +
              4 * (size_t)RC * Qc + 1);
}

// Candidates a block: the power of two that gives about one block an SM
// over the pairs' `work` candidates, at most K5_ITEMS / Qc.
static int k5_rc(long long work, int Qc) {
  const long long n_sm = es_sm_count();
  long long rc = 1;
  while (rc * n_sm < work && rc < K5_ITEMS) rc <<= 1;
  long long cap = 1;
  while (cap * 2 * (Qc > 0 ? Qc : 1) <= K5_ITEMS) cap <<= 1;
  return (int)(rc < cap ? rc : cap);
}

// First index in [0, n) of the sorted a[] whose value is >= doc, else n.
__device__ __forceinline__ int k5_lower_bound(const int* a, int n, int doc) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < doc) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(K5_THREADS)
bisect_exact_scores_kernel(const int* __restrict__ docs,
                           const float* __restrict__ imps, int P,
                           const int* __restrict__ starts,
                           const int* __restrict__ lengths,
                           const float* __restrict__ idfw,
                           const int* __restrict__ cand, int R,
                           const int* __restrict__ cand2,
                           const float* __restrict__ vals2, int R2, int S,
                           int Q, int Qc, int n_pad, int RC,
                           float* __restrict__ out_score,
                           unsigned char* __restrict__ out_found,
                           float* __restrict__ out_score2,
                           unsigned char* __restrict__ out_found2) {
  constexpr int T = K5_PIVOTS;
  extern __shared__ int k5_smem[];
  int* piv = k5_smem;                          // [Qc][T]
  int* m_st = piv + (size_t)Qc * T;            // [Qc]
  int* m_len = m_st + Qc;
  int* m_stride = m_len + Qc;
  int* m_npiv = m_stride + Qc;
  float* m_idf = reinterpret_cast<float*>(m_npiv + Qc);
  int* cdoc = reinterpret_cast<int*>(m_idf + Qc);  // [RC]
  float* acc = reinterpret_cast<float*>(cdoc + RC);  // [RC]
  int* acc_any = reinterpret_cast<int*>(acc + RC);   // [RC]
  int* pos = acc_any + RC;                     // [Qc][RC]
  int* seg_hi = pos + (size_t)Qc * RC;         // [Qc][RC]
  float* contrib = reinterpret_cast<float*>(seg_hi + (size_t)Qc * RC);
  int* open = reinterpret_cast<int*>(contrib + (size_t)Qc * RC);
  int* n_open = open + (size_t)Qc * RC;

  const int tid = threadIdx.x;
  const int bs = blockIdx.x;
  const int s = bs % S;
  const int b = bs / S;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, R + R2 - r0);
  const int* ds = docs + (size_t)s * P;
  const float* is = imps + (size_t)s * P;

  // the candidates (each thread keeps its own i's sum across the chunks)
  for (int i = tid; i < nr; i += K5_THREADS) {
    const int r = r0 + i;
    int doc;
    bool live;
    if (r < R) {
      doc = cand[(size_t)bs * R + r];
      live = doc < n_pad;
    } else {
      const size_t e = (size_t)bs * R2 + (r - R);
      doc = cand2[e];
      live = doc < n_pad && (vals2 == nullptr || vals2[e] > -CUDART_INF_F);
    }
    cdoc[i] = live ? doc : n_pad;
    acc[i] = 0.0f;
    acc_any[i] = 0;
  }

  for (int q_hi = Q; q_hi > 0; q_hi -= Qc) {
    const int q0 = q_hi > Qc ? q_hi - Qc : 0;
    const int nq = q_hi - q0;

    // 0. the chunk's runs (the previous chunk's last reads of these and of
    // n_open came before its last barriers)
    for (int q = tid; q < nq; q += K5_THREADS) {
      const size_t e = (size_t)bs * Q + q0 + q;
      const int ln = lengths[e];
      const int stride = ln <= T ? 1 : (ln + T - 1) / T;
      m_st[q] = starts[e];
      m_len[q] = ln;
      m_stride[q] = stride;
      m_npiv[q] = ln <= 0 ? 0 : (ln + stride - 1) / stride;
      m_idf[q] = idfw[(size_t)b * Q + q0 + q];
    }
    if (tid == 0) *n_open = 0;
    __syncthreads();

    // 1. the pivots, every load in flight together (K5_UNROLL a thread
    // before their stores)
    for (int c0 = tid; c0 < nq * T; c0 += K5_THREADS * K5_UNROLL) {
      int v[K5_UNROLL];
#pragma unroll
      for (int u = 0; u < K5_UNROLL; ++u) {
        const int c = c0 + u * K5_THREADS;
        const int q = c / T;
        const int k = c - q * T;
        v[u] = c < nq * T && k < m_npiv[q] ? ds[m_st[q] + k * m_stride[q]]
                                           : 0;
      }
#pragma unroll
      for (int u = 0; u < K5_UNROLL; ++u) {
        const int c = c0 + u * K5_THREADS;
        if (c < nq * T) piv[c] = v[u];
      }
    }
    __syncthreads();

    // 2. each (candidate, slot) in its slot's pivots
    for (int it = tid; it < nq * nr; it += K5_THREADS) {
      const int q = it / nr;
      const int i = it - q * nr;
      const int c = q * RC + i;
      const int doc = cdoc[i];
      const int np = m_npiv[q];
      int p = -1;
      if (doc < n_pad && np > 0) {
        const int* pv = piv + (size_t)q * T;
        const int j = k5_lower_bound(pv, np, doc);
        const int stride = m_stride[q];
        const int ln = m_len[q];
        if (stride == 1 || j == 0) {
          // the run itself, or the doc at or before the first pivot
          p = j * stride < ln && pv[j] == doc ? m_st[q] + j * stride : -1;
        } else {
          // between pivots j - 1 and j: docs (j - 1) * stride + 1 .. the
          // segment's end (pivot j, or the run's end)
          const int lo = (j - 1) * stride + 1;
          const int hi = min(j * stride, ln);
          if (lo >= hi) {
            p = hi < ln && pv[j] == doc ? m_st[q] + hi : -1;
          } else {
            seg_hi[c] = hi;
            p = lo;
            open[atomicAdd(n_open, 1)] = c;
          }
        }
      }
      pos[c] = p;
    }
    __syncthreads();

    // 3. the open segments' lower bounds, g lanes a segment
    const int n_seg = *n_open;
    if (n_seg > 0) {
      int g = 32;
      while (g > 1 && n_seg * g > K5_THREADS) g >>= 1;
      const int lane = tid & 31;
      const int gl = lane & (g - 1);             // lane in the group
      const int gbase = lane - gl;               // the group's first lane
      const unsigned gmask =
          g == 32 ? 0xffffffffu : ((1u << g) - 1) << gbase;
      const int g_shift = __ffs(g) - 1;
      const int per_warp = 32 >> g_shift;
      for (int base = (tid >> 5) * per_warp; base < n_seg;
           base += (K5_THREADS / 32) * per_warp) {
        const int e = base + (lane >> g_shift);
        const bool valid = e < n_seg;
        int c = 0, q = 0, doc = 0, lo = 0, hi = 0, ln = 0;
        const int* d = ds;
        if (valid) {
          c = open[e];
          q = c / RC;
          doc = cdoc[c - q * RC];
          lo = pos[c];
          hi = seg_hi[c];
          ln = m_len[q];
          d = ds + m_st[q];
        }
        // narrow [lo, hi] (the answer, hi included) until g lanes read it
        while (__any_sync(0xffffffffu, valid && hi - lo >= g)) {
          const bool act = valid && hi - lo >= g;
          const int step = act ? (hi - lo + g) / (g + 1) : 1;
          const int idx = lo + (gl + 1) * step - 1;
          const bool less = act && idx < hi && d[idx] < doc;
          const int cnt = __popc(__ballot_sync(0xffffffffu, less) & gmask);
          if (act) {
            // sample cnt (when there is one) is the first at or past doc
            if (cnt < g) hi = min(hi, lo + (cnt + 1) * step - 1);
            lo += cnt * step;
          }
        }
        // the last read: docs lo .. hi (hi when it is inside the run)
        const int idx = lo + gl;
        const bool in = valid && idx <= hi && idx < ln;
        const int v = in ? d[idx] : 0;
        const bool less = in && idx < hi && v < doc;
        const int cnt = __popc(__ballot_sync(0xffffffffu, less) & gmask);
        const int vp = __shfl_sync(0xffffffffu, v, gbase + min(cnt, g - 1));
        if (valid && gl == 0) {
          const int p = lo + cnt;
          pos[c] = p < ln && vp == doc ? m_st[q] + p : -1;
        }
      }
    }
    __syncthreads();

    // 4. the impacts found, all at once
    for (int it0 = tid; it0 < nq * nr; it0 += K5_THREADS * K5_UNROLL) {
      float v[K5_UNROLL];
#pragma unroll
      for (int u = 0; u < K5_UNROLL; ++u) {
        const int it = it0 + u * K5_THREADS;
        const int q = it / nr;
        const int p = it < nq * nr ? pos[q * RC + (it - q * nr)] : -1;
        v[u] = p >= 0 ? is[p] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < K5_UNROLL; ++u) {
        const int it = it0 + u * K5_THREADS;
        const int q = it / nr;
        if (it < nq * nr) contrib[q * RC + (it - q * nr)] =
            __fmul_rn(m_idf[q], v[u]);
      }
    }
    __syncthreads();

    // 5. each candidate's adds, the chunk's highest slot first
    for (int i = tid; i < nr; i += K5_THREADS) {
      float score = acc[i];
      int any = acc_any[i];
      for (int q = nq - 1; q >= 0; --q) {
        const int c = q * RC + i;
        if (pos[c] >= 0) {
          score = __fadd_rn(score, contrib[c]);
          any = 1;
        }
      }
      acc[i] = score;
      acc_any[i] = any;
    }
  }

  for (int i = tid; i < nr; i += K5_THREADS) {
    const int r = r0 + i;
    if (r < R) {
      out_score[(size_t)bs * R + r] = acc[i];
      out_found[(size_t)bs * R + r] = acc_any[i] ? 1 : 0;
    } else {
      out_score2[(size_t)bs * R2 + (r - R)] = acc[i];
      out_found2[(size_t)bs * R2 + (r - R)] = acc_any[i] ? 1 : 0;
    }
  }
}

// cand i32[B, S, R] and, when R2 > 0, cand2 i32[B, S, R2] with vals2
// f32[B, S, R2] (nullable: every entry with a doc below n_pad is live).
// Any Q >= 0 (Q = 0 scores every candidate 0, not found). Refused: a
// negative size, R2 > 0 without cand2, more than 65,535 blocks of a pair's
// candidates.
extern "C" int es_bisect_exact_scores(
    const int* docs, const float* imps, int P, const int* starts,
    const int* lengths, const float* idfw, const int* cand, int R,
    const int* cand2, const float* vals2, int R2, int B, int S, int Q,
    int n_pad, float* out_score, unsigned char* out_found, float* out_score2,
    unsigned char* out_found2, void* stream) {
  if (B < 0 || S < 0 || Q < 0 || R < 0 || R2 < 0 ||
      (R2 > 0 && cand2 == nullptr))
    return ES_ERR_SIZE;
  const long long pairs = (long long)B * S;
  if (pairs == 0 || R + R2 == 0) return 0;
  const int Qc = Q < K5_SLOTS ? Q : K5_SLOTS;
  const int RC = k5_rc(pairs * (R + R2), Qc);
  const int parts = (R + R2 + RC - 1) / RC;
  if (pairs > 2147483647LL || parts > 65535) return ES_ERR_SIZE;
  const size_t shm = k5_shared_bytes(Qc, RC);
  if (shm > K5_SHARED_DEFAULT) {
    const int e = es_set_shared(bisect_exact_scores_kernel, shm);
    if (e != 0) return e;
  }
  dim3 grid((unsigned)pairs, parts);
  bisect_exact_scores_kernel<<<grid, K5_THREADS, shm,
                               (cudaStream_t)stream>>>(
      docs, imps, P, starts, lengths, idfw, cand, R, cand2, vals2, R2, S, Q,
      Qc, n_pad, RC, out_score, out_found, out_score2, out_found2);
  return (int)cudaGetLastError();
}
