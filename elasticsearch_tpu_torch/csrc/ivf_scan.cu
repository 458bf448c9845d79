// K7: the IVF scan: every (query, shard)'s window of the r_cand best rows
// of the quantized tier over the probed union.
//
// Replaces the scan half of elasticsearch_tpu/parallel/dist_search.py:
// build_ivf_knn_step: the jnp.take of the probed-union blocks, the
// dequantized score scale * (qq . c) + off * sum(qq) (l2: (2 s - |v|^2) -
// |q|^2, |v|^2 gathered by the row id clipped to n_pad - 1), the mask of
// rows that are padding or whose cluster the query did not probe, and the
// lax.scan carried top-r_cand window. The window's ids are the positions
// p * BLK + i of the gathered union, ordered (value desc, position asc),
// -inf and NaN scores left out, empty slots (-inf, P * BLK); K8
// (ivf_rerank.cu) re-scores it. Each dot product is a chain of f32 FMAs in
// ascending d, so a row scores the same bits on either path.
//
// Work goes by probed (query, gathered block) pairs, the window formed in
// the same call. Both paths start with
//  - k7_mask_kernel, a block a gathered block (and a tile of 32 queries):
//    the tile's probe bitmaps in shared memory, 16 queries' at a time, one
//    thread a row tests its cluster, the block ORs the bits into the
//    block's query mask. The padding block NB reads no row. Its blocks also
//    zero the call's per-(query, shard) counters, so no memset is needed.
// Then G parts a (query, shard) each take every G-th gathered block the
// query probes (k7_part_scan): a thread a row, only the rows of the
// query's clusters, the metadata once, the code row by 16-byte loads.
//  - The window path (r_cand <= K7_WINDOW_MAX), k7_scan_kernel: a block a
//    part keeps a list of the r_cand best keys in shared memory (a
//    candidate buffer against the list's threshold, reduced to the list by
//    a radix select when it may fill); the last part of a (query, shard)
//    to arrive (a counter the mask kernel zeroed) selects the window from
//    the G lists.
//  - The deep path (larger windows), k7_deep_kernel: one cooperative
//    launch, a block an SM, grid barriers between its phases. A window of
//    thousands of keys does not fit a block's shared memory, and the parts'
//    lists would carry it through every step, so it selects by counting
//    instead: the parts score their rows and histogram the keys' top 11
//    bits into the (query, shard)'s bins; after a barrier one block a
//    (query, shard) finds the bucket of the r_cand-th key. When the keys up
//    to that bucket fit the survivor buffer (2 r_cand) the parts score their
//    rows again and append those keys; a crowded bucket is histogrammed on
//    its next 11 bits first (another scoring pass, up to six levels: the
//    64-bit key is unique). The survivors are sorted in chunks of K7_SCH
//    keys (a block merge sort), and each chunk's block places its keys by
//    their ranks in the other chunks (binary searches), keeping the first
//    r_cand. The probed codes are a few MB that stay in L2, so scoring
//    twice costs less than carrying the window through every step.
//
// Bound: latency and launch. At the repository's IVF shape (2^20 rows, d =
// 64, nlist 1024, nprobe 8, B = 16) a batch reads a few MB of codes and
// metadata, microseconds at the card's memory rate, and scores about
// 136,000 (row, query) pairs.

#include <cooperative_groups.h>
#include <cub/block/block_merge_sort.cuh>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sort_common.cuh"

namespace cg = cooperative_groups;

#define K7_THREADS 256       // threads of a mask block
#define K7_SCAN_THREADS 1024 // threads of a scan block (either path)
#define K7_WORDS 4096        // mask words a scan block reads a round
#define K7_QT 32             // queries a mask word
#define K7_MQ 16             // probe bitmaps a mask block holds at once
#define K7_CB 2048           // candidates a window-path block buffers
#define K7_WINDOW_MAX 1024   // the largest window of the window path
#define K7_MAX_PARTS 16      // scan blocks a (query, shard) at most
#define K7_MERGE_MAX 8192    // parts x window entries the last block merges
// the deep path
#define K7_BINS 2048         // bins of a level's histogram (11 bits)
#define K7_LEVELS 6          // digits of the 64-bit key: 5 x 11 + 9 bits
#define K7_SCH 2048          // survivors a block sorts at a time
#define K7_REC_WORDS 2064    // a (query, shard)'s state and histogram
#define K7_DEEP_MAX (1 << 29)  // the largest window (2 r_cand survivors)

typedef unsigned long long u64;

// A window entry as one key, ascending = better: the score's bits' order
// (-0 ordered as +0, value desc), then the position, then a bit that
// keeps a -0 score's sign. Positions are below 2^31.
__device__ __forceinline__ u64 k7_key(float sc, int pos) {
  unsigned u = __float_as_uint(sc);
  const unsigned negz = u == 0x80000000u;
  if (negz) u = 0u;
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)(~ord) << 32) | ((u64)(unsigned)pos << 1) | negz;
}

__device__ __forceinline__ void k7_unkey(u64 key, float* v, int* pos) {
  const unsigned ord = ~(unsigned)(key >> 32);
  unsigned u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  if (key & 1ull) u = 0x80000000u;
  *v = __uint_as_float(u);
  *pos = (int)((unsigned)(key & 0xFFFFFFFFull) >> 1);
}

// The inputs every scan block reads.
struct K7Args {
  const void* codes;
  const float* scale;
  const float* off;
  const int* rowid;
  const int* rcl;
  const float* vn;
  const float* qsum;
  const float* qn;
  const unsigned* qmask;  // [query tile][S][P], from k7_mask_kernel
  const int* u_blocks;
  int is_bf16, S, NB1, BLK, D, n_pad, nlist, P, l2, vec;
};

// A scan block's list of the gathered blocks its part takes in a round of
// mask words: p and u_blocks[p].
struct K7Mine {
  int p[K7_WORDS], u[K7_WORDS];
  int wsum[K7_SCAN_THREADS / 32];
  int n;
};

// Query q's values in q_s and its probed clusters as a bitmap in bm; all
// threads, a barrier after.
__device__ void k7_query_setup(float* q_s, unsigned* bm, const float* qq,
                               const int* probed, int q, int D, int nlist,
                               int nprobe) {
  const int nw = (nlist + 31) / 32;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) bm[e] = 0u;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    q_s[d] = qq[(size_t)q * D + d];
  __syncthreads();
  for (int e = threadIdx.x; e < nprobe; e += blockDim.x) {
    const int c = probed[(size_t)q * nprobe + e];
    if (c >= 0 && c < nlist) atomicOr(&bm[c / 32], 1u << (c % 32));
  }
  __syncthreads();
}

// The dequantized score of the row at src: the dot product as a chain of
// f32 FMAs in ascending d, the code row by 16-byte loads where aligned.
__device__ __forceinline__ float k7_row_score(const K7Args& a, size_t src,
                                              const float* q_s, float sc_r,
                                              float of_r, float vn_r,
                                              float qs_q, float qn_q) {
  float acc = 0.0f;
  const int D = a.D;
  if (a.is_bf16) {
    const __nv_bfloat16* row =
        static_cast<const __nv_bfloat16*>(a.codes) + src * D;
    if (a.vec) {
      for (int d0 = 0; d0 < D; d0 += 8) {
        const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(row + d0));
        const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          acc = fmaf(__uint_as_float(w[h] << 16), q_s[d0 + 2 * h], acc);
          acc = fmaf(__uint_as_float(w[h] & 0xFFFF0000u), q_s[d0 + 2 * h + 1],
                     acc);
        }
      }
    } else {
      for (int d = 0; d < D; ++d)
        acc = fmaf(__bfloat162float(row[d]), q_s[d], acc);
    }
  } else {
    const int8_t* row = static_cast<const int8_t*>(a.codes) + src * D;
    if (a.vec) {
      for (int d0 = 0; d0 < D; d0 += 16) {
        const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(row + d0));
        const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc = fmaf((float)(int8_t)(w[h] >> (8 * b)), q_s[d0 + 4 * h + b],
                       acc);
      }
    } else {
      for (int d = 0; d < D; ++d) acc = fmaf((float)row[d], q_s[d], acc);
    }
  }
  float sc = __fadd_rn(__fmul_rn(sc_r, acc), __fmul_rn(of_r, qs_q));
  if (a.l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vn_r), qn_q);
  return sc;
}

// Part j of G of query q's rows in shard s: the gathered blocks q probes
// (bits of qmask, in p order) dealt round the G parts, their rows taken
// K7_SCAN_THREADS at a time, a thread a row. At each step every thread of
// the block calls before() (after a barrier), then visit(key, live) with
// its row's key (live: the row is real, its cluster probed, its score
// neither -inf nor NaN). q_s and bm hold the query (k7_query_setup).
template <typename Before, typename Visit>
__device__ void k7_part_scan(const K7Args& a, int q, int s, int j, int G,
                             const float* q_s, const unsigned* bm, K7Mine* mn,
                             Before before, Visit visit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float qs_q = a.qsum[q], qn_q = a.l2 ? a.qn[q] : 0.0f;
  const unsigned* mrow = a.qmask + ((size_t)(q / K7_QT) * a.S + s) * a.P;
  const int* urow = a.u_blocks + (size_t)s * a.P;
  const unsigned qbit = 1u << (q % K7_QT);
  constexpr int per = K7_WORDS / K7_SCAN_THREADS;
  int seen = 0;  // probed blocks in the rounds before

  for (int p0 = 0; p0 < a.P; p0 += K7_WORDS) {
    // a round's mask words, `per` consecutive words a thread, all loaded
    // at once; this part takes every G-th probed block in p order
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int p = p0 + tid * per + i;
      if (p < a.P && (mrow[p] & qbit)) bits |= 1u << i;
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) mn->wsum[warp] = incl;
    if (tid == 0) mn->n = 0;
    __syncthreads();  // also: the previous round's rows are done
    int ord = seen + incl - cnt;
    for (int w = 0; w < K7_SCAN_THREADS / 32; ++w) {
      if (w < warp) ord += mn->wsum[w];
      seen += mn->wsum[w];
    }
#pragma unroll
    for (int i = 0; i < per; ++i) {
      if ((bits >> i) & 1u) {
        if (ord % G == j) {
          const int p = p0 + tid * per + i;
          const int at = atomicAdd(&mn->n, 1);
          mn->p[at] = p;
          mn->u[at] = urow[p];
        }
        ++ord;
      }
    }
    __syncthreads();
    const int rows = mn->n * a.BLK;
    for (int f0 = 0; f0 < rows; f0 += K7_SCAN_THREADS) {
      __syncthreads();
      before();
      const int f = f0 + tid;
      u64 key = ~0ULL;
      bool live = false;
      if (f < rows) {
        const int i = f / a.BLK, r = f - i * a.BLK;
        const size_t src = ((size_t)s * a.NB1 + mn->u[i]) * a.BLK + r;
        const int cl = a.rcl[src], rid = a.rowid[src];
        if (rid < a.n_pad && cl >= 0 && cl < a.nlist &&
            ((bm[cl / 32] >> (cl % 32)) & 1u)) {
          const float vn_r =
              a.l2 ? a.vn[(size_t)s * a.n_pad + min(max(rid, 0), a.n_pad - 1)]
                   : 0.0f;
          const float sc = k7_row_score(a, src, q_s, a.scale[src], a.off[src],
                                        vn_r, qs_q, qn_q);
          live = sc > -CUDART_INF_F;  // -inf and NaN take no part
          if (live) key = k7_key(sc, mn->p[i] * a.BLK + r);
        }
      }
      visit(key, live);
    }
  }
}

// ---------------------------------------------------------------------------
// The mask kernel (both paths)
// ---------------------------------------------------------------------------

// Which queries of a tile of K7_QT probe a cluster in gathered block p of
// shard s: qmask[(tile, s, p)], one bit a query (0 for the padding block
// NB, whose rows are not read). The tile's probe bitmaps are built K7_MQ
// queries at a time, so shared memory holds K7_MQ bitmaps at most. The
// tile's blocks also zero zw words a (query, shard) at zero + (q S + s)
// zw (the window path's arrival counters, the deep path's states and
// histograms), dealt round the blocks, and block (0, 0, 0) the deep path's
// K7_LEVELS level counters at ctl.
__global__ void __launch_bounds__(K7_THREADS)
k7_mask_kernel(const int* __restrict__ rowid, const int* __restrict__ rcl,
               const int* __restrict__ probed,
               const int* __restrict__ u_blocks, int B, int S, int NB1,
               int BLK, int n_pad, int nlist, int nprobe, int P,
               unsigned* __restrict__ qmask, unsigned* __restrict__ zero,
               int zw, unsigned* __restrict__ ctl) {
  extern __shared__ unsigned k7_bm[];  // [K7_MQ][nw]
  __shared__ unsigned acc_s;
  const int p = blockIdx.x, s = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * K7_QT, nq = min(K7_QT, B - q0);
  const int tid = threadIdx.x;
  const int nz = nq * zw;  // at most K7_QT * K7_REC_WORDS
  for (long long e = (long long)p * K7_THREADS + tid; e < nz;
       e += (long long)P * K7_THREADS) {
    const int ei = (int)e;
    zero[((size_t)(q0 + ei / zw) * S + s) * zw + ei % zw] = 0u;
  }
  if (ctl != nullptr && p == 0 && s == 0 && qt == 0 && tid < K7_LEVELS)
    ctl[tid] = 0u;
  const int u = u_blocks[(size_t)s * P + p];
  unsigned* out = qmask + ((size_t)qt * S + s) * P + p;
  if (u < 0 || u >= NB1 - 1) {  // block NB: all padding
    if (tid == 0) *out = 0u;
    return;
  }
  const int nw = (nlist + 31) / 32;
  if (tid == 0) acc_s = 0u;
  unsigned m = 0u;
  for (int qa = 0; qa < nq; qa += K7_MQ) {
    const int nm = min(K7_MQ, nq - qa);
    __syncthreads();  // the previous queries' tests are done
    for (int e = tid; e < nm * nw; e += K7_THREADS) k7_bm[e] = 0u;
    __syncthreads();
    for (int e = tid; e < nm * nprobe; e += K7_THREADS) {
      const int q = e / nprobe;
      const int c = probed[(size_t)(q0 + qa + q) * nprobe + e % nprobe];
      if (c >= 0 && c < nlist)
        atomicOr(&k7_bm[q * nw + c / 32], 1u << (c % 32));
    }
    __syncthreads();
    for (int r = tid; r < BLK; r += K7_THREADS) {
      const size_t src = ((size_t)s * NB1 + u) * BLK + r;
      const int rid = rowid[src], cl = rcl[src];
      if (rid < n_pad && cl >= 0 && cl < nlist)
        for (int q = 0; q < nm; ++q)
          m |= ((k7_bm[q * nw + cl / 32] >> (cl % 32)) & 1u) << (qa + q);
    }
  }
  m = __reduce_or_sync(0xffffffffu, m);
  if ((tid & 31) == 0 && m) atomicOr(&acc_s, m);
  __syncthreads();
  if (tid == 0) *out = acc_s;
}

// ---------------------------------------------------------------------------
// The window path (r_cand <= K7_WINDOW_MAX)
// ---------------------------------------------------------------------------

// A selection's shared state: the bucket's digit, the keys before it and
// in it, and the gather's counters.
struct K7Sel {
  int digit, before, count, n, m;
};

// The R smallest keys of a0[0, n0) and a1[0, n1) (R <= n0 + n1), in
// ascending order, to out[0, R) (out holds es_pow2_at_least(R) keys): a
// radix select over the keys' bytes from the top (a 256-bin histogram a
// pass, stopping once every key of the bucket is wanted), the keys below
// the bucket and the wanted ones in it gathered, then sorted. Equal keys (the
// empty slots) are taken as many as wanted. All threads, after a barrier.
__device__ void k7_select(const u64* a0, int n0, const u64* a1, int n1,
                          int R, u64* out, unsigned* hist, K7Sel* st) {
  const int N = n0 + n1, tid = threadIdx.x, lane = tid & 31;
  u64 prefix = 0ull, himask = 0ull;
  int need = R;
  for (int shift = 56; R < N && shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
    for (int e = tid; e < N; e += blockDim.x) {
      const u64 key = e < n0 ? a0[e] : a1[e - n0];
      if ((key & himask) == prefix)
        atomicAdd(&hist[(unsigned)(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {  // lane l: bins 8l .. 8l + 7
      unsigned h[8], sum = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = hist[8 * lane + i];
        sum += h[i];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      unsigned bef = incl - sum;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (bef < (unsigned)need && (unsigned)need <= bef + h[i]) {
          st->digit = 8 * lane + i;
          st->before = (int)bef;
          st->count = (int)h[i];
        }
        bef += h[i];
      }
    }
    __syncthreads();
    prefix |= (u64)st->digit << shift;
    himask |= 0xFFull << shift;
    need -= st->before;
    if (st->count == need) break;  // every key of the bucket is wanted
  }
  if (tid == 0) {
    st->n = 0;
    st->m = 0;
  }
  __syncthreads();
  for (int e = tid; e < N; e += blockDim.x) {
    const u64 key = e < n0 ? a0[e] : a1[e - n0];
    const u64 hk = key & himask;
    if (R >= N || hk < prefix ||
        (hk == prefix && atomicAdd(&st->m, 1) < need))
      out[atomicAdd(&st->n, 1)] = key;
  }
  __syncthreads();
  const int r2 = es_pow2_at_least(R);
  for (int t = R + tid; t < r2; t += blockDim.x) out[t] = ~0ULL;
  block_bitonic_sort(out, r2);
}

// The list (its first nl entries, sorted) and the candidates at A[R, R +
// nc) become the list of the best min(R, nl + nc), its threshold the R-th
// key once full. All threads, after a barrier.
__device__ void k7_compact(u64* A, int R, u64* scratch, unsigned* hist,
                           K7Sel* st, int* nl, int* nc, u64* thr) {
  const int l = *nl, c = *nc, tot = min(R, l + c);
  k7_select(A, l, A + R, c, tot, scratch, hist, st);
  for (int t = threadIdx.x; t < tot; t += blockDim.x) A[t] = scratch[t];
  __syncthreads();
  if (threadIdx.x == 0) {
    *nl = tot;
    *nc = 0;
    *thr = tot == R ? A[R - 1] : ~0ULL;
  }
  __syncthreads();
}

// Block (part j, shard s, query q): its part's rows (k7_part_scan); scores
// that beat the part's R-th key join a candidate buffer, reduced to the
// part's list (k7_select) when it may fill. The part's list goes to
// `partials`; the last part of (q, s) to finish (an arrival counter)
// merges the G lists into the window.
__global__ void __launch_bounds__(K7_SCAN_THREADS, 1)
k7_scan_kernel(K7Args a, const float* __restrict__ qq,
               const int* __restrict__ probed, int nprobe, int R, int na,
               unsigned* done, u64* partials, float* __restrict__ out_vals,
               int* __restrict__ out_pos) {
  // [na] keys (the list, then the candidates; the merge's lists), a
  // selection's es_pow2_at_least(R) keys, the query, the bitmap
  extern __shared__ u64 k7_dyn[];
  u64* A = k7_dyn;
  u64* scratch = A + na;
  float* q_s = reinterpret_cast<float*>(scratch + es_pow2_at_least(R));
  unsigned* bm = reinterpret_cast<unsigned*>(q_s + ((a.D + 3) & ~3));
  __shared__ K7Mine mine;
  __shared__ int nc_s, nl_s, last_s;
  __shared__ u64 thr_s;
  __shared__ unsigned hist_s[256];
  __shared__ K7Sel sel_s;

  const int j = blockIdx.x, G = gridDim.x, s = blockIdx.y, q = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    nc_s = 0;
    nl_s = 0;
    thr_s = ~0ULL;
  }
  k7_query_setup(q_s, bm, qq, probed, q, a.D, a.nlist, nprobe);
  k7_part_scan(
      a, q, s, j, G, q_s, bm, &mine,
      [&]() {
        if (nc_s + K7_SCAN_THREADS > K7_CB)
          k7_compact(A, R, scratch, hist_s, &sel_s, &nl_s, &nc_s, &thr_s);
      },
      [&](u64 key, bool live) {
        if (live && key < thr_s) A[R + atomicAdd(&nc_s, 1)] = key;
      });
  __syncthreads();
  if (nc_s) k7_compact(A, R, scratch, hist_s, &sel_s, &nl_s, &nc_s, &thr_s);

  // the part's list, then the last part of (q, s) merges the G lists
  const size_t qs_at = (size_t)q * a.S + s;
  u64* mylist = partials + (qs_at * G + j) * R;
  for (int t = tid; t < R; t += K7_SCAN_THREADS)
    mylist[t] = t < nl_s ? A[t] : ~0ULL;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(done + qs_at, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int m = G * R;
  const u64* lists = partials + qs_at * G * R;
  for (int t = tid; t < m; t += K7_SCAN_THREADS) A[t] = __ldcg(lists + t);
  __syncthreads();
  k7_select(A, m, nullptr, 0, R, scratch, hist_s, &sel_s);
  const int fill = a.P * a.BLK;
  for (int t = tid; t < R; t += K7_SCAN_THREADS) {
    const u64 key = scratch[t];
    float v = -CUDART_INF_F;
    int pos = fill;
    if (key != ~0ULL) k7_unkey(key, &v, &pos);
    out_vals[qs_at * R + t] = v;
    out_pos[qs_at * R + t] = pos;
  }
}

// ---------------------------------------------------------------------------
// The deep path (r_cand > K7_WINDOW_MAX)
// ---------------------------------------------------------------------------

// A (query, shard)'s selection state, at the head of its K7_REC_WORDS
// words (the level's histogram after it); zeroed by the mask kernel.
// Level L histograms the keys whose digits above it equal pfx (all keys
// at L = 0); acc keys lie below pfx and are in the window. Once settled,
// the survivors are the keys with (key >> sh) <= top.
struct K7DeepSt {
  u64 pfx, top;
  int level, acc, sh, settled;
  unsigned nsurv;  // survivors appended
  int pad[7];      // 16 words
};

// Level L's digit: the key's bits [shift, shift + bits).
__device__ __forceinline__ int k7_shift(int L) {
  return L < K7_LEVELS - 1 ? 53 - 11 * L : 0;
}
__device__ __forceinline__ int k7_bits(int L) {
  return L < K7_LEVELS - 1 ? 11 : 9;
}

// One block settles or refines (q, s) from its level's histogram: the
// bucket t of the need-th key (need = R - acc); if the keys up to t fit
// CAP survivors (or this is the last level, where a bucket is one key)
// they are the survivors, else the next level histograms bucket t. All
// threads; the histogram is left zeroed for the next level.
__device__ void k7_decide(K7DeepSt* st, unsigned* hist, int R, int CAP,
                          unsigned* ctl, int* wsum, int* res) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = st->level, acc = st->acc, need = R - acc;
  const unsigned h0 = __ldcg(hist + 2 * tid), h1 = __ldcg(hist + 2 * tid + 1);
  const int sum = (int)(h0 + h1);
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  if (tid == 0) res[0] = -1;
  __syncthreads();
  int bef = incl - sum, total = 0;
  for (int w = 0; w < K7_SCAN_THREADS / 32; ++w) {
    if (w < warp) bef += wsum[w];
    total += wsum[w];
  }
  if (total > need) {
    if (bef < need && need <= bef + (int)h0) {
      res[0] = 2 * tid;
      res[1] = bef;
      res[2] = (int)h0;
    } else if (bef + (int)h0 < need && need <= bef + sum) {
      res[0] = 2 * tid + 1;
      res[1] = bef + (int)h0;
      res[2] = (int)h1;
    }
  }
  __syncthreads();
  hist[2 * tid] = 0u;
  hist[2 * tid + 1] = 0u;
  if (tid == 0) {
    const int t = res[0];
    const u64 below = L == 0 ? 0ull : st->pfx << k7_bits(L);
    if (t < 0) {  // every key of the level is wanted
      st->sh = L == 0 ? 53 : k7_shift(L - 1);
      st->top = L == 0 ? (u64)(K7_BINS - 1) : st->pfx;
      st->settled = 1;
    } else if ((long long)acc + res[1] + res[2] <= CAP ||
               L == K7_LEVELS - 1) {
      st->sh = k7_shift(L);
      st->top = below | (u64)t;
      st->settled = 1;
    } else {
      st->acc = acc + res[1];
      st->pfx = below | (u64)t;
      st->level = L + 1;
      atomicAdd(ctl + L, 1u);
    }
  }
}

// One cooperative launch, a block an SM (gridDim.x blocks): units (q, s,
// part j of G) dealt round the blocks.
//  1. Levels: each unit of an unsettled (q, s) scores its part's rows and
//     histograms the level's digit of the keys in the level's bucket
//     (shared bins, added to the (q, s)'s bins); a barrier; the block of
//     part 0 decides (k7_decide); a barrier; again while some (q, s)
//     refined (ctl[L]).
//  2. Collect: each unit scores its rows again and appends the survivors
//     to the (q, s)'s buffer (one atomic a warp step).
//  3. Sort: items (q, s, chunk of K7_SCH survivors), chunk-major, each a
//     block merge sort.
//  4. Place: each item ranks its keys in the other chunks by binary
//     searches and writes those of rank < R; item 0 fills the empty
//     slots past the survivors.
__global__ void __launch_bounds__(K7_SCAN_THREADS, 1)
k7_deep_kernel(K7Args a, const float* __restrict__ qq,
               const int* __restrict__ probed, int nprobe, int B, int R,
               int CAP, int G, unsigned* ctl, unsigned* rec, u64* surv,
               float* __restrict__ out_vals, int* __restrict__ out_pos) {
  // two chunks of keys, the query, the bitmap
  extern __shared__ u64 k7_dyn[];
  u64* ka = k7_dyn;
  u64* kb = ka + K7_SCH;
  float* q_s = reinterpret_cast<float*>(kb + K7_SCH);
  unsigned* bm = reinterpret_cast<unsigned*>(q_s + ((a.D + 3) & ~3));
  __shared__ K7Mine mine;
  __shared__ unsigned hist_s[K7_BINS];
  __shared__ int res_s[4];
  __shared__ int app_s[K7_SCAN_THREADS / 32];
  // the merge sort's keys share the two chunks' space (static shared
  // memory is full)
  typedef cub::BlockMergeSort<u64, K7_SCAN_THREADS, K7_SCH / K7_SCAN_THREADS>
      Sort;
  static_assert(sizeof(typename Sort::TempStorage) <= 2 * K7_SCH * 8,
                "the merge sort's keys fit the two chunks");
  typename Sort::TempStorage& sort_s =
      *reinterpret_cast<typename Sort::TempStorage*>(k7_dyn);

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_qs = B * a.S, n_units = n_qs * G;
  auto state = [&](int qs) {
    return reinterpret_cast<K7DeepSt*>(rec + (size_t)qs * K7_REC_WORDS);
  };
  auto bins = [&](int qs) {
    return rec + (size_t)qs * K7_REC_WORDS + sizeof(K7DeepSt) / 4;
  };

  // 1. the levels
  for (int L = 0;; ++L) {
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int qs = u / G, j = u % G, q = qs / a.S, s = qs % a.S;
      volatile K7DeepSt* st = state(qs);
      if (st->settled) continue;
      const u64 pfx = st->pfx;
      const int sh = k7_shift(L), msk = (1 << k7_bits(L)) - 1;
      const int up = L == 0 ? 0 : k7_shift(L - 1);
      __syncthreads();  // the previous unit's reads of q_s, bm, hist_s
      for (int b = tid; b < K7_BINS; b += K7_SCAN_THREADS) hist_s[b] = 0u;
      k7_query_setup(q_s, bm, qq, probed, q, a.D, a.nlist, nprobe);
      k7_part_scan(a, q, s, j, G, q_s, bm, &mine, [] {},
                   [&](u64 key, bool live) {
                     if (live && (L == 0 || (key >> up) == pfx))
                       atomicAdd(&hist_s[(int)((key >> sh) & (u64)msk)], 1u);
                   });
      __syncthreads();
      unsigned* hg = bins(qs);
      for (int b = tid; b < K7_BINS; b += K7_SCAN_THREADS)
        if (hist_s[b]) atomicAdd(hg + b, hist_s[b]);
    }
    grid.sync();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int qs = u / G;
      if (u % G != 0 || state(qs)->settled) continue;
      __syncthreads();
      k7_decide(state(qs), bins(qs), R, CAP, ctl, app_s, res_s);
    }
    grid.sync();
    if (L == K7_LEVELS - 1 || *(volatile unsigned*)(ctl + L) == 0u) break;
  }

  // 2. collect the survivors
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int qs = u / G, j = u % G, q = qs / a.S, s = qs % a.S;
    K7DeepSt* st = state(qs);
    const u64 top = ((volatile K7DeepSt*)st)->top;
    const int sh = ((volatile K7DeepSt*)st)->sh;
    u64* out = surv + (size_t)qs * CAP;
    __syncthreads();
    k7_query_setup(q_s, bm, qq, probed, q, a.D, a.nlist, nprobe);
    k7_part_scan(a, q, s, j, G, q_s, bm, &mine, [] {},
                 [&](u64 key, bool live) {
                   const bool take = live && (key >> sh) <= top;
                   const unsigned bal = __ballot_sync(0xffffffffu, take);
                   int base = 0;
                   if (lane == 0 && bal)
                     base = (int)atomicAdd(&st->nsurv, (unsigned)__popc(bal));
                   base = __shfl_sync(0xffffffffu, base, 0);
                   const int at = base + __popc(bal & ((1u << lane) - 1u));
                   if (take && at < CAP) out[at] = key;
                 });
  }
  grid.sync();

  // 3. sort each chunk of survivors: a block merge sort, two keys a
  // thread; items in chunk-major order, so the chunks that hold keys
  // (the first of every (q, s)) spread over the grid
  const int cmax = (CAP + K7_SCH - 1) / K7_SCH;
  constexpr int kper = K7_SCH / K7_SCAN_THREADS;
  for (int it = blockIdx.x; it < n_qs * cmax; it += gridDim.x) {
    const int qs = it % n_qs, c = it / n_qs;
    const int ns = min((int)((volatile K7DeepSt*)state(qs))->nsurv, CAP);
    const int lo = c * K7_SCH, n = min(K7_SCH, ns - lo);
    if (n <= 0) continue;
    u64* ch = surv + (size_t)qs * CAP + lo;
    u64 v[kper];
#pragma unroll
    for (int i = 0; i < kper; ++i) {
      const int t = tid * kper + i;
      v[i] = t < n ? __ldcg(ch + t) : ~0ULL;
    }
    __syncthreads();  // the previous item's sort is done with sort_s
    Sort(sort_s).Sort(v, U64Less());
#pragma unroll
    for (int i = 0; i < kper; ++i)
      if (tid * kper + i < n) ch[tid * kper + i] = v[i];
  }
  grid.sync();

  // 4. place each chunk's keys by their ranks among all survivors
  const int fill = a.P * a.BLK;
  for (int it = blockIdx.x; it < n_qs * cmax; it += gridDim.x) {
    const int qs = it % n_qs, c = it / n_qs;
    const int ns = min((int)((volatile K7DeepSt*)state(qs))->nsurv, CAP);
    const int nch = (ns + K7_SCH - 1) / K7_SCH;
    float* ov = out_vals + (size_t)qs * R;
    int* op = out_pos + (size_t)qs * R;
    if (c == 0)
      for (int t = min(ns, R) + tid; t < R; t += K7_SCAN_THREADS) {
        ov[t] = -CUDART_INF_F;
        op[t] = fill;
      }
    if (c >= nch) continue;
    const u64* base = surv + (size_t)qs * CAP;
    const int n = min(K7_SCH, ns - c * K7_SCH);
    __syncthreads();
    for (int t = tid; t < n; t += K7_SCAN_THREADS)
      ka[t] = __ldcg(base + (size_t)c * K7_SCH + t);
    int rank[kper];
#pragma unroll
    for (int i = 0; i < kper; ++i) rank[i] = tid + i * K7_SCAN_THREADS;
    for (int c2 = 0; c2 < nch; ++c2) {
      if (c2 == c) continue;
      const int n2 = min(K7_SCH, ns - c2 * K7_SCH);
      __syncthreads();
      for (int t = tid; t < n2; t += K7_SCAN_THREADS)
        kb[t] = __ldcg(base + (size_t)c2 * K7_SCH + t);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kper; ++i) {
        const int t = tid + i * K7_SCAN_THREADS;
        if (t >= n) continue;
        const u64 x = ka[t];
        int lo = 0, hi = n2;  // keys of chunk c2 below x
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (kb[mid] < x)
            lo = mid + 1;
          else
            hi = mid;
        }
        rank[i] += lo;
      }
    }
#pragma unroll
    for (int i = 0; i < kper; ++i) {
      const int t = tid + i * K7_SCAN_THREADS;
      if (t < n && rank[i] < R) {
        float v;
        int pos;
        k7_unkey(ka[t], &v, &pos);
        ov[rank[i]] = v;
        op[rank[i]] = pos;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Plans, workspace and the C entry
// ---------------------------------------------------------------------------

// Window path: scan blocks a (query, shard): one an SM over the (query,
// shard)s (at least one), each part's list merged by one block (G x R <=
// K7_MERGE_MAX).
static int k7_parts(int B, int S, int R) {
  const int bs = B * S > 0 ? B * S : 1;
  int G = es_sm_count() / bs;
  if (G > K7_MAX_PARTS) G = K7_MAX_PARTS;
  while (G > 1 && (long long)G * R > K7_MERGE_MAX) --G;
  return G < 1 ? 1 : G;
}

// Deep path: dynamic shared memory of a block, and its grid (the blocks
// the card holds at once, 0 when none fits).
static size_t k7_deep_shared(int D, int nlist) {
  return (size_t)2 * K7_SCH * 8 + (size_t)((D + 3) & ~3) * 4 +
         (size_t)((nlist + 31) / 32) * 4;
}

static int k7_deep_grid(int D, int nlist) {
  int per_sm = 0;
  if (es_set_shared(k7_deep_kernel, k7_deep_shared(D, nlist)) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k7_deep_kernel, K7_SCAN_THREADS,
          k7_deep_shared(D, nlist)) != cudaSuccess)
    return 0;
  return per_sm * es_sm_count();
}

// Deep path: parts a (query, shard): the grid's blocks over the (query,
// shard)s, at least one, at most K7_MAX_PARTS.
static int k7_deep_parts(int B, int S, int grid) {
  const int bs = B * S > 0 ? B * S : 1;
  const int G = grid / bs;
  return G < 1 ? 1 : (G > K7_MAX_PARTS ? K7_MAX_PARTS : G);
}

struct K7Layout {
  size_t qmask, zero, ctl, surv, total;
};

// The workspace: the query masks, then the zeroed words (arrival counters;
// or states and histograms), the deep path's level counters and its
// survivors (2 R keys a (query, shard)).
static K7Layout k7_layout(int B, int S, int P, int R) {
  K7Layout l;
  const size_t nqt = (size_t)(B + K7_QT - 1) / K7_QT;
  const size_t bs = (size_t)B * S;
  const bool deep = R > K7_WINDOW_MAX;
  l.qmask = 0;
  l.zero = (nqt * S * P * 4 + 15) & ~(size_t)15;
  l.ctl = l.zero + ((bs * (deep ? K7_REC_WORDS : 1) * 4 + 15) & ~(size_t)15);
  l.surv = l.ctl + (deep ? 64 : 0);
  l.total = l.surv + (deep ? bs * 2 * (size_t)R * 8
                           : bs * k7_parts(B, S, R) * (size_t)R * 8);
  return l;
}

// Bytes of a call's workspace.
extern "C" long long es_ivf_scan_workspace_bytes(int B, int S, int P,
                                                 int R) {
  return (long long)k7_layout(B, S, P, R).total;
}

// Scan blocks a (query, shard) of a call (deep path: at the grid of d
// values D and nlist).
extern "C" int es_ivf_scan_parts(int B, int S, int R, int D, int nlist) {
  if (R <= K7_WINDOW_MAX) return k7_parts(B, S, R);
  return k7_deep_parts(B, S, k7_deep_grid(D, nlist));
}

// Blocks of the deep path's cooperative launch at d values D and nlist.
extern "C" int es_ivf_deep_grid(int D, int nlist) {
  return k7_deep_grid(D, nlist);
}

// codes int8 or bf16 [S, NB1, BLK, D]; scale, off f32, rowid, rcl i32 [S,
// NB1, BLK]; vn f32[S, n_pad]; qq f32[B, D]; qsum, qn f32[B]; probed
// i32[B, nprobe]; u_blocks i32[S, P]; 1 <= R <= K7_DEEP_MAX: the window
// out_vals f32, out_pos i32 [B, S, R]. workspace:
// es_ivf_scan_workspace_bytes(B, S, P, R) bytes, 16-byte aligned.
extern "C" int es_ivf_scan(const void* codes, int is_bf16, const float* scale,
                           const float* off, const int* rowid, const int* rcl,
                           const float* vn, const float* qq,
                           const float* qsum, const float* qn,
                           const int* probed, const int* u_blocks, int B,
                           int S, int NB1, int BLK, int D, int n_pad,
                           int nlist, int nprobe, int P, int R, int l2,
                           float* out_vals, int* out_pos, void* ws,
                           void* stream) {
  if (R < 1 || R > K7_DEEP_MAX || (long long)P * BLK >= (1LL << 31))
    return ES_ERR_SIZE;
  if (B * S == 0) return 0;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool deep = R > K7_WINDOW_MAX;
  const int nw = (nlist + 31) / 32;
  const int nqt = (B + K7_QT - 1) / K7_QT;
  const int tile = B < K7_MQ ? B : K7_MQ;
  const size_t shm_mask = (size_t)tile * nw * 4;
  int e = es_set_shared(k7_mask_kernel, shm_mask);
  if (e != 0) return e;
  const K7Layout l = k7_layout(B, S, P, R);
  unsigned char* w = (unsigned char*)ws;
  unsigned* qmask = (unsigned*)(w + l.qmask);
  unsigned* zero = (unsigned*)(w + l.zero);
  unsigned* ctl = deep ? (unsigned*)(w + l.ctl) : nullptr;
  u64* keys = (u64*)(w + l.surv);
  const int esize = is_bf16 ? 2 : 1;
  const int vec = ((uintptr_t)codes % 16 == 0) && ((D * esize) % 16 == 0);
  const K7Args a = {codes, scale, off, rowid, rcl, vn, qsum, qn, qmask,
                    u_blocks, is_bf16, S, NB1, BLK, D, n_pad, nlist, P, l2,
                    vec};
  if (!deep) {
    const int G = k7_parts(B, S, R);
    const int na = R + K7_CB > G * R ? R + K7_CB : G * R;
    const size_t shm_scan = (size_t)(na + es_pow2_at_least(R)) * 8 +
                            (size_t)((D + 3) & ~3) * 4 + (size_t)nw * 4;
    e = es_set_shared(k7_scan_kernel, shm_scan);
    if (e != 0) return e;
    k7_mask_kernel<<<dim3(P, S, nqt), K7_THREADS, shm_mask, st>>>(
        rowid, rcl, probed, u_blocks, B, S, NB1, BLK, n_pad, nlist, nprobe,
        P, qmask, zero, 1, nullptr);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    k7_scan_kernel<<<dim3(G, S, B), K7_SCAN_THREADS, shm_scan, st>>>(
        a, qq, probed, nprobe, R, na, zero, keys, out_vals, out_pos);
    return (int)cudaGetLastError();
  }
  const int grid = k7_deep_grid(D, nlist);
  if (grid < 1) return ES_ERR_SHARED;
  int G = k7_deep_parts(B, S, grid);
  int CAP = 2 * R;
  k7_mask_kernel<<<dim3(P, S, nqt), K7_THREADS, shm_mask, st>>>(
      rowid, rcl, probed, u_blocks, B, S, NB1, BLK, n_pad, nlist, nprobe, P,
      qmask, zero, K7_REC_WORDS, ctl);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  K7Args av = a;
  const float* qqv = qq;
  const int* prv = probed;
  int npv = nprobe, Bv = B, Rv = R;
  unsigned* recv = zero;
  void* args[] = {(void*)&av,   (void*)&qqv, (void*)&prv,  (void*)&npv,
                  (void*)&Bv,   (void*)&Rv,  (void*)&CAP,  (void*)&G,
                  (void*)&ctl,  (void*)&recv, (void*)&keys,
                  (void*)&out_vals, (void*)&out_pos};
  const cudaError_t ce = cudaLaunchCooperativeKernel(
      (const void*)k7_deep_kernel, dim3(grid), dim3(K7_SCAN_THREADS), args,
      k7_deep_shared(D, nlist), st);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
