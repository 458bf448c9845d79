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
// The window path (n_chunks = 0, r_cand <= K7_WINDOW_MAX): work by probed
// (query, gathered block) pairs, the window formed in the same call.
//  - k7_mask_kernel, a block a gathered block (and a tile of 32 queries):
//    the tile's probe bitmaps in shared memory, 16 queries' at a time (the
//    chunk path's query tile), one thread a row tests its cluster, the
//    block ORs the bits into the block's query mask. The padding block NB
//    reads no row.
//  - k7_scan_kernel, G blocks a (query, shard) (G from k7_parts: a block
//    an SM): block j takes every G-th gathered block its query probes; a
//    thread a row scores only the rows of the query's clusters (metadata
//    once, the code row by 16-byte loads), and keeps a part list of the
//    r_cand best keys (a candidate buffer against the list's threshold,
//    reduced to the list by a radix select when it may fill). The last
//    part of a (query, shard) to arrive (a counter the mask kernel zeroed)
//    selects the window from the G lists.
// The chunk path (n_chunks >= 1, for larger windows): grid (chunk, shard,
// query tile of up to KS_BT queries); a block turns its queries' probed
// clusters into bitmaps, then takes tiles of KS_ROWS gathered rows chunk,
// chunk + gridDim.x, ...: a row is scored for the queries whose bitmap
// holds its cluster (a row no query of the tile probes reads no codes, the
// sentinel block NB is not read), codes widened to f32 in shared memory
// (knn_common.cuh); each chunk's r_cand best go to part_vals/part_pos, and
// K3 reduces the chunks into the window.
//
// Bound: latency and launch. At the repository's IVF shape (2^20 rows, d =
// 64, nlist 1024, nprobe 8, B = 16) a batch reads a few MB of codes and
// metadata, microseconds at the card's memory rate, and scores about
// 136,000 (row, query) pairs.

#include <cuda_bf16.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "sort_common.cuh"

// Dynamic shared memory before the lists: base plus the probe bitmaps.
static size_t ivf_base_bytes(int bt, int nlist, int D) {
  return ks_base_bytes(bt, D) + (size_t)bt * ((nlist + 31) / 32) * 4;
}

template <bool kShared>
__global__ void __launch_bounds__(KS_THREADS)
ivf_scan_kernel(const void* __restrict__ codes, int is_bf16,
                const float* __restrict__ scale, const float* __restrict__ off,
                const int* __restrict__ rowid, const int* __restrict__ rcl,
                const float* __restrict__ vn, const float* __restrict__ qq,
                const float* __restrict__ qsum, const float* __restrict__ qn,
                const int* __restrict__ probed,
                const int* __restrict__ u_blocks, int B, int S, int NB1,
                int BLK, int D, int n_pad, int nlist, int nprobe, int P,
                int k, int l2, int bt, int dc, int rs,
                float* __restrict__ part_vals, int* __restrict__ part_pos,
                float* ws_vals, int* ws_pos) {
  extern __shared__ float4 smem4[];
  float* rows_s = reinterpret_cast<float*>(smem4);       // [ROWS][rs]
  float* q_s = rows_s + KS_ROWS * rs;                    // [BT][dc]
  float* c_v = q_s + KS_BT * dc;                         // [bt][ROWS]
  int* c_i = reinterpret_cast<int*>(c_v + bt * KS_ROWS);
  const int nw = (nlist + 31) / 32;
  unsigned* bm = reinterpret_cast<unsigned*>(c_i + bt * KS_ROWS);  // [bt][nw]
  unsigned char* lists = reinterpret_cast<unsigned char*>(bm + bt * nw);

  __shared__ int filled[KS_BT], ncand[KS_BT], thr_id[KS_BT];
  __shared__ float thr_v[KS_BT], qsum_s[KS_BT], qn_s[KS_BT];
  __shared__ unsigned mask_s[KS_ROWS];
  __shared__ long long src_s[KS_ROWS];
  __shared__ float sc_s[KS_ROWS], of_s[KS_ROWS], vn_s[KS_ROWS];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.z * bt;
  const int nb = min(bt, B - b0);
  const size_t ostride = (size_t)S * n_chunks * k;
  const size_t out0 = ((size_t)b0 * S + s) * n_chunks * k + (size_t)chunk * k;
  QueryLists L = ks_lists(kShared, lists, part_vals + out0, part_pos + out0,
                          ws_vals + out0, ws_pos + out0, ostride, c_v, c_i,
                          filled, ncand, thr_v, thr_id, k, bt);
  if (tid < KS_BT) {
    filled[tid] = 0;
    ncand[tid] = 0;
    qsum_s[tid] = tid < nb ? qsum[b0 + tid] : 0.0f;
    qn_s[tid] = (tid < nb && l2) ? qn[b0 + tid] : 0.0f;
  }
  for (int e = tid; e < bt * nw; e += KS_THREADS) bm[e] = 0u;
  // a row of up to dc values: the queries are loaded once
  if (D <= dc) ks_load_queries(q_s, qq, b0, nb, D, 0, dc);
  __syncthreads();
  for (int e = tid; e < nb * nprobe; e += KS_THREADS) {
    const int q = e / nprobe;
    const int c = probed[(size_t)(b0 + q) * nprobe + e % nprobe];
    if (c >= 0 && c < nlist) atomicOr(&bm[q * nw + c / 32], 1u << (c % 32));
  }
  __syncthreads();

  const int rr = tid & 63, qg = tid >> 6;
  const int n_rows = P * BLK;
  const int n_tiles = (n_rows + KS_ROWS - 1) / KS_ROWS;
  const int8_t* c8 = static_cast<const int8_t*>(codes);
  const __nv_bfloat16* c16 = static_cast<const __nv_bfloat16*>(codes);
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int g0 = tile * KS_ROWS;
    unsigned mask = 0u;
    if (tid < KS_ROWS && g0 + tid < n_rows) {
      const int g = g0 + tid;
      const int u = u_blocks[(size_t)s * P + g / BLK];
      const long long src = ((long long)s * NB1 + u) * BLK + g % BLK;
      const bool real = u < NB1 - 1;  // block NB: all padding, not read
      const int rid = real ? rowid[src] : n_pad;
      const int cl = real ? rcl[src] : -1;
      if (rid < n_pad && cl >= 0 && cl < nlist)
        for (int q = 0; q < nb; ++q)
          mask |= ((bm[q * nw + cl / 32] >> (cl % 32)) & 1u) << q;
      if (mask) {
        src_s[tid] = src;
        sc_s[tid] = scale[src];
        of_s[tid] = off[src];
        vn_s[tid] = l2 ? vn[(size_t)s * n_pad + min(max(rid, 0), n_pad - 1)]
                       : 0.0f;
      }
    }
    if (tid < KS_ROWS) mask_s[tid] = mask;
    if (!__syncthreads_or(mask != 0u)) continue;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int d0 = 0; d0 < D; d0 += dc) {
      for (int e = tid; e < KS_ROWS * dc; e += KS_THREADS) {
        const int r = e / dc, c = e - r * dc, d = d0 + c;
        float x = 0.0f;
        if (mask_s[r] && d < D) {
          const size_t at = (size_t)src_s[r] * D + d;
          x = is_bf16 ? __bfloat162float(c16[at]) : (float)c8[at];
        }
        rows_s[r * rs + c] = x;
      }
      if (D > dc) ks_load_queries(q_s, qq, b0, nb, D, d0, dc);
      __syncthreads();
      ks_tile_dot(rows_s, q_s, rr, qg, dc, rs, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr + 64 * i;
      const unsigned m = mask_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = qg * 4 + j;
        float sc = __fadd_rn(__fmul_rn(sc_s[r], acc[i][j]),
                             __fmul_rn(of_s[r], qsum_s[q]));
        if (l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vn_s[r]),
                               qn_s[q]);
        L.push(q, ((m >> q) & 1u) && L.beats(q, sc, g0 + r), sc, g0 + r);
      }
    }
    __syncthreads();
    L.merge();
  }
  __syncthreads();
  for (int q = 0; q < nb; ++q)
    L.write(q, part_vals + out0 + q * ostride, part_pos + out0 + q * ostride,
            n_rows, !kShared);
}

// ---------------------------------------------------------------------------
// The window in one call (r_cand <= K7_WINDOW_MAX): work by probed
// (query, gathered block) pairs
// ---------------------------------------------------------------------------

#define K7_THREADS 256       // threads of a mask block
#define K7_SCAN_THREADS 1024 // threads of a scan block
#define K7_WORDS 4096        // mask words a scan block reads a round
#define K7_QT 32             // queries a mask word
#define K7_MQ 16             // probe bitmaps a mask block holds at once
#define K7_CB 2048           // candidates a scan block buffers
#define K7_WINDOW_MAX 1024   // the largest window formed in one call
#define K7_MAX_PARTS 16      // scan blocks a (query, shard) at most
#define K7_MERGE_MAX 8192    // parts x window entries the last block merges

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

// Which queries of a tile of K7_QT probe a cluster in gathered block p of
// shard s: qmask[(tile, s, p)], one bit a query (0 for the padding block
// NB, whose rows are not read). The tile's probe bitmaps are built K7_MQ
// queries at a time, so shared memory holds K7_MQ bitmaps at most. The
// blocks of p = 0 also zero the scan's arrival counters of the tile's
// queries.
__global__ void __launch_bounds__(K7_THREADS)
k7_mask_kernel(const int* __restrict__ rowid, const int* __restrict__ rcl,
               const int* __restrict__ probed,
               const int* __restrict__ u_blocks, int B, int S, int NB1,
               int BLK, int n_pad, int nlist, int nprobe, int P,
               unsigned* __restrict__ qmask, unsigned* __restrict__ done) {
  extern __shared__ unsigned k7_bm[];  // [K7_MQ][nw]
  __shared__ unsigned acc_s;
  const int p = blockIdx.x, s = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * K7_QT, nq = min(K7_QT, B - q0);
  const int tid = threadIdx.x;
  if (p == 0)
    for (int q = tid; q < nq; q += K7_THREADS)
      done[(size_t)(q0 + q) * S + s] = 0u;
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

// Block (part j, shard s, query q): the gathered blocks q probes (bits of
// qmask, in p order) dealt round the G parts. Their rows are taken
// K7_SCAN_THREADS at a time, a thread a row (several gathered blocks a
// round): the row's metadata once, the code row by 16-byte loads, the dot
// product as a chain of f32 FMAs in ascending d, the dequantized score;
// scores that beat the part's R-th key join a candidate buffer, reduced
// to the part's list (k7_select) when it may fill. The part's list goes to
// `partials`; the last part of (q, s) to finish (an arrival counter)
// merges the G lists into the window.
__global__ void __launch_bounds__(K7_SCAN_THREADS, 1)
k7_scan_kernel(const void* __restrict__ codes, int is_bf16,
               const float* __restrict__ scale, const float* __restrict__ off,
               const int* __restrict__ rowid, const int* __restrict__ rcl,
               const float* __restrict__ vn, const float* __restrict__ qq,
               const float* __restrict__ qsum, const float* __restrict__ qn,
               const int* __restrict__ probed, const int* __restrict__ u_blocks,
               int S, int NB1, int BLK, int D, int n_pad, int nlist,
               int nprobe, int P, int R, int l2, int vec, int na,
               const unsigned* __restrict__ qmask, unsigned* done,
               u64* partials, float* __restrict__ out_vals,
               int* __restrict__ out_pos) {
  // [na] keys (the list, then the candidates; the merge's lists), a
  // selection's es_pow2_at_least(R) keys, the query, the bitmap
  extern __shared__ u64 k7_dyn[];
  u64* A = k7_dyn;
  u64* scratch = A + na;
  float* q_s = reinterpret_cast<float*>(scratch + es_pow2_at_least(R));
  unsigned* bm = reinterpret_cast<unsigned*>(q_s + ((D + 3) & ~3));
  // this part's probed blocks of a round of mask words: p and u_blocks[p]
  __shared__ int mine_p[K7_WORDS], mine_u[K7_WORDS];
  __shared__ int wsum[K7_SCAN_THREADS / 32];
  __shared__ int n_mine, nc_s, nl_s, last_s;
  __shared__ u64 thr_s;
  __shared__ unsigned hist_s[256];
  __shared__ K7Sel sel_s;

  const int j = blockIdx.x, G = gridDim.x, s = blockIdx.y, q = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (nlist + 31) / 32;
  for (int e = tid; e < nw; e += K7_SCAN_THREADS) bm[e] = 0u;
  for (int d = tid; d < D; d += K7_SCAN_THREADS)
    q_s[d] = qq[(size_t)q * D + d];
  if (tid == 0) {
    nc_s = 0;
    nl_s = 0;
    thr_s = ~0ULL;
  }
  __syncthreads();
  for (int e = tid; e < nprobe; e += K7_SCAN_THREADS) {
    const int c = probed[(size_t)q * nprobe + e];
    if (c >= 0 && c < nlist) atomicOr(&bm[c / 32], 1u << (c % 32));
  }
  const float qs_q = qsum[q], qn_q = l2 ? qn[q] : 0.0f;
  const unsigned* mrow = qmask + ((size_t)(q / K7_QT) * S + s) * P;
  const int* urow = u_blocks + (size_t)s * P;
  const unsigned qbit = 1u << (q % K7_QT);
  const int8_t* c8 = static_cast<const int8_t*>(codes);
  const __nv_bfloat16* c16 = static_cast<const __nv_bfloat16*>(codes);
  constexpr int per = K7_WORDS / K7_SCAN_THREADS;
  int seen = 0;  // probed blocks in the rounds before

  for (int p0 = 0; p0 < P; p0 += K7_WORDS) {
    // a round's mask words, `per` consecutive words a thread, all loaded
    // at once; this part takes every G-th probed block in p order
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int p = p0 + tid * per + i;
      if (p < P && (mrow[p] & qbit)) bits |= 1u << i;
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    if (tid == 0) n_mine = 0;
    __syncthreads();  // also: the previous round's rows are done
    int ord = seen + incl - cnt;
    for (int w = 0; w < K7_SCAN_THREADS / 32; ++w) {
      if (w < warp) ord += wsum[w];
      seen += wsum[w];
    }
#pragma unroll
    for (int i = 0; i < per; ++i) {
      if ((bits >> i) & 1u) {
        if (ord % G == j) {
          const int p = p0 + tid * per + i;
          const int at = atomicAdd(&n_mine, 1);
          mine_p[at] = p;
          mine_u[at] = urow[p];
        }
        ++ord;
      }
    }
    __syncthreads();
    const int rows = n_mine * BLK;
    for (int f0 = 0; f0 < rows; f0 += K7_SCAN_THREADS) {
      __syncthreads();
      if (nc_s + K7_SCAN_THREADS > K7_CB)
        k7_compact(A, R, scratch, hist_s, &sel_s, &nl_s, &nc_s, &thr_s);
      const int f = f0 + tid;
      if (f >= rows) continue;
      const int i = f / BLK, r = f - i * BLK;
      const size_t src = ((size_t)s * NB1 + mine_u[i]) * BLK + r;
      const int cl = rcl[src], rid = rowid[src];
      if (rid >= n_pad || cl < 0 || cl >= nlist ||
          !((bm[cl / 32] >> (cl % 32)) & 1u))
        continue;
      const float sc_r = scale[src], of_r = off[src];
      const float vn_r =
          l2 ? vn[(size_t)s * n_pad + min(max(rid, 0), n_pad - 1)] : 0.0f;
      float acc = 0.0f;
      if (is_bf16) {
        const __nv_bfloat16* row = c16 + src * D;
        if (vec) {
          for (int d0 = 0; d0 < D; d0 += 8) {
            const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(row + d0));
            const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              acc = fmaf(__uint_as_float(w[h] << 16), q_s[d0 + 2 * h], acc);
              acc = fmaf(__uint_as_float(w[h] & 0xFFFF0000u),
                         q_s[d0 + 2 * h + 1], acc);
            }
          }
        } else {
          for (int d = 0; d < D; ++d)
            acc = fmaf(__bfloat162float(row[d]), q_s[d], acc);
        }
      } else {
        const int8_t* row = c8 + src * D;
        if (vec) {
          for (int d0 = 0; d0 < D; d0 += 16) {
            const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(row + d0));
            const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int h = 0; h < 4; ++h)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                acc = fmaf((float)(int8_t)(w[h] >> (8 * b)),
                           q_s[d0 + 4 * h + b], acc);
          }
        } else {
          for (int d = 0; d < D; ++d)
            acc = fmaf((float)row[d], q_s[d], acc);
        }
      }
      float sc = __fadd_rn(__fmul_rn(sc_r, acc), __fmul_rn(of_r, qs_q));
      if (l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vn_r), qn_q);
      if (sc > -CUDART_INF_F) {  // -inf and NaN take no part
        const u64 key = k7_key(sc, mine_p[i] * BLK + r);
        if (key < thr_s) A[R + atomicAdd(&nc_s, 1)] = key;
      }
    }
  }
  __syncthreads();
  if (nc_s) k7_compact(A, R, scratch, hist_s, &sel_s, &nl_s, &nc_s, &thr_s);

  // the part's list, then the last part of (q, s) merges the G lists
  const size_t qs_at = (size_t)q * S + s;
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
  const int fill = P * BLK;
  for (int t = tid; t < R; t += K7_SCAN_THREADS) {
    const u64 key = scratch[t];
    float v = -CUDART_INF_F;
    int pos = fill;
    if (key != ~0ULL) k7_unkey(key, &v, &pos);
    out_vals[qs_at * R + t] = v;
    out_pos[qs_at * R + t] = pos;
  }
}

// Scan blocks a (query, shard): one an SM over the (query, shard)s (at
// least one), each part's list merged by one block (G x R <=
// K7_MERGE_MAX).
static int k7_parts(int B, int S, int R) {
  const int bs = B * S > 0 ? B * S : 1;
  int G = es_sm_count() / bs;
  if (G > K7_MAX_PARTS) G = K7_MAX_PARTS;
  while (G > 1 && (long long)G * R > K7_MERGE_MAX) --G;
  return G < 1 ? 1 : G;
}

struct K7Layout {
  size_t qmask, done, partials, total;
};

static K7Layout k7_layout(int B, int S, int P, int R) {
  K7Layout l;
  const size_t nqt = (size_t)(B + K7_QT - 1) / K7_QT;
  l.qmask = 0;
  l.done = (nqt * S * P * 4 + 15) & ~(size_t)15;
  l.partials = l.done + (((size_t)B * S * 4 + 15) & ~(size_t)15);
  l.total = l.partials + (size_t)B * S * k7_parts(B, S, R) * R * 8;
  return l;
}

// The window path's workspace bytes.
extern "C" long long es_ivf_window_workspace_bytes(int B, int S, int P,
                                                   int R) {
  return (long long)k7_layout(B, S, P, R).total;
}

// Scan blocks a (query, shard) of the window path.
extern "C" int es_ivf_window_parts(int B, int S, int R) {
  return k7_parts(B, S, R);
}

static int k7_window(const void* codes, int is_bf16, const float* scale,
                     const float* off, const int* rowid, const int* rcl,
                     const float* vn, const float* qq, const float* qsum,
                     const float* qn, const int* probed, const int* u_blocks,
                     int B, int S, int NB1, int BLK, int D, int n_pad,
                     int nlist, int nprobe, int P, int R, int l2,
                     float* out_vals, int* out_pos, void* ws,
                     cudaStream_t st) {
  if (R < 1 || R > K7_WINDOW_MAX || (long long)P * BLK >= (1LL << 31))
    return ES_ERR_SIZE;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int nw = (nlist + 31) / 32;
  const int nqt = (B + K7_QT - 1) / K7_QT;
  const int tile = B < K7_MQ ? B : K7_MQ;
  const size_t shm_mask = (size_t)tile * nw * 4;
  int e = es_set_shared(k7_mask_kernel, shm_mask);
  if (e != 0) return e;
  const int G = k7_parts(B, S, R);
  const int na = R + K7_CB > G * R ? R + K7_CB : G * R;
  const size_t shm_scan = (size_t)(na + es_pow2_at_least(R)) * 8 +
                          (size_t)((D + 3) & ~3) * 4 + (size_t)nw * 4;
  e = es_set_shared(k7_scan_kernel, shm_scan);
  if (e != 0) return e;
  const K7Layout l = k7_layout(B, S, P, R);
  unsigned char* w = (unsigned char*)ws;
  unsigned* qmask = (unsigned*)(w + l.qmask);
  unsigned* done = (unsigned*)(w + l.done);
  u64* partials = (u64*)(w + l.partials);
  const int esize = is_bf16 ? 2 : 1;
  const int vec = ((uintptr_t)codes % 16 == 0) && ((D * esize) % 16 == 0);
  k7_mask_kernel<<<dim3(P, S, nqt), K7_THREADS, shm_mask, st>>>(
      rowid, rcl, probed, u_blocks, B, S, NB1, BLK, n_pad, nlist, nprobe, P,
      qmask, done);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  k7_scan_kernel<<<dim3(G, S, B), K7_SCAN_THREADS, shm_scan, st>>>(
      codes, is_bf16, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
      u_blocks, S, NB1, BLK, D, n_pad, nlist, nprobe, P, R, l2, vec, na,
      qmask, done, partials, out_vals, out_pos);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the shared-list kernel may have.
static size_t ivf_scan_shared_room() {
  return (size_t)es_max_shared_bytes() -
         es_static_shared_bytes(ivf_scan_kernel<true>);
}

// Workspace bytes of a launch: 0 when the lists fit shared memory.
extern "C" long long es_ivf_scan_workspace_bytes(int B, int S, int n_chunks,
                                                 int k, int nlist, int D) {
  const int bt = B < KS_BT ? B : KS_BT;
  if (ivf_base_bytes(bt, nlist, D) + ks_list_bytes(bt, k) <=
      ivf_scan_shared_room())
    return 0;
  return (long long)B * S * n_chunks * k * 8;
}

extern "C" int es_ivf_scan(const void* codes, int is_bf16, const float* scale,
                           const float* off, const int* rowid, const int* rcl,
                           const float* vn, const float* qq,
                           const float* qsum, const float* qn,
                           const int* probed, const int* u_blocks, int B,
                           int S, int NB1, int BLK, int D, int n_pad,
                           int nlist, int nprobe, int P, int k, int l2,
                           int n_chunks, float* part_vals, int* part_pos,
                           float* ws, void* stream) {
  if (n_chunks == 0)
    return k7_window(codes, is_bf16, scale, off, rowid, rcl, vn, qq, qsum, qn,
                     probed, u_blocks, B, S, NB1, BLK, D, n_pad, nlist,
                     nprobe, P, k, l2, part_vals, part_pos, ws,
                     (cudaStream_t)stream);
  const int bt = B < KS_BT ? B : KS_BT;
  size_t shm = ivf_base_bytes(bt, nlist, D);
  const bool shared =
      shm + ks_list_bytes(bt, k) <= ivf_scan_shared_room();
  if (shared) shm += ks_list_bytes(bt, k);
  else if (ws == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = shared ? ivf_scan_kernel<true> : ivf_scan_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  const size_t n_ws = (size_t)B * S * n_chunks * k;
  const int dc = ks_dc(D);
  dim3 grid(n_chunks, S, (B + bt - 1) / bt);
  kernel<<<grid, KS_THREADS, shm, (cudaStream_t)stream>>>(
      codes, is_bf16, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
      u_blocks, B, S, NB1, BLK, D, n_pad, nlist, nprobe, P, k, l2, bt, dc,
      ks_rs(dc), part_vals, part_pos, ws,
      ws == nullptr ? nullptr : (int*)(ws + n_ws));
  return (int)cudaGetLastError();
}
