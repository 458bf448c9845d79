// Doc-tile scoring + top-k over sorted postings runs: the design K9
// (bool_bm25_topk.cu) and K1 (sparse_candidates_topk.cu) share. A kernel
// source supplies a Mode (what a slot carries, how a doc's group combines
// its slots, which docs are hits and what they count) and calls
// tt_launch<Mode>.
//
// The reference merges a (query, shard)'s Q doc-sorted runs with a stable
// network and sums each doc group at the posting of the HIGHEST slot
// holding the doc, ((c_qmax + c_q') + c_q'') ... in descending slot order,
// with c_q = impact * idfw_q. The k best hits, keyed (score desc, doc asc),
// are returned; empty places hold (-inf, n_pad).
//
// Index rules (the reference's dynamic_slice of each run): a slot's start
// clamps to [0, P - L] and its length to [0, L]; docs >= n_pad never
// count; two slots may read the same run; empty slots are skipped.
// Assumed of every run: its valid prefix holds non-negative docs in
// strictly ascending order (the plane's postings are built so).
//
// Design. A (query, shard)'s doc space [0, n_pad) splits into G ranges of
// whole tiles of T = 2^tshift docs, one block each (the plan, in Python:
// ops/sorted_merge.py:tile_plan, picks T, 2^11 or, where the slots hold at
// most one posting a doc, 2^12, and G, so that B * S * G blocks fill the
// card several times and G * k stays small). A block walks its range W
// tiles (a window) at a time:
//  1. it finds where each tile edge of the window falls in every slot's
//     run by binary searches, none per posting: the window's first and
//     last edges over the whole run, those between over the run's part
//     between them, TT_SEARCH searches a thread interleaved. The window's
//     postings then form one list, tile by tile, each tile's slots from
//     the highest (prefix sums of the edge differences);
//  2. the list goes to shared memory in chunks of TT_STAGE postings,
//     across tiles (cp.async, 4 bytes a lane, a warp's copies coalesced
//     within a slot), the next chunk in flight while this one is added. A
//     tile's docs own shared-memory cells: a score, the Mode's combined
//     slot word and a presence flag. Slots go from the highest down, a
//     barrier between them; within a slot docs strictly ascend, so threads
//     write distinct cells without atomics. The first slot holding a doc
//     sets score = imp * w and the word (Mode::first); each later (lower)
//     slot adds imp * w and combines its word (Mode::add), round to
//     nearest with no contraction: the reference's sums, bit for bit;
//     A sparse tile (fewer postings than T / 4 and than TT_SPARSE_MAX)
//     that lies whole in a chunk takes no cells: each of its postings
//     looks its doc up in the tile's
//     higher slots (binary searches in the chunk, whose parts ascend); the
//     owner, the highest slot holding the doc, looks it up in the lower
//     slots and sums in their order, the same sums; a round of a posting a
//     thread covers many such tiles with two barriers, where the cells
//     take one a slot a tile. The sparse tails of the tiered headline are
//     such tiles;
//  3. once a tile is added, it offers the tile's present docs to the Mode
//     (Mode::offer: whether the doc is a hit, its final score, whether it
//     counts), counts in integers and offers the hits to the block's
//     running top-k (topk_common.cuh), kept across the range's tiles. A
//     sparse tile (fewer postings than T / 4) lists its present docs as
//     they arrive and visits only those; a dense one scans its cells. Each
//     thread tests its docs against the list's k-th key as it stands and
//     pushes the better ones; one block-wide merge takes them (tt_take):
//     one thread inserting them one at a time cost O(k) a candidate. Only
//     when more are pushed than the buffer holds (the first tiles, before
//     the list fills) does the tile go again in rounds of a doc a thread.
// With G > 1 a second kernel merges each (query, shard)'s G lists into the
// k best: the best of the full lists' k-th keys bounds the result, so only
// the entries at or above it are placed, each at its rank among all G
// lists (binary searches in the sorted lists); it sums the G counts. With
// G = 1 the tile kernel writes the outputs and no merge runs.
#pragma once

#include "topk_common.cuh"

#define TT_THREADS 256
// Postings of a chunk staged in shared memory (two chunks: one added while
// the next lands).
#define TT_STAGE 1024
// Edge searches a thread runs together.
#define TT_SEARCH 4
// A tile whole in a chunk takes the cell-free pass (2a below) when it
// holds fewer postings than this (and than T / 4): the pass's searches
// grow with a tile's postings, the cells' barriers with the tiles.
#ifndef TT_SPARSE_MAX
#define TT_SPARSE_MAX 64
#endif

__device__ __forceinline__ void tt_cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void tt_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Where doc d sits in the ascending sd[lo, hi) (-1: absent).
__device__ __forceinline__ int tt_find(const int* sd, int lo, int hi,
                                       int d) {
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sd[mid] < d) lo = mid + 1; else hi = mid;
  }
  return lo < end && sd[lo] == d ? lo : -1;
}

// Copies chunk c of a window's list into (sd, sm). The list is the
// window's postings tile by tile, each tile's slots from the highest:
// pre[t * (Q + 1) + i] is where slot Q - 1 - i's postings of tile t start
// in it (pre[t * (Q + 1) + Q] where the tile ends). Element j of the chunk
// is list entry g = c * TT_STAGE + j; a thread's entries rise, chunk
// after chunk, so its segment cursor (ct, ci) only moves forward.
__device__ __forceinline__ void tt_stage(const int* docs_s,
                                         const float* imps_s,
                                         const int* st_q, const int* edge,
                                         const int* pre, int E, int Q,
                                         int total, int c, int& ct, int& ci,
                                         int* sd, float* sm) {
  const int c0 = c * TT_STAGE;
  const int n = min(TT_STAGE, total - c0);
  for (int j = threadIdx.x; j < n; j += TT_THREADS) {
    const int g = c0 + j;
    while (g >= pre[ct * (Q + 1) + ci + 1]) {
      if (++ci == Q) {
        ci = 0;
        ++ct;
      }
    }
    const int q = Q - 1 - ci;
    const int p = st_q[q] + edge[q * E + ct] + (g - pre[ct * (Q + 1) + ci]);
    tt_cp4(sd + j, docs_s + p);
    tt_cp4(sm + j, imps_s + p);
  }
}

// Every slot's position at tile edges of a window, by binary searches, the
// searches of TT_SEARCH (slot, edge) pairs a thread run together, their
// loads in flight at once. outer: the window's first and last edges, over
// the whole run; else the edges between, over the run's part between
// those two (a few cache lines where the run is sparse in the window).
__device__ __forceinline__ void tt_edges(const int* docs_s, const int* st_q,
                                         const int* ln_q, int Q, int nw,
                                         int wtile, int tshift, int n_pad,
                                         int E, bool outer, int* edge) {
  const int per = outer ? 2 : nw - 1;
  const int n = Q * per;
  for (int j0 = threadIdx.x; j0 < n; j0 += TT_THREADS * TT_SEARCH) {
    int lo[TT_SEARCH], hi[TT_SEARCH], doc[TT_SEARCH], at[TT_SEARCH];
    const int* run[TT_SEARCH];
#pragma unroll
    for (int u = 0; u < TT_SEARCH; ++u) {
      const int j = j0 + u * TT_THREADS;
      const int q = j < n ? j / per : 0;
      const int e = outer ? (j % 2) * nw : 1 + j % per;
      run[u] = docs_s + st_q[q];
      at[u] = q * E + e;
      lo[u] = outer ? 0 : edge[q * E];
      hi[u] = j >= n ? lo[u] : (outer ? ln_q[q] : edge[q * E + nw]);
      doc[u] = (int)min((long long)(wtile + e) << tshift, (long long)n_pad);
    }
    bool busy = true;
    while (busy) {
      busy = false;
#pragma unroll
      for (int u = 0; u < TT_SEARCH; ++u) {
        if (lo[u] < hi[u]) {
          const int mid = (lo[u] + hi[u]) >> 1;
          if (run[u][mid] < doc[u]) lo[u] = mid + 1; else hi[u] = mid;
          busy |= lo[u] < hi[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TT_SEARCH; ++u)
      if (j0 + u * TT_THREADS < n) edge[at[u]] = lo[u];
  }
}

// Takes n candidates (cand.s / cand.d, pushed before a barrier) into the
// running top-k; every thread calls it, after that barrier. With the list
// in shared memory (kTopShared) the merge is block-wide: a list entry moves
// down by the candidates better than it; a candidate lands after the list
// entries better than it (a binary search) and the candidates better than
// it. Keys are unique, so the new places are a permutation of the old
// entries and the candidates, whatever order the candidates came in; the k
// best go to (tmp_s, tmp_d) and are copied back. Else one thread inserts
// them. Any block width works (the survivor kernel of K4 uses it too).
template <bool kTopShared>
__device__ void tt_take(int n, RunningTopK& top, const CandBuffer& cand,
                        float* tmp_s, int* tmp_d) {
  if (n == 0) return;
  if (!kTopShared) {
    if (threadIdx.x == 0)
      for (int i = 0; i < n; ++i) top.insert(cand.s[i], cand.d[i]);
    __syncthreads();
    return;
  }
  const int f = *top.filled, k = top.k;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const float sc = top.s[i];
    const int d = top.d[i];
    int at = i;
    for (int j = 0; j < n; ++j) at += key_better(cand.s[j], cand.d[j], sc, d);
    if (at < k) {
      tmp_s[at] = sc;
      tmp_d[at] = d;
    }
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float sc = cand.s[j];
    const int d = cand.d[j];
    int lo = 0, hi = f;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_better(top.s[mid], top.d[mid], sc, d)) lo = mid + 1;
      else hi = mid;
    }
    for (int j2 = 0; j2 < n; ++j2) lo += key_better(cand.s[j2], cand.d[j2],
                                                    sc, d);
    if (lo < k) {
      tmp_s[lo] = sc;
      tmp_d[lo] = d;
    }
  }
  __syncthreads();
  const int nf = min(k, f + n);
  for (int i = threadIdx.x; i < nf; i += blockDim.x) {
    top.s[i] = tmp_s[i];
    top.d[i] = tmp_d[i];
  }
  if (threadIdx.x == 0) *top.filled = nf;
  __syncthreads();
}

// Bytes of the tile kernel's dynamic shared memory without the running
// top-k: the candidate buffer, the slot tables (start, length, weight and
// the Mode's words), the edge table (Q x (W + 1)), the window list's slot
// and tile offsets (W x (Q + 1) and W + 1), two staged chunks (doc and
// impact), and the tile's cells (score and word, 4 bytes each, a 2-byte
// place in the list of present docs and a byte of presence a doc).
template <class Mode>
static size_t tt_tile_bytes(int Q, int W, int tshift) {
  return (size_t)TT_THREADS * 8 + (size_t)Q * (12 + 4 * Mode::kSlotWords)
         + (size_t)Q * (W + 1) * 4 + (size_t)W * (Q + 1) * 4
         + (size_t)(W + 1) * 4 + (size_t)TT_STAGE * 16
         + ((size_t)11 << tshift);
}

// Grid B * S * G; block (b, s, g) walks tiles [g * tpb, (g + 1) * tpb) of
// (b, s), W tiles at a time, and writes list (b * S + s) * G + g of
// out_vals / out_docs [.., k] and its count. kTopShared: the running top-k
// sits in shared memory with its merge buffer (and merges block-wide),
// else in the block's own list of the output (one thread inserts).
template <class Mode, bool kTopShared>
__global__ void __launch_bounds__(TT_THREADS)
tt_tiles(const int* __restrict__ docs, const float* __restrict__ imps,
         int P, const int* __restrict__ starts,
         const int* __restrict__ lengths, const float* __restrict__ idfw,
         const Mode mode, int S, int Q, int L, int n_pad, int k, int tshift,
         int n_tiles, int tpb, int W, int G, float* __restrict__ out_vals,
         int* __restrict__ out_docs, int* __restrict__ out_count) {
  extern __shared__ unsigned char smem[];
  const int T = 1 << tshift;
  const int E = W + 1;
  float* buf_s = reinterpret_cast<float*>(smem);            // [THREADS]
  int* buf_d = reinterpret_cast<int*>(buf_s + TT_THREADS);   // [THREADS]
  int* st_q = buf_d + TT_THREADS;                            // [Q]
  int* ln_q = st_q + Q;                                      // [Q]
  float* w_q = reinterpret_cast<float*>(ln_q + Q);           // [Q]
  int* words = reinterpret_cast<int*>(w_q + Q);              // [kSlotWords][Q]
  int* edge = words + (size_t)Mode::kSlotWords * Q;          // [Q][E]
  int* pre = edge + (size_t)Q * E;                           // [W][Q + 1]
  int* toff = pre + (size_t)W * (Q + 1);                     // [W + 1]
  int* stage_d = toff + W + 1;                               // [2][STAGE]
  float* stage_m = reinterpret_cast<float*>(stage_d + 2 * TT_STAGE);
  float* t_sc = stage_m + 2 * TT_STAGE;                      // [T]
  int* t_word = reinterpret_cast<int*>(t_sc + T);            // [T]
  float* tail = reinterpret_cast<float*>(t_word + T);  // top, its buffer
  unsigned short* t_list = reinterpret_cast<unsigned short*>(
      kTopShared ? tail + 4 * k : tail);                     // [T]
  unsigned char* t_flag =
      reinterpret_cast<unsigned char*>(t_list + T);          // [T]
  __shared__ int filled, ncand[3], n_match, n_present, any_sparse;

  const int bs = blockIdx.x / G, g = blockIdx.x % G;
  const int b = bs / S, s = bs % S;
  const size_t o = blockIdx.x;
  float* top_s = kTopShared ? tail : out_vals + o * k;
  int* top_d = kTopShared ? reinterpret_cast<int*>(tail + k)
                          : out_docs + o * k;
  const int tile0 = g * tpb;
  const int nt = max(0, min(tpb, n_tiles - tile0));
  const typename Mode::Row mrow = mode.row(b, s);
  const int tid = threadIdx.x;
  const int* docs_s = docs + (size_t)s * P;
  const float* imps_s = imps + (size_t)s * P;

  for (int q = tid; q < Q; q += TT_THREADS) {
    const size_t oq = (size_t)bs * Q + q;
    // dynamic_slice clamps the start so that start + L stays in the table
    int st = starts[oq];
    st = st < 0 ? 0 : (st > P - L ? P - L : st);
    int ln = lengths[oq];
    ln = ln < 0 ? 0 : (ln > L ? L : ln);
    st_q[q] = st;
    ln_q[q] = ln;
    w_q[q] = idfw[(size_t)b * Q + q];
    mode.slot(b, s, oq, q, Q, words);
  }
  for (int i = tid; i < T; i += TT_THREADS) t_flag[i] = 0;
  if (tid == 0) {
    filled = 0;
    ncand[0] = 0;
    n_match = 0;
    n_present = 0;
  }

  RunningTopK top{top_s, top_d, &filled, k};
  CandBuffer cand{buf_s, buf_d, ncand};
  int my_match = 0;
  int round = 0;
  // the range's tiles, W at a time
  for (int w0 = 0; w0 < nt; w0 += W) {
    const int nw = min(W, nt - w0);
    const int wtile = tile0 + w0;
    // the slot tables are loaded and the last window's tables read
    __syncthreads();
    // 1. every slot's positions at the window's tile edges: its first and
    // last, then those between
    tt_edges(docs_s, st_q, ln_q, Q, nw, wtile, tshift, n_pad, E, true,
             edge);
    if (tid == 0) any_sparse = 0;
    __syncthreads();
    if (nw > 1) {
      tt_edges(docs_s, st_q, ln_q, Q, nw, wtile, tshift, n_pad, E, false,
               edge);
      __syncthreads();
    }
    // the window's list: each tile's slot offsets, highest slot first,
    // then the tiles' offsets, so that pre holds places in the list
    for (int t = tid; t < nw; t += TT_THREADS) {
      int* pt = pre + t * (Q + 1);
      int acc = 0;
      for (int i = 0; i < Q; ++i) {
        pt[i] = acc;
        const int q = Q - 1 - i;
        acc += edge[q * E + t + 1] - edge[q * E + t];
      }
      pt[Q] = acc;
      if (acc > 0 && acc < min(T >> 2, TT_SPARSE_MAX))
        any_sparse = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int t = 0; t < nw; ++t) {
        toff[t] = acc;
        acc += pre[t * (Q + 1) + Q];
      }
      toff[nw] = acc;
    }
    __syncthreads();
    for (int j = tid; j < nw * (Q + 1); j += TT_THREADS)
      pre[j] += toff[j / (Q + 1)];
    __syncthreads();
    const int total = toff[nw];
    const int n_chunks = (total + TT_STAGE - 1) / TT_STAGE;
    int ct = 0, ci = 0;   // this thread's staging cursor
    int at = 0;           // the first tile not yet summed
    if (n_chunks > 0)
      tt_stage(docs_s, imps_s, st_q, edge, pre, E, Q, total, 0, ct, ci,
               stage_d, stage_m);
    tt_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      // the next chunk's copies, into the other buffer
      if (c + 1 < n_chunks)
        tt_stage(docs_s, imps_s, st_q, edge, pre, E, Q, total, c + 1, ct,
                 ci, stage_d + (buf ^ 1) * TT_STAGE,
                 stage_m + (buf ^ 1) * TT_STAGE);
      tt_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      const int c0 = c * TT_STAGE;
      const int c1 = min(total, c0 + TT_STAGE);
      const int* sd = stage_d + buf * TT_STAGE;
      const float* sm = stage_m + buf * TT_STAGE;
      // 2a. the sparse tiles (fewer postings than T / 4 and than
      // TT_SPARSE_MAX) that lie whole in this chunk, without cells or a
      // barrier a slot: a posting owns its
      // doc iff no higher slot of its tile holds it (a binary search in
      // that slot's ascending part of the chunk); an owner sums its lower
      // slots' contributions in order, as the cells would, and offers its
      // doc. A round of a posting a thread, one take a round.
      for (int x0 = c0; any_sparse && x0 < c1; x0 += TT_THREADS, ++round) {
        cand.reset_next(round);
        const int x = x0 + tid;
        if (x < c1) {
          // its tile: the last whose list starts at or before x
          int lo = 0, hi = nw;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (pre[mid * (Q + 1)] <= x) lo = mid; else hi = mid;
          }
          const int* pt = pre + lo * (Q + 1);
          if (pt[0] >= c0 && pt[Q] <= c1 &&
              pt[Q] - pt[0] < min(T >> 2, TT_SPARSE_MAX)) {
            // its slot: the last whose part starts at or before x
            int i = 0, i1 = Q;
            while (i1 - i > 1) {
              const int mid = (i + i1) >> 1;
              if (pt[mid] <= x) i = mid; else i1 = mid;
            }
            const int d = sd[x - c0];
            bool owner = true;
            for (int i2 = 0; i2 < i && owner; ++i2)
              owner = tt_find(sd, pt[i2] - c0, pt[i2 + 1] - c0, d) < 0;
            if (owner) {
              const int q = Q - 1 - i;
              float sc = __fmul_rn(sm[x - c0], w_q[q]);
              int word = mode.first(words, q);
              for (int i2 = i + 1; i2 < Q; ++i2) {
                const int p = tt_find(sd, pt[i2] - c0, pt[i2 + 1] - c0, d);
                if (p >= 0) {
                  const int q2 = Q - 1 - i2;
                  sc = __fadd_rn(sc, __fmul_rn(sm[p], w_q[q2]));
                  word = mode.add(word, words, q2);
                }
              }
              bool counted;
              if (mode.offer(mrow, words, Q, word, d, sc, counted)) {
                my_match += counted;
                if (k > 0 && top.beats(sc, d)) cand.push(round, sc, d);
              }
            }
          }
        }
        __syncthreads();
        tt_take<kTopShared>(ncand[round % 3], top, cand, tail + 2 * k,
                            reinterpret_cast<int*>(tail + 3 * k));
      }
      // 2b. the other tiles whose postings lie in this chunk, in order
      for (; at < nw && pre[at * (Q + 1)] < c1; ++at) {
        const int* pt = pre + at * (Q + 1);
        const int t0 = (wtile + at) << tshift;
        const int tot = pt[Q] - pt[0];
        if (tot == 0) continue;
        // a sparse tile lists its present docs as they arrive; a dense
        // one's are found by a scan of its cells
        const bool listed = tot < (T >> 2);
        if (pt[0] >= c0 && pt[Q] <= c1 &&
            tot < min(T >> 2, TT_SPARSE_MAX))
          continue;   // 2a's
        // 2. this chunk's part of tile at, slot by slot
        for (int i = 0; i < Q; ++i) {
          const int s0 = max(pt[i], c0), s1 = min(pt[i + 1], c1);
          if (s0 >= s1) continue;
          const int q = Q - 1 - i;
          const float w = w_q[q];
          for (int j0 = s0; j0 < s1; j0 += TT_THREADS) {
            const int j = j0 + tid;
            int d = 0;
            bool first = false;
            if (j < s1) {
              d = sd[j - c0] - t0;
              const float x = __fmul_rn(sm[j - c0], w);
              if (t_flag[d]) {
                t_sc[d] = __fadd_rn(t_sc[d], x);
                t_word[d] = mode.add(t_word[d], words, q);
              } else {
                t_sc[d] = x;
                t_word[d] = mode.first(words, q);
                t_flag[d] = 1;
                first = true;
              }
            }
            // the warp's new docs join the list with one atomic
            const unsigned m = __ballot_sync(0xffffffffu, first && listed);
            if (m) {
              const int lane = tid & 31, lead = __ffs(m) - 1;
              int a = 0;
              if (lane == lead) a = atomicAdd(&n_present, __popc(m));
              a = __shfl_sync(0xffffffffu, a, lead);
              if (first) t_list[a + __popc(m & ((1u << lane) - 1))] = d;
            }
          }
          // this slot's adds before the lower slot's
          __syncthreads();
        }
        if (pt[Q] > c1) break;   // the tile goes on in the next chunk
        // 3. the tile is summed. Every thread offers its present docs and
        // pushes the hits that beat the list's k-th key as it stands; one
        // take after. If more were pushed than the buffer holds, the
        // tile's docs go again in rounds, a doc a thread, each round's
        // candidates taken before the next round tests.
        const int n_doc = listed ? n_present : min(T, n_pad - t0);
        int mine = 0;
        cand.reset_next(round);
        for (int x = tid; x < n_doc; x += TT_THREADS) {
          const int i = listed ? t_list[x] : x;
          if (!listed && !t_flag[i]) continue;
          float sc = t_sc[i];
          bool counted;
          if (mode.offer(mrow, words, Q, t_word[i], t0 + i, sc, counted)) {
            mine += counted;
            if (k > 0 && top.beats(sc, t0 + i)) {
              const int a = atomicAdd(&ncand[round % 3], 1);
              if (a < TT_THREADS) {
                buf_s[a] = sc;
                buf_d[a] = t0 + i;
              }
            }
          }
        }
        __syncthreads();
        const int n_cand = ncand[round % 3];
        ++round;
        if (n_cand <= TT_THREADS) {
          tt_take<kTopShared>(n_cand, top, cand, tail + 2 * k,
                              reinterpret_cast<int*>(tail + 3 * k));
          my_match += mine;
        } else {
          for (int base = 0; base < n_doc; base += TT_THREADS, ++round) {
            cand.reset_next(round);
            const int x = base + tid;
            const int i = x < n_doc ? (listed ? t_list[x] : x) : 0;
            if (x < n_doc && (listed || t_flag[i])) {
              float sc = t_sc[i];
              bool counted;
              if (mode.offer(mrow, words, Q, t_word[i], t0 + i, sc,
                             counted)) {
                my_match += counted;
                if (top.beats(sc, t0 + i)) cand.push(round, sc, t0 + i);
              }
            }
            __syncthreads();
            tt_take<kTopShared>(ncand[round % 3], top, cand, tail + 2 * k,
                                reinterpret_cast<int*>(tail + 3 * k));
          }
        }
        // the tile's cells are read (the barriers above): clear its flags
        for (int x = tid; x < n_doc; x += TT_THREADS)
          t_flag[listed ? t_list[x] : x] = 0;
        // every thread has read n_present: the reset comes before the next
        // tile's adds, past the barrier ahead of them
        if (tid == 0) n_present = 0;
        __syncthreads();
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (my_match) atomicAdd(&n_match, my_match);
  __syncthreads();
  top.write(out_vals + o * k, out_docs + o * k, n_pad);
  if (tid == 0) out_count[o] = n_match;
}

// Grid B * S: the G lists of (b, s) (part_vals / part_docs [B * S, G, k],
// each best first, empty places at doc n_pad) merged into the k best and
// their counts summed. Dynamic shared memory: the G lists, 8 G k bytes.
// (Mode names the kernel apart for each source, nothing else.)
template <class Mode>
__global__ void __launch_bounds__(TT_THREADS)
tt_merge(const float* __restrict__ part_vals,
         const int* __restrict__ part_docs,
         const int* __restrict__ part_count, int G, int k, int n_pad,
         float* __restrict__ out_vals, int* __restrict__ out_docs,
         int* __restrict__ out_count) {
  extern __shared__ unsigned char smem[];
  const int n = G * k;
  float* ps = reinterpret_cast<float*>(smem);                // [G * k]
  int* pd = reinterpret_cast<int*>(ps + n);                  // [G * k]
  __shared__ int n_valid, total, bar_d;
  __shared__ float bar_s;
  const int bs = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)bs * n;
#pragma unroll 4
  for (int j = tid; j < n; j += TT_THREADS) {
    ps[j] = part_vals[base + j];
    pd[j] = part_docs[base + j];
  }
  if (tid == 0) {
    n_valid = 0;
    total = 0;
  }
  __syncthreads();
  if (tid == 0) {
    // the best k-th key of the full lists: k entries lie at or above it,
    // so an entry below it ranks k or lower
    bar_s = -CUDART_INF_F;
    bar_d = n_pad;
    for (int h = 0; h < G && k > 0; ++h) {
      const int j = h * k + k - 1;
      if (pd[j] < n_pad && (bar_d >= n_pad ||
                            key_better(ps[j], pd[j], bar_s, bar_d))) {
        bar_s = ps[j];
        bar_d = pd[j];
      }
    }
  }
  int my_valid = 0, my_count = 0;
  for (int h = tid; h < G; h += TT_THREADS)
    my_count += part_count[(size_t)bs * G + h];
  __syncthreads();
  const float b_s = bar_s;
  const int b_d = bar_d;
  float* ov = out_vals + (size_t)bs * k;
  int* od = out_docs + (size_t)bs * k;
  // entry p of list g is x = p * G + g: the lists' heads, where the
  // result comes from, spread over the threads
  for (int x = tid; x < n; x += TT_THREADS) {
    const int g = x % G, j = g * k + x / G;
    const int d = pd[j];
    if (d >= n_pad) continue;
    ++my_valid;
    const float sc = ps[j];
    if (b_d < n_pad && key_better(b_s, b_d, sc, d)) continue;
    // its place in its own list, then the entries of every other list
    // that come before it: a prefix of that list
    int rank = j - g * k;
    for (int h = 0; h < G && rank < k; ++h) {
      if (h == g) continue;
      const float* hs = ps + h * k;
      const int* hd = pd + h * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_better(hs[mid], hd[mid], sc, d)) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      ov[rank] = sc;
      od[rank] = d;
    }
  }
  if (my_valid) atomicAdd(&n_valid, my_valid);
  if (my_count) atomicAdd(&total, my_count);
  __syncthreads();
  for (int i = min(n_valid, k) + tid; i < k; i += TT_THREADS) {
    ov[i] = -CUDART_INF_F;
    od[i] = n_pad;
  }
  if (tid == 0) out_count[bs] = total;
}

// The tile kernel's launch for these sizes: its dynamic shared memory, and
// whether the running top-k and its merge buffer fit there.
template <class Mode>
static void tt_tile_launch(int Q, int k, int tshift, int W, size_t* shm,
                           bool* top_shared) {
  *shm = tt_tile_bytes<Mode>(Q, W, tshift);
  *top_shared = *shm + (size_t)k * 16 <= (size_t)es_max_shared_bytes();
  if (*top_shared) *shm += (size_t)k * 16;
}

// Blocks of the tile kernel one SM holds at these sizes (0 when none
// fits): the plan's occupancy, for measurement.
template <class Mode>
static int tt_blocks_per_sm(int Q, int k, int tshift, int W) {
  size_t shm;
  bool top_shared;
  tt_tile_launch<Mode>(Q, k, tshift, W, &shm, &top_shared);
  auto kernel = top_shared ? tt_tiles<Mode, true> : tt_tiles<Mode, false>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TT_THREADS, shm);
  return n;
}

// The plan: tiles of 2^tshift docs (tshift in [5, 16]), tpb tiles a block,
// their edges W tiles at a time, G blocks a (query, shard) covering n_pad;
// with G > 1, part_vals / part_docs [B * S * G * k] and part_count
// [B * S * G] hold the blocks' lists (unused with G = 1). One call: the
// tile kernel, then with G > 1 the merge.
template <class Mode>
static int tt_launch(const Mode& mode, const int* docs, const float* imps,
                     int P, const int* starts, const int* lengths,
                     const float* idfw, int B, int S, int Q, int L,
                     int n_pad, int k, int tshift, int tpb, int W, int G,
                     float* part_vals, int* part_docs, int* part_count,
                     float* out_vals, int* out_docs, int* out_count,
                     cudaStream_t st) {
  if (B * S == 0) return 0;
  const long long n_tiles = ((long long)n_pad + (1 << tshift) - 1) >> tshift;
  if (tshift < 5 || tshift > 16 || tpb <= 0 || W <= 0 || G <= 0 || k < 0 ||
      Q < 0 || n_pad < 0 || (long long)G * tpb < n_tiles ||
      (n_tiles > 0 && (long long)(G - 1) * tpb >= n_tiles))
    return ES_ERR_SIZE;
  size_t shm;
  bool top_shared;
  tt_tile_launch<Mode>(Q, k, tshift, W, &shm, &top_shared);
  auto kernel = top_shared ? tt_tiles<Mode, true> : tt_tiles<Mode, false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  const bool merge = G > 1;
  const size_t m_shm = (size_t)G * k * 8;
  if (merge) {
    e = es_set_shared(tt_merge<Mode>, m_shm);
    if (e != 0) return e;
  }
  kernel<<<B * S * G, TT_THREADS, shm, st>>>(
      docs, imps, P, starts, lengths, idfw, mode, S, Q, L, n_pad, k, tshift,
      (int)n_tiles, tpb, W, G, merge ? part_vals : out_vals,
      merge ? part_docs : out_docs, merge ? part_count : out_count);
  e = (int)cudaGetLastError();
  if (e != 0 || !merge) return e;
  tt_merge<Mode><<<B * S, TT_THREADS, m_shm, st>>>(
      part_vals, part_docs, part_count, G, k, n_pad, out_vals, out_docs,
      out_count);
  return (int)cudaGetLastError();
}
