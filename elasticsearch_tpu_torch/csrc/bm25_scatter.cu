// K16: whole-segment BM25 scatter scorer.
//
// Replaces elasticsearch_tpu/ops/bm25.py:bm25_score_body (:40, jitted by
// _bm25_kernel / get_bm25_kernel): for each of Q postings runs (starts,
// lengths, at most L postings a run) every posting adds
//
//   ((idf * w) * (k1 + 1) * tf) / max(fma(k1, (1 - b) + (b * dl) / avgdl,
//                                          tf), 1e-9)
//
// into scores[doc] (f32[seg_pad]) and one into matched[doc] (i32[seg_pad]),
// with dl = doc_len[doc]. The FMA is where XLA:CPU contracts the reference's
// k1 * (...) + tf (settled by tests/test_torch_segment.py); every other step
// is one rounded f32 operation, written with the _rn intrinsics so that
// nvcc contracts nothing else.
//
// Index rules (the reference's jnp.take(mode="fill") and .at[].add(
// mode="drop")): a postings index or a doc in [-n, 0) wraps to index + n;
// any other index outside [0, n) reads the fill (doc seg_pad, tf 0, dl 0)
// or drops its update.
//
// Order of the sums: XLA applies the scatter's updates in (slot, position)
// order, so each doc's score is ((0 + c_slot0) + c_slot1) + ... Every run
// holds a doc at most once (SegmentBuilder builds runs doc-ascending), so
// within a slot no two threads add to one doc, and slots are added in
// order: the same bits on every run, with no float atomics.
//
// Bound: bytes. The function needs each valid posting's doc id and tf once
// (8 bytes), the doc lengths of the docs it touches (4 bytes each) and each
// output word written once (8 bytes a doc): 8 V + 4 D + 8 seg_pad. A grid
// a slot adding into the outputs in device memory would instead zero them
// and then read and write a 32-byte sector of each for every posting, over
// arrays larger than L2: a head term streams the outputs again in every
// slot. So doc tiles own their outputs:
//
// 1. k16_prepass, one block a (slot, chunk of CH positions): marks
//    the chunk clean when the run's positions lie in [0, P) without a wrap
//    (start >= 0, start + len <= P), its docs lie in [0, seg_pad) and
//    rise strictly from the position before; and for every position p
//    writes off[q][t] = p for the tiles t whose first doc t * T lies in
//    (doc[p - 1], doc[p]], and the last position off[q][t] = len for the
//    tiles past its doc, up to t = n_tiles: for a clean run, off[q][t] is
//    the first position whose doc is at least t * T, a row-pointer build in
//    one read of the doc ids. SegmentBuilder's runs are always clean.
// 2. k16_tile, one block a tile of T docs: zeroes a tile of scores and
//    counts in shared memory, walks the slots in order with a barrier
//    between them (loading slot q + 1's inputs while slot q's postings
//    load), and writes the tile once, coalesced. A clean slot adds
//    positions [off[q][t], off[q][t + 1]); a slot that is not clean (some
//    chunk not clean: inputs SegmentBuilder never makes) reads its whole
//    run in every tile, applies the index rules to each posting and keeps
//    those whose doc falls in the tile. Neither memset nor atomics remain.
//
// Both kernels issue the loads of K16_UNROLL positions a thread together
// (the doc ids and tfs, then the doc lengths), so each thread keeps that
// many requests in flight: the run is latency-bound otherwise. The slots'
// inputs (start, length, idf, w) ride in the launch's parameters up to
// K16_QMAX slots (es_bm25_scatter_param_slots, which the wrapper asks), so
// a call copies nothing to the card before its launches (a pageable copy
// would wait for the stream's earlier work); past that they are read from
// device memory. The tile T = 2^tshift, the chunk CH
// and the chunks n_ch (enough for the longest run) come from the wrapper
// (ops/bm25.py: bm25_scatter_plan), which allocates off and the flags as
// one scratch of Q (n_tiles + 1 + n_ch) ints.

#include "topk_common.cuh"

#define K16_THREADS 256
// Positions a thread of either kernel handles at once: their loads are
// issued together.
#define K16_UNROLL 8
// Slots whose inputs ride in the launch's parameters.
#define K16_QMAX 64

// The slots' inputs as words: start, length, idf bits, w bits.
struct K16Slots {
  int v[4][K16_QMAX];
};

// Word f of slot q: from the parameters, or from device memory (4 Q words,
// f-major) when the launch has more than K16_QMAX slots.
#define K16_WORD(f, q) (g != nullptr ? g[(size_t)(f) * Q + (q)] : sp.v[f][q])

// A posting's doc length: doc is the raw id (before the scatter's wrap),
// and wraps over n_dl as the reference's take does.
__device__ __forceinline__ float k16_dl(int doc,
                                        const float* __restrict__ doc_len,
                                        int n_dl) {
  const long long dd = doc < 0 ? (long long)doc + n_dl : (long long)doc;
  return (dd >= 0 && dd < n_dl) ? doc_len[dd] : 0.0f;
}

// A posting's contribution, where c0 = (idf * w) * (k1 + 1) and omb =
// 1 - b.
__device__ __forceinline__ float k16_contrib(float dl, float t, float c0,
                                             float omb, float avgdl,
                                             float k1, float b) {
  const float x = __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl));
  const float norm = __fmaf_rn(k1, x, t);
  const float den = norm != norm ? norm : fmaxf(norm, 1e-9f);
  return __fdiv_rn(__fmul_rn(c0, t), den);
}

__device__ __forceinline__ long long k16_clip(int length, int L) {
  return min(max((long long)length, 0LL), (long long)L);
}

// Grid (Q, n_ch). clean[q * n_ch + chunk]: 1 where the chunk is clean.
__global__ void __launch_bounds__(K16_THREADS)
k16_prepass(const int* __restrict__ docs, long long P, const K16Slots sp,
            const int* __restrict__ g, int Q, int L, int seg_pad,
            int tshift, int n_tiles, int CH, int n_ch, int* __restrict__ off,
            int* __restrict__ clean) {
  const int q = blockIdx.x, ch = blockIdx.y;
  const long long len = k16_clip(K16_WORD(1, q), L);
  const long long start = K16_WORD(0, q);
  const long long lo = (long long)ch * CH;
  const long long hi = min(len, lo + CH);
  const int lane = threadIdx.x & 31;
  int* o = off + (size_t)q * (n_tiles + 1);
  const bool inside = start >= 0 && start + len <= P;
  bool ok = inside;
  if (len == 0) {
    // an empty run: every tile starts at position 0
    if (ch == 0)
      for (int t = threadIdx.x; t <= n_tiles; t += K16_THREADS) o[t] = 0;
  } else if (inside && lo < hi) {
    for (long long p0 = lo + threadIdx.x; p0 - threadIdx.x < hi;
         p0 += (long long)K16_THREADS * K16_UNROLL) {
      int d[K16_UNROLL], before[K16_UNROLL];
#pragma unroll
      for (int u = 0; u < K16_UNROLL; ++u) {
        const long long p = p0 + (long long)u * K16_THREADS;
        d[u] = p < hi ? docs[start + p] : 0;
        // a warp's lanes hold consecutive positions: lane 0 reads the doc
        // before its own
        before[u] = (lane == 0 && p > 0 && p < hi) ? docs[start + p - 1] : -1;
      }
#pragma unroll
      for (int u = 0; u < K16_UNROLL; ++u) {
        const long long p = p0 + (long long)u * K16_THREADS;
        const int up = __shfl_up_sync(0xffffffffu, d[u], 1);
        const int prev = p == 0 ? -1 : (lane == 0 ? before[u] : up);
        if (p >= hi) continue;
        ok &= d[u] >= 0 && d[u] < seg_pad && d[u] > prev;
        // tiles whose first doc lies in (prev, d] start here; past the
        // last position's doc, tiles start at len
        const int t_lo = prev < 0 ? 0 : min((prev >> tshift) + 1, n_tiles + 1);
        const int t_hi = d[u] < 0 ? -1 : min(d[u] >> tshift, n_tiles);
        for (int t = t_lo; t <= t_hi; ++t) o[t] = (int)p;
        if (p == len - 1)
          for (int t = max(t_hi + 1, 0); t <= n_tiles; ++t) o[t] = (int)len;
      }
    }
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) clean[(size_t)q * n_ch + ch] = ok;
}

// A slot's inputs as the tile kernel reads them.
struct K16Slot {
  long long len, start;
  float c0;     // (idf * w) * (k1 + 1): the reference's f32 scalars
  int lo, hi;   // the tile's positions of a clean run
  int bad;      // chunks this thread found not clean
};

// Slot q's inputs into sl (a K16Slot), in k16_tile: its length, start and
// c0 from the slot words, its positions in this tile, and the chunks this
// thread finds not clean.
#define K16_READ_SLOT(sl, q)                                              \
  do {                                                                    \
    (sl).len = k16_clip(K16_WORD(1, q), L);                               \
    (sl).start = K16_WORD(0, q);                                          \
    (sl).c0 = __fmul_rn(__fmul_rn(__int_as_float(K16_WORD(2, q)),         \
                                  __int_as_float(K16_WORD(3, q))),        \
                        kp1);                                             \
    const int* o_ = off + (size_t)(q) * (n_tiles + 1);                    \
    (sl).lo = o_[tile];                                                   \
    (sl).hi = o_[tile + 1];                                               \
    (sl).bad = 0;                                                         \
    for (long long c_ = threadIdx.x; c_ * CH < (sl).len; c_ += K16_THREADS) \
      (sl).bad += !clean[(size_t)(q) * n_ch + c_];                        \
  } while (0)

// Grid n_tiles; dynamic shared memory 2^tshift floats and ints.
__global__ void __launch_bounds__(K16_THREADS)
k16_tile(const int* __restrict__ docs, const float* __restrict__ tf,
         long long P, const float* __restrict__ doc_len, int n_dl,
         const K16Slots sp, const int* __restrict__ g, int Q, int L,
         int seg_pad, float avgdl, float k1, float b, int tshift,
         int n_tiles, int CH, int n_ch, const int* __restrict__ off,
         const int* __restrict__ clean, float* __restrict__ scores,
         int* __restrict__ matched) {
  extern __shared__ float sh_f[];
  const int T = 1 << tshift;
  float* s_sc = sh_f;                                  // [T]
  int* s_ct = reinterpret_cast<int*>(sh_f + T);        // [T]
  const int tile = blockIdx.x;
  const long long d0 = (long long)tile << tshift;
  const int width = (int)min((long long)T, (long long)seg_pad - d0);
  for (int i = threadIdx.x; i < width; i += K16_THREADS) {
    s_sc[i] = 0.0f;
    s_ct[i] = 0;
  }
  const float omb = __fsub_rn(1.0f, b);
  const float kp1 = __fadd_rn(k1, 1.0f);
  K16Slot next;
  if (Q > 0) K16_READ_SLOT(next, 0);
  for (int q = 0; q < Q; ++q) {
    const K16Slot sl = next;
    // the barrier orders slot q - 1's adds (and the zeroing) before these
    const bool is_clean = !__syncthreads_or(sl.bad);
    // slot q + 1's inputs load while this slot's postings do
    if (q + 1 < Q) K16_READ_SLOT(next, q + 1);
    if (sl.len == 0) continue;
    if (is_clean) {
      for (int p0 = sl.lo + threadIdx.x; p0 - (int)threadIdx.x < sl.hi;
           p0 += K16_THREADS * K16_UNROLL) {
        int doc[K16_UNROLL];
        float t[K16_UNROLL], dl[K16_UNROLL];
#pragma unroll
        for (int u = 0; u < K16_UNROLL; ++u) {
          const int p = p0 + u * K16_THREADS;
          doc[u] = p < sl.hi ? docs[sl.start + p] : (int)d0;
          t[u] = p < sl.hi ? tf[sl.start + p] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < K16_UNROLL; ++u)
          dl[u] = k16_dl(doc[u], doc_len, n_dl);
#pragma unroll
        for (int u = 0; u < K16_UNROLL; ++u) {
          if (p0 + u * K16_THREADS >= sl.hi) break;
          const float c =
              k16_contrib(dl[u], t[u], sl.c0, omb, avgdl, k1, b);
          const int i = doc[u] - (int)d0;
          s_sc[i] = __fadd_rn(s_sc[i], c);
          s_ct[i] += 1;
        }
      }
    } else {
      for (long long p = threadIdx.x; p < sl.len; p += K16_THREADS) {
        long long idx = sl.start + p;
        if (idx < 0) idx += P;
        int doc = seg_pad;
        if (idx >= 0 && idx < P) doc = docs[idx];
        const long long sd =
            doc < 0 ? (long long)doc + seg_pad : (long long)doc;
        if (sd < d0 || sd >= d0 + width) continue;
        const float c = k16_contrib(k16_dl(doc, doc_len, n_dl), tf[idx],
                                    sl.c0, omb, avgdl, k1, b);
        const int i = (int)(sd - d0);
        s_sc[i] = __fadd_rn(s_sc[i], c);
        s_ct[i] += 1;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += K16_THREADS) {
    scores[d0 + i] = s_sc[i];
    matched[d0 + i] = s_ct[i];
  }
}

// The slots whose inputs a launch takes in its parameters: past them the
// wrapper passes dev_slots.
extern "C" int es_bm25_scatter_param_slots(void) { return K16_QMAX; }

// host_slots: the slots' 4 Q words on the host (start, length, idf bits,
// w bits, f-major); dev_slots: the same on the card, needed (and read)
// only past K16_QMAX slots.
extern "C" int es_bm25_scatter(const int* docs, const float* tf, long long P,
                               const float* doc_len, int n_dl,
                               const int* host_slots, const int* dev_slots,
                               int Q, int L, int seg_pad, float avgdl,
                               float k1, float b, int tshift, int CH,
                               int n_ch, int* scratch, float* out_scores,
                               int* out_matched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (seg_pad <= 0) return 0;
  if (tshift < 0 || tshift > 14 || CH <= 0 || n_ch <= 0 || L < 0 || Q < 0)
    return ES_ERR_SIZE;
  K16Slots sp;
  const int* g = nullptr;
  if (Q <= K16_QMAX) {
    for (int f = 0; f < 4; ++f)
      for (int q = 0; q < Q; ++q) sp.v[f][q] = host_slots[(size_t)f * Q + q];
  } else {
    if (dev_slots == nullptr) return (int)cudaErrorInvalidValue;
    g = dev_slots;
  }
  const int n_tiles = (int)(((long long)seg_pad + (1 << tshift) - 1) >> tshift);
  int* off = scratch;
  int* clean = scratch + (size_t)Q * (n_tiles + 1);
  if (Q > 0) {
    k16_prepass<<<dim3(Q, n_ch), K16_THREADS, 0, st>>>(
        docs, P, sp, g, Q, L, seg_pad, tshift, n_tiles, CH, n_ch, off,
        clean);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  // the tile kernel's shared memory: the attribute holds for the current
  // device only, so it is set on every launch
  const size_t shm = (size_t)8 << tshift;
  {
    const int e = es_set_shared(k16_tile, shm);
    if (e != 0) return e;
  }
  k16_tile<<<n_tiles, K16_THREADS, shm, st>>>(
      docs, tf, P, doc_len, n_dl, sp, g, Q, L, seg_pad, avgdl, k1, b, tshift,
      n_tiles, CH, n_ch, off, clean, out_scores, out_matched);
  return (int)cudaGetLastError();
}
