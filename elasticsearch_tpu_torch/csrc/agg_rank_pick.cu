// K13: masked rank pick over the count prefix (percentiles) and the HLL
// register max.
//
// Replaces elasticsearch_tpu/ops/aggs.py:_rank_pick (:138) and the tail of
// masked_register_max (:369), both over K12's masked-count prefix c
// (c[i] = masked pairs before pair i, non-decreasing).
//
// Pick mode: the r-th masked value of run o sits at lower_bound(c,
// c[off[o]] + r + 1) - 1 (jnp.searchsorted, side left), clipped to [0, M);
// the two ranks lo and hi are gathered and interpolated as fma(f, b, (1 -
// f) * a), the form XLA:CPU compiles the reference's (1 - f) * a + f * b
// into at config #3's [10, 3] shape.
//
// Register mode: the run's count is c[off[v+1]] - c[off[v]]; its last
// masked pair (rhos ascend within the run, so it holds the max) is
// lower_bound(c, c[off[v+1]]) - 1; 0 where the count is 0.
//
// Bound: latency. A search is a chain of dependent reads of a prefix far
// larger than L2 (2^28 entries on config #3's caches), a few hundred
// bytes in all. A binary search over all of c is 29 such reads; this
// design cuts the chain:
// - Pick: a warp (a block of its own, so the warps' scattered reads
//   spread over the SMs) serves one (bucket, rank) entry. What c says at
//   the run's two ends confines each search to the run (or to the prefix
//   before or after it, which keeps every target's answer exact). A round
//   reads 32 * K13_LANE_PIVOTS pivots at once and the warp's ballots name
//   the group that holds the answer: 4 rounds for a run of 2^25 pairs.
//   hi's answer is the next masked pair after lo's: one read of the 32
//   entries after lo's finds it, the search inside its range the rare
//   miss.
// - Registers: a thread a register, its warp's 32 registers read
//   together. A register's last masked pair is almost always among its
//   run's last 32 pairs: for each of the 32 runs in turn the warp reads
//   those entries of c in one coalesced load (all 32 loads in flight at
//   once, with c at the run's start) and ballots. Thousands of runs may
//   miss at a sparse mask (15,918 of 16,384 at 0.1 %), so the fallback
//   is each thread's own search inside its run, all runs' searches in
//   flight together. A warp search there read about 130 MB of c and
//   took 10x the binary search that one thread a run over all of c had
//   taken.
// One launch a call, no shared state.

#include "topk_common.cuh"

#define K13_PICK_THREADS 32
#define K13_REG_THREADS 128
#define K13_LANE_PIVOTS 4
#define K13_FULL 0xffffffffu

__device__ __forceinline__ long long k13_clip(long long i, long long M) {
  return i < 0 ? 0 : (i > M - 1 ? M - 1 : i);
}

// lower_bound(c, t) where it is known to lie in [lo, hi]: the first j in
// [lo, hi) with c[j] >= t, else hi (never read). A round splits [lo, hi)
// into G groups of s entries; lane l reads the last entry of groups
// p * 32 + l (an entry past hi counts as reaching t); the first group
// whose last entry reaches t holds the answer. Every lane returns it.
__device__ __forceinline__ long long k13_warp_search(
    const int* __restrict__ c, long long lo, long long hi, int t, int lane) {
  constexpr long long G = 32 * K13_LANE_PIVOTS;
  while (lo < hi) {
    const long long s = (hi - lo + G - 1) / G;
    bool reach[K13_LANE_PIVOTS];
#pragma unroll
    for (int p = 0; p < K13_LANE_PIVOTS; ++p) {
      const long long e = lo + (long long)(p * 32 + lane + 1) * s - 1;
      reach[p] = e >= hi || c[e] >= t;
    }
    long long g = G;
#pragma unroll
    for (int p = K13_LANE_PIVOTS - 1; p >= 0; --p) {
      const unsigned bal = __ballot_sync(K13_FULL, reach[p]);
      if (bal) g = p * 32 + __ffs(bal) - 1;
    }
    if (g == G) return hi;
    lo += g * s;
    hi = min(lo + s - 1, hi);
  }
  return lo;
}

// The same search, looking first at the 32 entries from lo: where the
// answer is the next masked pair after lo, that one read finds it.
__device__ __forceinline__ long long k13_warp_search_near(
    const int* __restrict__ c, long long lo, long long hi, int t, int lane) {
  const long long e = lo + lane;
  const unsigned bal = __ballot_sync(K13_FULL, e < hi && c[e] >= t);
  if (bal) return lo + __ffs(bal) - 1;
  return k13_warp_search(c, min(lo + 32, hi), hi, t, lane);
}

// lower_bound(c, t) in [lo, hi) by one thread: the first j with c[j] >=
// t, else hi (never read). A round reads the last entry of each half of
// [lo, hi) and keeps the first half whose last entry reaches t, less
// that entry, so an answer d entries before hi is found within d + 1
// rounds: where a run's window misses at a dense mask, its last masked
// pair mostly lies a few entries before the window.
__device__ __forceinline__ long long k13_thread_search(
    const int* __restrict__ c, long long lo, long long hi, int t) {
  while (lo < hi) {
    const long long s = (hi - lo + 1) / 2;
    const bool first = c[lo + s - 1] >= t;
    const bool second = lo + 2 * s - 1 >= hi || c[lo + 2 * s - 1] >= t;
    if (first) {
      hi = lo + s - 1;
    } else if (second) {
      lo += s;
      hi = min(lo + s - 1, hi);
    } else {
      return hi;
    }
  }
  return lo;
}

// Where lower_bound(c, t) lies, from c at a run's start a (ca) and end b
// (cb; b < 0: the run has no end, the ordinal past the last run): before
// the run, inside it, or after it.
__device__ __forceinline__ void k13_range(long long n_c, int t, long long a,
                                          int ca, long long b, int cb,
                                          long long& lo, long long& hi) {
  if (t <= ca) {
    lo = 0;
    hi = a;
  } else if (b < 0) {
    lo = a + 1;
    hi = n_c;
  } else if (t <= cb) {
    lo = a + 1;
    hi = b;
  } else {
    lo = b + 1;
    hi = n_c;
  }
}

__global__ void __launch_bounds__(K13_PICK_THREADS)
k13_pick_kernel(const int* __restrict__ c, long long n_c,
                const int* __restrict__ offsets, int V,
                const float* __restrict__ vals, long long M,
                const int* __restrict__ ordinals,
                const int* __restrict__ lo, const int* __restrict__ hi,
                const float* __restrict__ frac, int R,
                float* __restrict__ out) {
  const int lane = threadIdx.x;
  const long long i = blockIdx.x;
  const int o = min(max(ordinals[i / R], 0), V);
  const int r_lo = lo[i], r_hi = hi[i];
  const long long a = offsets[o];
  const long long b = o < V ? offsets[o + 1] : -1;
  const int ca = c[a];
  const int cb = b >= 0 ? c[b] : 0;
  // the targets wrap as the plain version's int32 sums do
  const int t1 = (int)((unsigned)ca + (unsigned)r_lo + 1u);
  const int t2 = (int)((unsigned)ca + (unsigned)r_hi + 1u);
  long long l1, h1, l2, h2;
  k13_range(n_c, t1, a, ca, b, cb, l1, h1);
  k13_range(n_c, t2, a, ca, b, cb, l2, h2);
  const long long j1 = k13_warp_search(c, l1, h1, t1, lane);
  long long j2 = j1;
  if (t2 > t1)
    j2 = k13_warp_search_near(c, max(l2, j1), h2, t2, lane);
  else if (t2 < t1)
    j2 = k13_warp_search(c, l2, min(h2, j1), t2, lane);
  if (lane == 0) {
    const float va = vals[k13_clip(j1 - 1, M)];
    const float vb = vals[k13_clip(j2 - 1, M)];
    const float f = frac[i];
    out[i] = __fmaf_rn(f, vb, __fmul_rn(__fsub_rn(1.0f, f), va));
  }
}

// Each of the warp's 32 runs (a, b] in turn: lane l reads c[b - 31 + l]
// (c[a] where that lies at or before a), so lane 31 reads c[b], and the
// warp ballots on which entries reach c[b]. The thread gets its own
// run's c[b] (en) and ballot (bal): its first lane that reaches en marks
// lower_bound(c, en), or lies at or before it where that is lane 0. A
// run with no pair gives no ballot and en = c[a].
__device__ __forceinline__ void k13_window(const int* __restrict__ c, int a,
                                           int b, int lane, int& en,
                                           unsigned& bal) {
  int w[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int ar = __shfl_sync(K13_FULL, a, r);
    const int p = __shfl_sync(K13_FULL, b, r) - 31 + lane;
    w[r] = c[p > ar ? p : ar];
  }
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int ar = __shfl_sync(K13_FULL, a, r);
    const int p = __shfl_sync(K13_FULL, b, r) - 31 + lane;
    const int e = __shfl_sync(K13_FULL, w[r], 31);
    const unsigned x = __ballot_sync(K13_FULL, p > ar && w[r] >= e);
    if (lane == r) {
      en = e;
      bal = x;
    }
  }
}

// Run v's count is c[off[v+1]] - c[off[v]]; where positive, its last
// masked pair is lower_bound(c, c[off[v+1]]) - 1.
__global__ void __launch_bounds__(K13_REG_THREADS)
k13_register_kernel(const int* __restrict__ c,
                    const int* __restrict__ offsets, int V,
                    const int* __restrict__ rhos, long long M,
                    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long v = (long long)blockIdx.x * K13_REG_THREADS + threadIdx.x;
  const bool live = v < V;
  const int a = live ? offsets[v] : 0;
  const int b = live ? offsets[v + 1] : 0;
  const int st = c[a];
  int en = 0;
  unsigned bal = 0;
  k13_window(c, a, b, lane, en, bal);
  if (!live) return;
  if (en <= st) {
    out[v] = 0;
    return;
  }
  const int k = __ffs(bal) - 1;   // lane 31 holds c[b]: bal != 0
  long long j = (long long)b - 31 + k;
  if (k == 0 && j > a + 1)
    j = k13_thread_search(c, a + 1, j, en);
  out[v] = rhos[k13_clip(j - 1, M)];
}

// mode 0: pick (vals f32[M], out f32[B, R]); mode 1: registers (vals =
// rhos i32[M], out i32[V]). V = len(offsets) - 1.
extern "C" int es_agg_rank_pick(const int* c, int n_c, const int* offsets,
                                int V, const void* vals, int M,
                                const int* ordinals, const int* lo,
                                const int* hi, const float* frac, int B,
                                int R, int mode, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    const long long n = (long long)B * R;
    if (n > 0)
      k13_pick_kernel<<<(unsigned)n, K13_PICK_THREADS, 0, st>>>(
          c, n_c, offsets, V, (const float*)vals, M, ordinals, lo, hi, frac,
          R, (float*)out);
  } else if (mode == 1) {
    if (V > 0)
      k13_register_kernel<<<(V + K13_REG_THREADS - 1) / K13_REG_THREADS,
                            K13_REG_THREADS, 0, st>>>(
          c, offsets, V, (const int*)vals, M, (int*)out);
  } else {
    return ES_ERR_ARG;
  }
  return (int)cudaGetLastError();
}
