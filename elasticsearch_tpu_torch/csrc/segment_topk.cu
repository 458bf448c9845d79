// K19: masked top-k over one segment's dense scores.
//
// Replaces elasticsearch_tpu/ops/topk.py:_topk_kernel (:23,
// get_topk_kernel): where(mask, scores, -inf), then the k largest of the n
// values (k <= n) as f32[k] values and i32[k] indices, equal values in
// ascending index order. The reference's lax.top_k (and its two-stage
// blockwise form at n >= 2^17) orders floats by their bits' total order:
// +NaN > +inf > ... > +0 > -0 > ... > -inf > -NaN, and the masked slots,
// all -inf, also take the lowest indices first.
//
// Each value maps to a 32-bit key that sorts ascending in that order (best
// first); a result is the key packed with its index, (key << 32 | index),
// so the k smallest packed keys are the answer, ties and all.
//
// k <= K19_FAST_K: one cooperative launch (k19_fast_kernel), a block of
// 1,024 threads an SM, grid barriers between its phases (an arrival
// counter and a generation word in the call's workspace, whose counters
// and histograms the entry zeroes with one memset before the launch).
//  1. Level 0: every block reads its contiguous chunk of the segment once,
//     a lane 16 docs a step (16 mask bytes and four float4 loads), and
//     histograms the keys' top 11 bits in shared memory (a shared atomic
//     a key), then adds its bins to a global histogram and keeps them as
//     its partial counts. The -inf keys (the masked docs) are counted
//     apart, so a request that matches fewer docs than k finds the k-th
//     key exactly here.
//  2. After a barrier every block scans the 2,048 bins itself (the same
//     answer everywhere): the bucket [lo, hi] that holds the k-th key, the
//     keys still wanted from it (need) and its size (cnt). A bucket whose
//     keys, with the ones below it, exceed K19_SORT_MAX survivors is
//     histogrammed again on the next bits (11, then the last 10: a third
//     and fourth read, only for crowded buckets), ending on one key.
//  3. Collect (the second read): keys below lo are appended to the
//     survivors through one atomic a warp step; a bucket's keys too,
//     unless the bucket is one key T, whose `need` lowest indices are
//     kept by their stable rank (the blocks' partial counts before it,
//     then a block scan a step in index order, until `need` are ranked).
//  4. Sort: with one chunk (at most 2,048 survivors) block 0 sorts them
//     (bitonic sort of the next power of two, or cub's block merge sort of
//     a full chunk) and writes the result; else a block merge-sorts each
//     chunk of 2,048 and, after a barrier, each chunk's block loads every
//     chunk and places its keys by their ranks in the others (binary
//     searches).
// k > K19_FAST_K (up to n): the radix select in four 8-bit passes and a
// stable compaction of separate launches, and a bitonic sort in device
// memory (chunks of 8,192 in shared memory, the longer strides one pass
// each).
//
// The output reads each value back from its key (the exact bits, NaN
// payloads included).
//
// Bound: bytes (5 bytes a doc read once, 8 bytes a result written). The
// one-launch path reads the segment twice when the bucket of the k-th key
// is small (the common case); at (e) on an H100 its first read runs near
// the card's memory rate, and the barriers and the sort are a third of
// the call.

#include <cub/block/block_merge_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "sort_common.cuh"

// the deep-page path (k > K19_FAST_K)

#define K19_THREADS 256
#define K19_TILE 4096
#define K19_HIST_BLOCKS 1024
#define K19_SCAN_THREADS 1024
#define K19_SORT_THREADS 1024
#define K19_CHUNK 8192
// the one-launch path
#define K19_FAST_K 16384     // the largest k it serves
#define K19_FT 1024          // threads of its block
#define K19_VEC 16           // docs a lane a step
#define K19_BINS 2048        // bins of a level's histogram
#define K19_SCHUNK 2048      // survivors a block sorts
#define K19_SORT_MAX 16384   // survivors it sorts at most
#define K19_NEG_INF_KEY 0xFF800000u  // the key of -inf (masked docs)

typedef unsigned long long u64;

struct K19State {
  unsigned prefix;  // the k-th key's digits found so far
  int need;         // how many keys equal to the prefix are still wanted
  int pad[2];
};

// Ascending = better: the bits' total order, reversed.
__device__ __forceinline__ unsigned k19_key(const float* __restrict__ s,
                                            const unsigned char* __restrict__ m,
                                            long long i) {
  const unsigned u = m[i] ? __float_as_uint(s[i]) : 0xFF800000u;
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~ord;
}

__global__ void k19_init_kernel(K19State* st, unsigned* hist, int k) {
  if (threadIdx.x == 0) {
    st->prefix = 0u;
    st->need = k;
  }
  hist[threadIdx.x] = 0u;
}

__global__ void __launch_bounds__(K19_THREADS)
k19_hist_kernel(const float* __restrict__ s, const unsigned char* __restrict__ m,
                long long n, const K19State* __restrict__ st, int pass,
                unsigned* hist) {
  __shared__ unsigned sh[256];
  sh[threadIdx.x] = 0u;
  __syncthreads();
  const int shift = 24 - 8 * pass;
  const unsigned prefix = st->prefix;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * K19_THREADS;
  for (long long base = (long long)blockIdx.x * K19_THREADS; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int dig = -1;
    if (i < n) {
      const unsigned d = k19_key(s, m, i);
      if (pass == 0 || (d >> (shift + 8)) == (prefix >> (shift + 8)))
        dig = (int)((d >> shift) & 255u);
    }
    const unsigned grp = __match_any_sync(0xffffffffu, dig);
    if (dig >= 0 && lane == __ffs(grp) - 1) atomicAdd(&sh[dig], __popc(grp));
  }
  __syncthreads();
  if (sh[threadIdx.x] != 0u) atomicAdd(&hist[threadIdx.x], sh[threadIdx.x]);
}

// One block of 256 threads: pick the digit holding the need-th key, then
// clear the histogram for the next pass.
__global__ void k19_select_kernel(K19State* st, unsigned* hist, int pass) {
  if (threadIdx.x == 0) {
    const int shift = 24 - 8 * pass;
    long long cum = 0;
    const long long need = st->need;
    int dig = 255;
    for (int d = 0; d < 256; ++d) {
      const long long h = hist[d];
      if (cum + h >= need) {
        dig = d;
        break;
      }
      cum += h;
    }
    st->prefix |= (unsigned)dig << shift;
    st->need = (int)(need - cum);
  }
  __syncthreads();
  hist[threadIdx.x] = 0u;
}

struct K19Pair {
  int lt, eq;
};

struct K19PairSum {
  __device__ __forceinline__ K19Pair operator()(const K19Pair& a,
                                                const K19Pair& b) const {
    return K19Pair{a.lt + b.lt, a.eq + b.eq};
  }
};

// Per tile: how many keys lie below T and how many equal it.
__global__ void __launch_bounds__(K19_THREADS)
k19_count_kernel(const float* __restrict__ s, const unsigned char* __restrict__ m,
                 long long n, const K19State* __restrict__ st,
                 K19Pair* __restrict__ tiles) {
  typedef cub::BlockReduce<K19Pair, K19_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const unsigned T = st->prefix;
  const long long lo = (long long)blockIdx.x * K19_TILE;
  const long long hi = min(lo + K19_TILE, n);
  K19Pair c{0, 0};
  for (long long i = lo + threadIdx.x; i < hi; i += K19_THREADS) {
    const unsigned d = k19_key(s, m, i);
    c.lt += d < T;
    c.eq += d == T;
  }
  const K19Pair r = Reduce(tmp).Reduce(c, K19PairSum());
  if (threadIdx.x == 0) tiles[blockIdx.x] = r;
}

// One block: the tiles' counts become exclusive offsets, in place.
__global__ void __launch_bounds__(K19_SCAN_THREADS)
k19_scan_kernel(K19Pair* tiles, int nt) {
  typedef cub::BlockScan<K19Pair, K19_SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const int per = (nt + K19_SCAN_THREADS - 1) / K19_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nt);
  K19Pair sum{0, 0};
  for (int t = lo; t < hi; ++t) {
    sum.lt += tiles[t].lt;
    sum.eq += tiles[t].eq;
  }
  K19Pair run;
  Scan(tmp).ExclusiveScan(sum, run, K19Pair{0, 0}, K19PairSum());
  for (int t = lo; t < hi; ++t) {
    const K19Pair c = tiles[t];
    tiles[t] = run;
    run.lt += c.lt;
    run.eq += c.eq;
  }
}

__device__ __forceinline__ u64 k19_pack(unsigned d, long long i) {
  return ((u64)d << 32) | (u64)(unsigned)i;
}

// Each tile writes its keys below T at their stable rank, and its keys
// equal to T whose rank among all such keys is below `need` after them.
__global__ void __launch_bounds__(K19_THREADS)
k19_write_kernel(const float* __restrict__ s, const unsigned char* __restrict__ m,
                 long long n, int k, const K19State* __restrict__ st,
                 const K19Pair* __restrict__ tiles, u64* __restrict__ cand) {
  typedef cub::BlockScan<K19Pair, K19_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const unsigned T = st->prefix;
  const int need = st->need;
  const int less = k - need;
  K19Pair base = tiles[blockIdx.x];
  const long long lo = (long long)blockIdx.x * K19_TILE;
  const long long hi = min(lo + K19_TILE, n);
  for (long long r0 = lo; r0 < hi; r0 += K19_THREADS) {
    const long long i = r0 + threadIdx.x;
    unsigned d = 0u;
    K19Pair f{0, 0};
    if (i < hi) {
      d = k19_key(s, m, i);
      f.lt = d < T;
      f.eq = d == T;
    }
    K19Pair rank, agg;
    Scan(tmp).ExclusiveScan(f, rank, K19Pair{0, 0}, K19PairSum(), agg);
    if (f.lt) cand[base.lt + rank.lt] = k19_pack(d, i);
    if (f.eq && base.eq + rank.eq < need)
      cand[less + base.eq + rank.eq] = k19_pack(d, i);
    base.lt += agg.lt;
    base.eq += agg.eq;
    __syncthreads();
  }
}

__global__ void k19_pad_kernel(u64* cand, int k, int m2) {
  const int j = k + blockIdx.x * blockDim.x + threadIdx.x;
  if (j < m2) cand[j] = ~0ULL;
}

__device__ __forceinline__ void k19_cswap(u64* a, long long i, long long j,
                                          bool up) {
  const u64 x = a[i], y = a[j];
  if (up ? (y < x) : (x < y)) {
    a[i] = y;
    a[j] = x;
  }
}

// Bitonic steps of sizes [size_lo, size_hi] on chunks of `chunk` keys held
// in shared memory; a step's direction follows the key's global index.
// Strides start at min(size / 2, chunk / 2).
__global__ void __launch_bounds__(K19_SORT_THREADS)
k19_sort_chunk_kernel(u64* cand, int chunk, int size_lo, int size_hi) {
  extern __shared__ u64 sk[];
  const long long base = (long long)blockIdx.x * chunk;
  for (int t = threadIdx.x; t < chunk; t += K19_SORT_THREADS)
    sk[t] = cand[base + t];
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, chunk) >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (chunk >> 1); t += K19_SORT_THREADS) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        k19_cswap(sk, i, i + stride, ((base + i) & size) == 0);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < chunk; t += K19_SORT_THREADS)
    cand[base + t] = sk[t];
}

// One bitonic step of a stride too long for a chunk, in device memory.
__global__ void __launch_bounds__(K19_THREADS)
k19_sort_step_kernel(u64* cand, int m2, int size, int stride) {
  const long long t = (long long)blockIdx.x * K19_THREADS + threadIdx.x;
  if (t >= (m2 >> 1)) return;
  const long long i = ((t & ~(long long)(stride - 1)) << 1) |
                      (t & (long long)(stride - 1));
  k19_cswap(cand, i, i + stride, (i & size) == 0);
}

__global__ void k19_out_kernel(const u64* __restrict__ cand, int k,
                               float* __restrict__ vals,
                               int* __restrict__ idx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const u64 v = cand[j];
  const unsigned ord = ~(unsigned)(v >> 32);
  const unsigned u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  vals[j] = __uint_as_float(u);
  idx[j] = (int)(unsigned)(v & 0xFFFFFFFFull);
}

// ---------------------------------------------------------------------------
// The one-launch path (k <= K19_FAST_K)
// ---------------------------------------------------------------------------

// Head of the one-launch path's workspace, zeroed by the entry with the
// histograms after it.
struct K19Ctl {
  unsigned count;  // grid-barrier arrivals since the last barrier
  unsigned gen;    // grid-barrier generation
  unsigned napp;   // survivors appended
  unsigned ninf;   // -inf keys (level 0)
  unsigned pad[4];
};

// A level's bucket, the same in every block: the k-th key lies in
// [lo, hi], which holds cnt keys, `need` of them still wanted; bin: its
// bin in the level's partial counts, -1 for the -inf keys.
struct K19Sel {
  unsigned lo, hi;
  int need, cnt, bin;
};

// The one-launch path's workspace sections for a grid of up to G blocks:
// [0, part) is zeroed before each launch.
struct K19FastLayout {
  size_t hist, part, pinf, surv, sorted, total;
};

static K19FastLayout k19_fast_layout(int G) {
  K19FastLayout l;
  l.hist = sizeof(K19Ctl);                           // 3 levels x BINS
  l.part = l.hist + (size_t)3 * K19_BINS * 4;        // [G][BINS]
  l.pinf = l.part + (size_t)G * K19_BINS * 4;        // [G]
  l.surv = (l.pinf + (size_t)G * 4 + 15) & ~(size_t)15;  // [SORT_MAX]
  l.sorted = l.surv + (size_t)K19_SORT_MAX * 8;      // [SORT_MAX]
  l.total = l.sorted + (size_t)K19_SORT_MAX * 8;
  return l;
}

__device__ __forceinline__ unsigned k19_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid waits here for the others; its writes before
// are visible to every block after. The last block to arrive resets the
// count and moves the generation on, so the count is zero between
// barriers and when the kernel ends.
__device__ void k19_grid_sync(K19Ctl* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = k19_ld_acquire(&ctl->gen);
    __threadfence();
    if (atomicAdd(&ctl->count, 1u) == gridDim.x - 1) {
      atomicExch(&ctl->count, 0u);
      __threadfence();
      atomicAdd(&ctl->gen, 1u);
    } else {
      while (k19_ld_acquire(&ctl->gen) == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned k19_key_of(unsigned u, unsigned m) {
  const unsigned v = m ? u : 0xFF800000u;
  const unsigned ord = (v & 0x80000000u) ? ~v : (v | 0x80000000u);
  return ~ord;
}

// The keys of docs [i0, i0 + 16) below `end`: one 16-byte load of mask
// bytes and four float4 loads where the whole group is in range and the
// columns are 16-byte aligned, else one doc at a time. Returns how many
// of the 16 are docs.
__device__ __forceinline__ int k19_load16(const float* __restrict__ s,
                                          const unsigned char* __restrict__ m,
                                          long long i0, long long end,
                                          bool vec, unsigned key[K19_VEC]) {
  if (vec && i0 + K19_VEC <= end) {
    const uint4 mv = __ldg(reinterpret_cast<const uint4*>(m + i0));
    const float4* s4 = reinterpret_cast<const float4*>(s + i0);
    const unsigned mw[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = __ldg(s4 + j);
      key[4 * j + 0] = k19_key_of(__float_as_uint(f.x), mw[j] & 0xFFu);
      key[4 * j + 1] = k19_key_of(__float_as_uint(f.y), (mw[j] >> 8) & 0xFFu);
      key[4 * j + 2] = k19_key_of(__float_as_uint(f.z), (mw[j] >> 16) & 0xFFu);
      key[4 * j + 3] = k19_key_of(__float_as_uint(f.w), mw[j] >> 24);
    }
    return K19_VEC;
  }
#pragma unroll
  for (int e = 0; e < K19_VEC; ++e)
    key[e] = i0 + e < end ? k19_key_of(__float_as_uint(s[i0 + e]), m[i0 + e])
                          : 0u;
  const long long nv = end - i0;
  return nv <= 0 ? 0 : (nv >= K19_VEC ? K19_VEC : (int)nv);
}

__device__ __forceinline__ void k19_write_out(u64 v, long long r,
                                              float* __restrict__ vals,
                                              int* __restrict__ idx) {
  const unsigned ord = ~(unsigned)(v >> 32);
  const unsigned u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  vals[r] = __uint_as_float(u);
  idx[r] = (int)(unsigned)(v & 0xFFFFFFFFull);
}

// Keys of a sorted chunk below x.
__device__ __forceinline__ int k19_rank_in(const u64* a, u64 x) {
  int lo = 0, hi = K19_SCHUNK;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(K19_FT, 1)
k19_fast_kernel(const float* __restrict__ s, const unsigned char* __restrict__ m,
                long long n, int k, long long chunk, int vec, K19Ctl* ctl,
                unsigned* hist, unsigned* part, unsigned* pinf, u64* surv,
                u64* sorted, float* __restrict__ out_vals,
                int* __restrict__ out_idx) {
  typedef cub::BlockScan<unsigned, K19_FT> ScanU;
  typedef cub::BlockScan<K19Pair, K19_FT> ScanP;
  extern __shared__ u64 k19_dyn[];  // K19_SORT_MAX keys
  __shared__ unsigned sh[K19_BINS];
  typedef cub::BlockMergeSort<u64, K19_FT, K19_SCHUNK / K19_FT> Sort;
  __shared__ union {
    typename ScanU::TempStorage u;
    typename ScanP::TempStorage p;
    typename Sort::TempStorage sort;
  } scan_s;
  __shared__ K19Sel sel_s;
  __shared__ unsigned red_s, app_s;
  __shared__ long long rank_s;

  const int tid = threadIdx.x, lane = tid & 31, blk = blockIdx.x;
  const long long lo_i = min((long long)blk * chunk, n);
  const long long hi_i = min(lo_i + chunk, n);
  const long long step = (long long)K19_FT * K19_VEC;
  unsigned key[K19_VEC];

  // ---- levels: histogram the bucket's next digit, find the k-th key's --
  K19Sel cur;
  cur.lo = 0u;
  cur.hi = 0xFFFFFFFFu;
  cur.need = k;
  cur.cnt = 0;
  cur.bin = 0;
  int level = 0;
  for (;;) {
    const int shift = level == 0 ? 21 : (level == 1 ? 10 : 0);
    const int bits = level == 2 ? 10 : 11;
    const unsigned dmask = (1u << bits) - 1u;
    unsigned* H = hist + level * K19_BINS;
    for (int b = tid; b < K19_BINS; b += K19_FT) sh[b] = 0u;
    if (tid == 0) red_s = 0u;
    __syncthreads();
    unsigned ninf = 0u;
    for (long long base = lo_i; base < hi_i; base += step) {
      const long long i0 = base + (long long)tid * K19_VEC;
      const int nv = k19_load16(s, m, i0, hi_i, vec, key);
#pragma unroll
      for (int e = 0; e < K19_VEC; ++e) {
        int dig = -1;
        if (e < nv) {
          const unsigned kk = key[e];
          if (level == 0 && kk == K19_NEG_INF_KEY)
            ++ninf;
          else if (kk >= cur.lo && kk <= cur.hi)
            dig = (int)((kk >> shift) & dmask);
        }
        // a shared atomic a key (grouping a warp's equal digits first
        // with __match_any_sync was slower on an H100)
        if (dig >= 0) atomicAdd(&sh[dig], 1u);
      }
    }
    if (level == 0) {
      ninf = __reduce_add_sync(0xffffffffu, ninf);
      if (lane == 0 && ninf) atomicAdd(&red_s, ninf);
    }
    __syncthreads();
    unsigned* mine = part + (size_t)blk * K19_BINS;
    for (int b = tid; b < K19_BINS; b += K19_FT) {
      const unsigned v = sh[b];
      mine[b] = v;
      if (v) atomicAdd(&H[b], v);
    }
    if (level == 0 && tid == 0) {
      pinf[blk] = red_s;
      if (red_s) atomicAdd(&ctl->ninf, red_s);
    }
    k19_grid_sync(ctl);

    // every block: the bin holding the need-th key (the -inf keys come
    // first in theirs, 0xFF800000 being its smallest key)
    const unsigned tinf = level == 0 ? __ldcg(&ctl->ninf) : 0u;
    const int inf_bin = (int)(K19_NEG_INF_KEY >> 21);
    constexpr int per = K19_BINS / K19_FT;
    unsigned hb[per], xb[per], sum = 0u;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const int b = per * tid + j;
      hb[j] = __ldcg(H + b);
      xb[j] = hb[j] + (b == inf_bin ? tinf : 0u);
      sum += xb[j];
    }
    unsigned bef;
    ScanU(scan_s.u).ExclusiveSum(sum, bef);
    const unsigned need = (unsigned)cur.need;
    const unsigned base_key =
        level == 0 ? 0u : (cur.lo & ~((1u << (shift + bits)) - 1u));
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const int b = per * tid + j;
      const unsigned c = xb[j], h = hb[j];
      if (j) bef += xb[j - 1];
      if (bef < need && need <= bef + c) {
        K19Sel r;
        const unsigned blo = base_key + ((unsigned)b << shift);
        const unsigned bhi = blo + ((1u << shift) - 1u);
        r.lo = max(blo, cur.lo);
        r.hi = min(bhi, cur.hi);
        r.need = (int)(need - bef);
        r.cnt = (int)h;
        r.bin = b;
        if (level == 0 && b == inf_bin && tinf) {
          if (need <= bef + tinf) {
            r.lo = r.hi = K19_NEG_INF_KEY;
            r.cnt = (int)tinf;
            r.bin = -1;
          } else {
            r.lo = K19_NEG_INF_KEY + 1u;
            r.need = (int)(need - bef - tinf);
          }
        }
        sel_s = r;
      }
    }
    __syncthreads();
    cur = sel_s;
    if (cur.lo == cur.hi ||
        (long long)(k - cur.need) + cur.cnt <= K19_SORT_MAX)
      break;
    ++level;  // a crowded bucket of several keys: its next digit
  }
  const bool exact = cur.lo == cur.hi;
  const int less = k - cur.need;

  // ---- collect: keys below the bucket (and a crowded one's keys) -------
  long long rank = 0;  // exact: the bucket's keys in blocks before this
  if (exact) {
    if (tid == 0) rank_s = 0;
    __syncthreads();
    long long acc = 0;
    for (int i = tid; i < blk; i += K19_FT)
      acc += cur.bin < 0 ? __ldcg(pinf + i)
                         : __ldcg(part + (size_t)i * K19_BINS + cur.bin);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0 && acc) atomicAdd((unsigned long long*)&rank_s,
                                    (unsigned long long)acc);
    __syncthreads();
    rank = rank_s;
  }
  for (long long base = lo_i; base < hi_i; base += step) {
    const long long i0 = base + (long long)tid * K19_VEC;
    const int nv = k19_load16(s, m, i0, hi_i, vec, key);
    unsigned fa = 0u, fe = 0u;
#pragma unroll
    for (int e = 0; e < K19_VEC; ++e) {
      if (e < nv) {
        const unsigned kk = key[e];
        if (exact) {
          if (kk < cur.lo) fa |= 1u << e;
          else if (kk == cur.lo) fe |= 1u << e;
        } else if (kk <= cur.hi) {
          fa |= 1u << e;
        }
      }
    }
    if (!exact || rank >= cur.need) {
      // no stable rank wanted: a warp's appended keys take their slots
      // with one atomic, no block barrier
      const int cnt = __popc(fa);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      unsigned at = 0u;
      if (lane == 31 && incl) at = atomicAdd(&ctl->napp, (unsigned)incl);
      at = __shfl_sync(0xffffffffu, at, 31) + (unsigned)(incl - cnt);
#pragma unroll
      for (int e = 0; e < K19_VEC; ++e)
        if ((fa >> e) & 1u) surv[at++] = k19_pack(key[e], i0 + e);
      continue;
    }
    // the bucket's keys in index order: a block scan a step
    K19Pair c{__popc(fa), __popc(fe)}, off, tot;
    ScanP(scan_s.p).ExclusiveScan(c, off, K19Pair{0, 0}, K19PairSum(), tot);
    if (tid == 0 && tot.lt) app_s = atomicAdd(&ctl->napp, (unsigned)tot.lt);
    __syncthreads();
    unsigned at = app_s + (unsigned)off.lt;
    long long r = rank + off.eq;
#pragma unroll
    for (int e = 0; e < K19_VEC; ++e) {
      if ((fa >> e) & 1u) surv[at++] = k19_pack(key[e], i0 + e);
      if ((fe >> e) & 1u) {
        if (r < cur.need) surv[less + r] = k19_pack(key[e], i0 + e);
        ++r;
      }
    }
    rank += tot.eq;
    __syncthreads();
  }
  k19_grid_sync(ctl);

  // ---- sort the M survivors; the first k are the result ---------------
  const int M = exact ? k : less + cur.cnt;
  const int C = (M + K19_SCHUNK - 1) / K19_SCHUNK;
  // one chunk: only the next power of two of M keys
  int n2 = K19_SCHUNK;
  if (C == 1) {
    n2 = 2;
    while (n2 < M) n2 <<= 1;
  }
  for (int c = blk; c < C; c += gridDim.x) {
    if (n2 < K19_SCHUNK) {
      for (int t = tid; t < n2; t += K19_FT)
        k19_dyn[t] = t < M ? __ldcg(surv + t) : ~0ULL;
      block_bitonic_sort(k19_dyn, n2);
    } else {
      // a full chunk: merge sort, the keys a thread holds consecutive
      constexpr int kItems = K19_SCHUNK / K19_FT;
      u64 v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int j = c * K19_SCHUNK + tid * kItems + i;
        v[i] = j < M ? __ldcg(surv + j) : ~0ULL;
      }
      __syncthreads();  // the union's last user is done
      Sort(scan_s.sort).Sort(v, U64Less());
#pragma unroll
      for (int i = 0; i < kItems; ++i) k19_dyn[tid * kItems + i] = v[i];
      __syncthreads();
    }
    for (int t = tid; t < n2; t += K19_FT) {
      if (C == 1) {
        if (t < k) k19_write_out(k19_dyn[t], t, out_vals, out_idx);
      } else {
        sorted[c * K19_SCHUNK + t] = k19_dyn[t];
      }
    }
    __syncthreads();
  }
  if (C > 1) {
    k19_grid_sync(ctl);
    if (blk < C) {
      for (int t = tid; t < C * K19_SCHUNK; t += K19_FT)
        k19_dyn[t] = __ldcg(sorted + t);
      __syncthreads();
      for (int c = blk; c < C; c += gridDim.x) {
        for (int t = tid; t < K19_SCHUNK; t += K19_FT) {
          const u64 x = k19_dyn[c * K19_SCHUNK + t];
          if (x == ~0ULL) continue;
          long long r = t;
          for (int o = 0; o < C; ++o)
            if (o != c) r += k19_rank_in(k19_dyn + o * K19_SCHUNK, x);
          if (r < k) k19_write_out(x, r, out_vals, out_idx);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Entries
// ---------------------------------------------------------------------------

struct K19Layout {
  size_t tiles, cand, total;
  int nt, m2;
};

static K19Layout k19_layout(long long n, int k) {
  K19Layout l;
  l.nt = (int)((n + K19_TILE - 1) / K19_TILE);
  l.m2 = es_pow2_at_least(k > 0 ? k : 1);
  l.tiles = sizeof(K19State) + 256 * sizeof(unsigned);
  l.cand = l.tiles + (((size_t)l.nt * sizeof(K19Pair) + 7) & ~(size_t)7);
  l.total = l.cand + (size_t)l.m2 * sizeof(u64);
  return l;
}

// Bytes of the per-call workspace.
extern "C" long long es_segment_topk_workspace_bytes(long long n, int k) {
  return k <= K19_FAST_K ? (long long)k19_fast_layout(es_sm_count()).total
                         : (long long)k19_layout(n, k).total;
}

// scores f32[n], mask u8[n] (0/1), k in [0, n]: out_vals f32[k], out_idx
// i32[k]. workspace: es_segment_topk_workspace_bytes(n, k) bytes, 16-byte
// aligned.
extern "C" int es_segment_topk(const float* scores, const unsigned char* mask,
                               long long n, int k, float* out_vals,
                               int* out_idx, void* workspace, void* stream) {
  if (k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (k <= K19_FAST_K) {
    const size_t shm = (size_t)K19_SORT_MAX * sizeof(u64);
    int e = es_set_shared(k19_fast_kernel, shm);
    if (e != 0) return e;
    static int per_sm = -1;
    if (per_sm < 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k19_fast_kernel,
                                                    K19_FT, shm);
    if (per_sm < 1) return ES_ERR_SHARED;
    const int sms = es_sm_count();
    const long long want = (n + (long long)K19_FT * K19_VEC - 1) /
                           ((long long)K19_FT * K19_VEC);
    int G = (int)(want < sms ? want : sms);
    if (G < 1) G = 1;
    const long long groups = (n + K19_VEC - 1) / K19_VEC;
    long long chunk = (groups + G - 1) / G * K19_VEC;
    int vec = ((((uintptr_t)scores) | ((uintptr_t)mask)) & 15) == 0;
    const K19FastLayout l = k19_fast_layout(sms);
    unsigned char* sb = (unsigned char*)workspace;
    // the barrier's counters and the histograms start at zero
    e = (int)cudaMemsetAsync(sb, 0, l.part, st);
    if (e != 0) return e;
    K19Ctl* ctl = (K19Ctl*)sb;
    unsigned* hist = (unsigned*)(sb + l.hist);
    unsigned* part = (unsigned*)(sb + l.part);
    unsigned* pinf = (unsigned*)(sb + l.pinf);
    u64* surv = (u64*)(sb + l.surv);
    u64* sorted = (u64*)(sb + l.sorted);
    void* args[] = {(void*)&scores, (void*)&mask, (void*)&n,
                    (void*)&k,      (void*)&chunk, (void*)&vec,
                    (void*)&ctl,    (void*)&hist,  (void*)&part,
                    (void*)&pinf,   (void*)&surv,  (void*)&sorted,
                    (void*)&out_vals, (void*)&out_idx};
    const cudaError_t ce = cudaLaunchCooperativeKernel(
        (const void*)k19_fast_kernel, dim3(G), dim3(K19_FT), args, shm, st);
    if (ce != cudaSuccess) return (int)ce;
    return (int)cudaGetLastError();
  }

  const K19Layout l = k19_layout(n, k);
  unsigned char* ws = (unsigned char*)workspace;
  K19State* sel = (K19State*)ws;
  unsigned* hist = (unsigned*)(ws + sizeof(K19State));
  K19Pair* tiles = (K19Pair*)(ws + l.tiles);
  u64* cand = (u64*)(ws + l.cand);

  k19_init_kernel<<<1, 256, 0, st>>>(sel, hist, k);
  const long long want = (n + K19_THREADS - 1) / K19_THREADS;
  const int hb = (int)max(1LL, min(want, (long long)K19_HIST_BLOCKS));
  for (int pass = 0; pass < 4; ++pass) {
    k19_hist_kernel<<<hb, K19_THREADS, 0, st>>>(scores, mask, n, sel, pass,
                                                hist);
    k19_select_kernel<<<1, 256, 0, st>>>(sel, hist, pass);
  }
  k19_count_kernel<<<l.nt, K19_THREADS, 0, st>>>(scores, mask, n, sel,
                                                 tiles);
  k19_scan_kernel<<<1, K19_SCAN_THREADS, 0, st>>>(tiles, l.nt);
  k19_write_kernel<<<l.nt, K19_THREADS, 0, st>>>(scores, mask, n, k, sel,
                                                 tiles, cand);
  if (l.m2 > k)
    k19_pad_kernel<<<(l.m2 - k + 255) / 256, 256, 0, st>>>(cand, k, l.m2);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;

  // m2 > K19_FAST_K: chunks in shared memory, the longer strides in
  // device memory
  const int chunk = K19_CHUNK;
  const size_t shm = (size_t)chunk * sizeof(u64);
  e = es_set_shared(k19_sort_chunk_kernel, shm);
  if (e != 0) return e;
  const int nch = l.m2 / chunk;
  k19_sort_chunk_kernel<<<nch, K19_SORT_THREADS, shm, st>>>(cand, chunk, 2,
                                                            chunk);
  const int sb = (int)(((long long)(l.m2 >> 1) + K19_THREADS - 1) /
                       K19_THREADS);
  for (int size = chunk << 1; size <= l.m2; size <<= 1) {
    for (int stride = size >> 1; stride >= chunk; stride >>= 1)
      k19_sort_step_kernel<<<sb, K19_THREADS, 0, st>>>(cand, l.m2, size,
                                                      stride);
    k19_sort_chunk_kernel<<<nch, K19_SORT_THREADS, shm, st>>>(cand, chunk,
                                                              size, size);
  }
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  k19_out_kernel<<<(k + 255) / 256, 256, 0, st>>>(cand, k, out_vals, out_idx);
  return (int)cudaGetLastError();
}
