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
// Design. Each value maps to a 32-bit key that sorts ascending in that
// order (best first). A radix select finds the k-th key T in four 8-bit
// passes: each pass histograms the keys that share the prefix found so far
// (a shared 256-bin histogram a block, lanes of equal digit grouped by
// __match_any_sync and added by one lane, then global atomics: integers,
// exact in any order), and one thread picks the digit. A stable compaction
// then keeps every key below T and the first `need` keys equal to T in
// index order (tile counts, one block's scan of them, then each tile ranks
// its keys with cub's BlockScan a round of 256). The k survivors, packed
// as (key << 32 | index), are sorted ascending by a bitonic sort: in one
// block's shared memory when they fit (k <= 16,384 on an H100), else in
// device memory (chunks of 8,192 sorted and merged in shared memory, the
// longer strides one pass each). The output reads each value back from its
// key (the exact bits, NaN payloads included).
//
// Cost: seven passes over the n scores and mask bytes (four histograms, the
// counts, the ranks, and nothing else of size n), so at a fixed k the time
// grows with n, not with k * n; the sort is O(k log^2 k).
//
// Bound: bytes (5 bytes a doc read once, 8 bytes a result written).

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "sort_common.cuh"

#define K19_THREADS 256
#define K19_TILE 4096
#define K19_HIST_BLOCKS 1024
#define K19_SCAN_THREADS 1024
#define K19_SORT_THREADS 1024
#define K19_CHUNK 8192

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

extern "C" long long es_segment_topk_workspace_bytes(long long n, int k) {
  return (long long)k19_layout(n, k).total;
}

extern "C" int es_segment_topk(const float* scores, const unsigned char* mask,
                               long long n, int k, float* out_vals,
                               int* out_idx, void* workspace, void* stream) {
  if (k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const K19Layout l = k19_layout(n, k);
  unsigned char* ws = (unsigned char*)workspace;
  K19State* state = (K19State*)ws;
  unsigned* hist = (unsigned*)(ws + sizeof(K19State));
  K19Pair* tiles = (K19Pair*)(ws + l.tiles);
  u64* cand = (u64*)(ws + l.cand);

  k19_init_kernel<<<1, 256, 0, st>>>(state, hist, k);
  const long long want = (n + K19_THREADS - 1) / K19_THREADS;
  const int hb = (int)max(1LL, min(want, (long long)K19_HIST_BLOCKS));
  for (int pass = 0; pass < 4; ++pass) {
    k19_hist_kernel<<<hb, K19_THREADS, 0, st>>>(scores, mask, n, state, pass,
                                                hist);
    k19_select_kernel<<<1, 256, 0, st>>>(state, hist, pass);
  }
  k19_count_kernel<<<l.nt, K19_THREADS, 0, st>>>(scores, mask, n, state,
                                                 tiles);
  k19_scan_kernel<<<1, K19_SCAN_THREADS, 0, st>>>(tiles, l.nt);
  k19_write_kernel<<<l.nt, K19_THREADS, 0, st>>>(scores, mask, n, k, state,
                                                 tiles, cand);
  if (l.m2 > k)
    k19_pad_kernel<<<(l.m2 - k + 255) / 256, 256, 0, st>>>(cand, k, l.m2);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;

  if (l.m2 > 1) {
    const size_t whole = (size_t)l.m2 * sizeof(u64);
    if (whole + es_static_shared_bytes(k19_sort_chunk_kernel) <=
        (size_t)es_max_shared_bytes()) {
      e = es_set_shared(k19_sort_chunk_kernel, whole);
      if (e != 0) return e;
      k19_sort_chunk_kernel<<<1, K19_SORT_THREADS, whole, st>>>(
          cand, l.m2, 2, l.m2);
    } else {
      const int chunk = K19_CHUNK;
      const size_t shm = (size_t)chunk * sizeof(u64);
      e = es_set_shared(k19_sort_chunk_kernel, shm);
      if (e != 0) return e;
      const int nch = l.m2 / chunk;
      k19_sort_chunk_kernel<<<nch, K19_SORT_THREADS, shm, st>>>(cand, chunk,
                                                                2, chunk);
      const int sb = (int)(((long long)(l.m2 >> 1) + K19_THREADS - 1) /
                           K19_THREADS);
      for (int size = chunk << 1; size <= l.m2; size <<= 1) {
        for (int stride = size >> 1; stride >= chunk; stride >>= 1)
          k19_sort_step_kernel<<<sb, K19_THREADS, 0, st>>>(cand, l.m2, size,
                                                          stride);
        k19_sort_chunk_kernel<<<nch, K19_SORT_THREADS, shm, st>>>(
            cand, chunk, size, size);
      }
    }
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  k19_out_kernel<<<(k + 255) / 256, 256, 0, st>>>(cand, k, out_vals, out_idx);
  return (int)cudaGetLastError();
}
