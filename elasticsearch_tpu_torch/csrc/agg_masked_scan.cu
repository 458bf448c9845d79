// K12: the masked scan over an ordinal-CSR pair layout.
//
// Replaces elasticsearch_tpu/ops/aggs.py:masked_ordinal_counts (:46),
// masked_ordinal_sums (:63) and masked_rank_prefix (:113): gather the
// query's doc mask at each pair's doc (jnp.take with fill: a doc in
// [-n_pad, 0) wraps, any other doc outside [0, n_pad) gathers false), take
// the masked-count prefix c (c[i] = masked pairs before pair i), and the
// per-run counts c[off[v+1]] - c[off[v]]; or the per-run masked value
// sums.
//
// Bound: bytes. The pairs (4 bytes a doc, 4 more with values, 4 written a
// prefix entry) stream once and the byte mask is read once; but the pairs,
// sorted by (ordinal, value), reach their docs in no order, and a byte
// gathered from a mask far larger than the L2 costs the card a 32-byte
// sector of device memory. So pass 0 packs the byte mask into bits, one a
// doc (33.5 MB at n_pad 2^28, which the 50 MB L2 holds), reading the bytes
// once, coalesced; every later gather reads a bit of it. The bits are
// written and read under an evict-last L2 policy and the pair docs and
// values with streaming (evict-first) loads, so that the bits stay in L2
// while the pairs pass through it (c is stored plainly: a streaming store
// of it cost the prefix mode more than the hints saved). After the last
// gather a pass discards the bits' L2 lines (dead by then, so never
// written back), and no evict-last line outlives the call.
//
// The counts and prefix modes gather each pair's bit once: pass 1 packs the
// gathered bits of 32 pairs into one word with a warp ballot (1/8 byte a
// pair) and sums each tile's bits; pass 2 scans the tile sums in one
// block; pass 3 scans the words' popcounts within each tile (cub
// BlockScan) into a per-word prefix and, in the prefix mode, writes c
// with coalesced stores (a warp writes 32 neighbouring entries of a word
// at a time); pass 4 reads each run's two boundaries from the words and
// their prefix. Integers: exact in any order.
//
// The sums mode cuts each run into chunks of K12_CHUNK pairs: a block a
// chunk sums its masked values in f64 (a fixed per-thread stride, then
// cub's fixed block tree), and a warp a run adds its chunks' partials in
// a fixed order and rounds to f32 once, so the result is the same bits on
// every run and within 2^-22 of the f32 values' absolute sum of the exact
// sum.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "agg_common.cuh"
#include "topk_common.cuh"

#define K12_THREADS 256
#define K12_TILE_WORDS K12_THREADS          // one word a thread in pass 3
#define K12_TILE (K12_TILE_WORDS * 32)      // 8,192 pairs a tile
#define K12_SCAN_THREADS 1024
#define K12_CHUNK 65536                     // pairs a chunk (sums mode)

// Bit i of the result: byte i of x is not 0.
__device__ __forceinline__ unsigned k12_bits4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Pass 0: the byte mask packed 32 docs a word (bit j of word w: doc
// 32w + j), docs past n_pad clear. A thread a word: two 16-byte loads
// where the mask is 16-byte aligned and the word lies whole in it.
__global__ void __launch_bounds__(K12_THREADS)
k12_pack_kernel(const unsigned char* __restrict__ mask, int n_pad,
                long long n_mwords, unsigned* __restrict__ mbits) {
  const long long w = (long long)blockIdx.x * K12_THREADS + threadIdx.x;
  if (w >= n_mwords) return;
  const long long d0 = w * 32;
  unsigned word = 0;
  if (((uintptr_t)mask & 15) == 0 && d0 + 32 <= n_pad) {
    const uint4* src = reinterpret_cast<const uint4*>(mask + d0);
    const uint4 a = __ldcs(src), b = __ldcs(src + 1);
    const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) word |= k12_bits4(v[i]) << (4 * i);
  } else {
    for (int j = 0; j < 32 && d0 + j < n_pad; ++j)
      word |= (unsigned)(mask[d0 + j] != 0) << j;
  }
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(mbits + w),
               "r"(word), "l"(es_l2_evict_last())
               : "memory");
}

// Pass 1: the mask bits of a tile's pairs as words, and the tile's count.
// Warp w of the block packs words w*32 .. w*32+31 of the tile: step j
// reads 32 neighbouring pair docs and ballots their bits into word j,
// which lane j keeps.
__global__ void __launch_bounds__(K12_THREADS)
k12_bits_kernel(const int* __restrict__ docs, long long Mp,
                const unsigned* __restrict__ mbits, int n_pad,
                long long n_words, unsigned* __restrict__ bits,
                int* __restrict__ tile_sums) {
  typedef cub::BlockReduce<int, K12_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w0 = (long long)blockIdx.x * K12_TILE_WORDS + warp * 32;
  const unsigned long long pol = es_l2_evict_last();
  int d[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const long long i = (w0 + j) * 32 + lane;
    d[j] = i < Mp ? __ldcs(docs + i) : -1 - n_pad;  // out of range: false
  }
  bool g[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) g[j] = es_gather_bits(mbits, n_pad, d[j], pol);
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned word = __ballot_sync(0xffffffffu, g[j]);
    if (lane == j) mine = word;
  }
  const long long wi = w0 + lane;
  if (wi < n_words) bits[wi] = mine;
  const int total = Reduce(tmp).Sum(__popc(mine));
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Pass 2 (and the chunk table of the sums mode): an exclusive scan of n
// ints in one block, in place; out[n] = the total.
__global__ void __launch_bounds__(K12_SCAN_THREADS)
k12_scan_kernel(int* __restrict__ vals, int n) {
  typedef cub::BlockScan<int, K12_SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (int base = 0; base < n; base += K12_SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n ? vals[i] : 0;
    int excl, agg;
    Scan(tmp).ExclusiveSum(v, excl, agg);
    if (i < n) vals[i] = carry + excl;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) vals[n] = carry;
}

// Pass 3: each word's prefix (masked pairs before its first pair) and, when
// c is given, c[i+1] for every pair i of the tile.
__global__ void __launch_bounds__(K12_THREADS)
k12_prefix_kernel(const unsigned* __restrict__ bits, long long n_words,
                  const int* __restrict__ tile_prefix, long long Mp,
                  int* __restrict__ wprefix, int* __restrict__ c) {
  typedef cub::BlockScan<int, K12_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long wi = (long long)blockIdx.x * K12_TILE_WORDS + threadIdx.x;
  const unsigned mine = wi < n_words ? bits[wi] : 0u;
  int excl;
  Scan(tmp).ExclusiveSum(__popc(mine), excl);
  const int wp = tile_prefix[blockIdx.x] + excl;
  if (wi < n_words) wprefix[wi] = wp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    wprefix[n_words] = tile_prefix[gridDim.x];
    if (c != nullptr) c[0] = 0;
  }
  if (c == nullptr) return;
  const int lane = threadIdx.x & 31;
  const long long w0 = wi - lane;
  const unsigned upto = 0xffffffffu >> (31 - lane);
  for (int j = 0; j < 32; ++j) {
    const unsigned word = __shfl_sync(0xffffffffu, mine, j);
    const int p = __shfl_sync(0xffffffffu, wp, j);
    const long long i = (w0 + j) * 32 + lane;
    if (i < Mp) c[i + 1] = p + __popc(word & upto);
  }
}

// Masked pairs before pair i (0 <= i <= Mp), from the words.
__device__ __forceinline__ int k12_before(const unsigned* bits,
                                          const int* wprefix,
                                          long long n_words, long long i) {
  const long long w = i >> 5;
  const unsigned below = (1u << (i & 31)) - 1u;
  return wprefix[w] + (w < n_words ? __popc(bits[w] & below) : 0);
}

// Pass 4: per-run counts.
__global__ void k12_counts_kernel(const int* __restrict__ offsets, int Vp,
                                  long long Mp,
                                  const unsigned* __restrict__ bits,
                                  const int* __restrict__ wprefix,
                                  long long n_words,
                                  int* __restrict__ counts) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vp) return;
  const long long lo = min(max((long long)offsets[v], 0LL), Mp);
  const long long hi = min(max((long long)offsets[v + 1], 0LL), Mp);
  counts[v] = k12_before(bits, wprefix, n_words, hi) -
              k12_before(bits, wprefix, n_words, lo);
}

// Sums mode, step 1: chunks a run.
__global__ void k12_run_chunks_kernel(const int* __restrict__ offsets,
                                      int Vp, int* __restrict__ nch) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vp) return;
  const long long len = (long long)offsets[v + 1] - offsets[v];
  nch[v] = len > 0 ? (int)((len + K12_CHUNK - 1) / K12_CHUNK) : 0;
}

// Sums mode, step 2: a block a chunk (chunks past the total exit).
__global__ void __launch_bounds__(K12_THREADS)
k12_chunk_sums_kernel(const int* __restrict__ offsets, int Vp,
                      const int* __restrict__ chunk_base,
                      const int* __restrict__ docs,
                      const float* __restrict__ vals,
                      const unsigned* __restrict__ mbits, int n_pad,
                      double* __restrict__ partial) {
  typedef cub::BlockReduce<double, K12_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const int g = blockIdx.x;
  if (g >= chunk_base[Vp]) return;
  int lo = 0, hi = Vp;                   // the last v with base[v] <= g
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_base[mid] <= g) lo = mid; else hi = mid;
  }
  const long long start = (long long)offsets[lo] +
                          (long long)(g - chunk_base[lo]) * K12_CHUNK;
  const long long end = min(start + K12_CHUNK, (long long)offsets[lo + 1]);
  const unsigned long long pol = es_l2_evict_last();
  double s = 0.0;
  for (long long i = start + threadIdx.x; i < end; i += K12_THREADS) {
    const int doc = __ldcs(docs + i);
    const float v = __ldcs(vals + i);
    if (es_gather_bits(mbits, n_pad, doc, pol)) s += (double)v;
  }
  const double total = Reduce(tmp).Sum(s);
  if (threadIdx.x == 0) partial[g] = total;
}

// Sums mode, step 3: a warp a run adds its chunks (lane-strided, then a
// shuffle tree read at lane 0) and rounds once.
__global__ void k12_run_sums_kernel(const int* __restrict__ chunk_base,
                                    int Vp,
                                    const double* __restrict__ partial,
                                    float* __restrict__ sums) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long v = t >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= Vp) return;                   // whole warps leave together
  double s = 0.0;
  for (int g = chunk_base[v] + lane; g < chunk_base[v + 1]; g += 32)
    s += partial[g];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) sums[v] = (float)s;
}

// The L2 lines of [lo, lo + 128 n_lines) dropped, their data left
// undefined.
__global__ void __launch_bounds__(K12_THREADS)
k12_discard_kernel(char* lo, long long n_lines) {
  const long long i = (long long)blockIdx.x * K12_THREADS + threadIdx.x;
  if (i < n_lines)
    asm volatile("discard.global.L2 [%0], 128;" ::"l"(lo + i * 128)
                 : "memory");
}

// Discards the bit mask's whole 128-byte lines (at most a line at each end
// stays, in the workspace's other sections or past it).
static void k12_discard_bits(unsigned* mbits, long long n_mwords,
                             cudaStream_t st) {
  const uintptr_t lo = ((uintptr_t)mbits + 127) & ~(uintptr_t)127;
  const uintptr_t hi = (uintptr_t)(mbits + n_mwords) & ~(uintptr_t)127;
  if (hi <= lo) return;
  const long long n = (long long)((hi - lo) / 128);
  k12_discard_kernel<<<(unsigned)((n + K12_THREADS - 1) / K12_THREADS),
                       K12_THREADS, 0, st>>>((char*)lo, n);
}

static long long k12_align(long long b) { return (b + 15) & ~15LL; }

static long long k12_max_chunks(int Vp, long long Mp) {
  return Mp / K12_CHUNK + Vp;
}

// Bytes of the packed mask at the workspace's head.
static long long k12_mask_bytes(int n_pad) {
  return k12_align(4 * (((long long)n_pad + 31) / 32));
}

// Workspace bytes for mode 0 (counts), 1 (counts + prefix), 2 (sums): the
// packed mask, then the mode's tables (ops/aggs.py:
// masked_scan_workspace_bytes sizes the buffer).
static long long k12_workspace_bytes(int Vp, int Mp, int n_pad, int mode) {
  const long long n_words = ((long long)Mp + 31) / 32;
  const long long n_tiles = (n_words + K12_TILE_WORDS - 1) / K12_TILE_WORDS;
  if (mode == 2)
    return k12_mask_bytes(n_pad) + k12_align(4LL * (Vp + 1)) +
           8LL * k12_max_chunks(Vp, Mp);
  return k12_mask_bytes(n_pad) + k12_align(4 * n_words) +
         k12_align(4 * (n_tiles + 1)) + k12_align(4 * (n_words + 1));
}

extern "C" int es_agg_masked_scan(const int* offsets, int Vp,
                                  const int* pair_docs,
                                  const float* pair_vals, int Mp,
                                  const unsigned char* mask, int n_pad,
                                  int mode, int* out_counts, int* out_c,
                                  float* out_sums, void* workspace,
                                  long long workspace_bytes, void* stream) {
  if (mode < 0 || mode > 2) return ES_ERR_ARG;
  if (k12_workspace_bytes(Vp, Mp, n_pad, mode) > workspace_bytes)
    return ES_ERR_SIZE;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* mbits = (unsigned*)workspace;
  char* ws = (char*)workspace + k12_mask_bytes(n_pad);
  const long long n_mwords = ((long long)n_pad + 31) / 32;
  const bool gathers = mode == 2 ? Vp > 0 && Mp > 0 : Mp > 0;
  if (gathers && n_mwords > 0)
    k12_pack_kernel<<<(unsigned)((n_mwords + K12_THREADS - 1) / K12_THREADS),
                      K12_THREADS, 0, st>>>(mask, n_pad, n_mwords, mbits);
  if (mode == 2) {
    if (Vp == 0) return (int)cudaGetLastError();
    int* chunk_base = (int*)ws;
    double* partial = (double*)(ws + k12_align(4LL * (Vp + 1)));
    const int vb = (Vp + 255) / 256;
    k12_run_chunks_kernel<<<vb, 256, 0, st>>>(offsets, Vp, chunk_base);
    k12_scan_kernel<<<1, K12_SCAN_THREADS, 0, st>>>(chunk_base, Vp);
    const long long grid = k12_max_chunks(Vp, Mp);
    if (grid > 0)
      k12_chunk_sums_kernel<<<(unsigned)grid, K12_THREADS, 0, st>>>(
          offsets, Vp, chunk_base, pair_docs, pair_vals, mbits, n_pad,
          partial);
    if (gathers) k12_discard_bits(mbits, n_mwords, st);
    const long long threads = 32LL * Vp;
    k12_run_sums_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        chunk_base, Vp, partial, out_sums);
    return (int)cudaGetLastError();
  }
  const long long n_words = ((long long)Mp + 31) / 32;
  const long long n_tiles = (n_words + K12_TILE_WORDS - 1) / K12_TILE_WORDS;
  unsigned* bits = (unsigned*)ws;
  int* tile_prefix = (int*)(ws + k12_align(4 * n_words));
  int* wprefix = (int*)((char*)tile_prefix + k12_align(4 * (n_tiles + 1)));
  if (n_tiles > 0) {
    k12_bits_kernel<<<(unsigned)n_tiles, K12_THREADS, 0, st>>>(
        pair_docs, Mp, mbits, n_pad, n_words, bits, tile_prefix);
    k12_discard_bits(mbits, n_mwords, st);
  }
  k12_scan_kernel<<<1, K12_SCAN_THREADS, 0, st>>>(tile_prefix, (int)n_tiles);
  if (n_tiles > 0) {
    k12_prefix_kernel<<<(unsigned)n_tiles, K12_THREADS, 0, st>>>(
        bits, n_words, tile_prefix, Mp, wprefix, mode == 1 ? out_c : nullptr);
  } else {
    // no pairs: the prefix is {0}, every run is empty
    cudaMemsetAsync(wprefix, 0, sizeof(int), st);
    if (mode == 1) cudaMemsetAsync(out_c, 0, sizeof(int), st);
  }
  if (Vp > 0)
    k12_counts_kernel<<<(Vp + 255) / 256, 256, 0, st>>>(
        offsets, Vp, Mp, bits, wprefix, n_words, out_counts);
  return (int)cudaGetLastError();
}
