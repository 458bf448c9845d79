// K12: the masked scan over an ordinal-CSR pair layout.
//
// Replaces elasticsearch_tpu/ops/aggs.py:masked_ordinal_counts (:46),
// masked_ordinal_sums (:63) and masked_rank_prefix (:113): gather the
// query's doc mask at each pair (jnp.take with fill: a doc in [-n_pad, 0)
// wraps, any other doc outside [0, n_pad) gathers false), take the
// masked-count prefix c (c[i] = masked pairs before pair i), and the
// per-run counts c[off[v+1]] - c[off[v]]; or the per-run masked value
// sums.
//
// Bound: bytes. The pairs (4 bytes a doc, 4 more with values, 4 written a
// prefix entry) stream once; the mask is gathered at random (pairs sorted
// by (ordinal, value) reach their docs in no order), and a gathered byte
// costs the card a 32-byte sector of a mask far larger than L2. So the
// counts and prefix modes gather the mask exactly once: pass 1 packs the
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

// Pass 1: the mask bits of a tile's pairs as words, and the tile's count.
// Warp w of the block packs words w*32 .. w*32+31 of the tile: step j
// reads 32 neighbouring pair docs and ballots their bits into word j,
// which lane j keeps.
__global__ void __launch_bounds__(K12_THREADS)
k12_bits_kernel(const int* __restrict__ docs, long long Mp,
                const unsigned char* __restrict__ mask, int n_pad,
                long long n_words, unsigned* __restrict__ bits,
                int* __restrict__ tile_sums) {
  typedef cub::BlockReduce<int, K12_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w0 = (long long)blockIdx.x * K12_TILE_WORDS + warp * 32;
  int d[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const long long i = (w0 + j) * 32 + lane;
    d[j] = i < Mp ? docs[i] : -1 - n_pad;     // out of range: gathers false
  }
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned word = __ballot_sync(0xffffffffu,
                                        es_gather_mask(mask, n_pad, d[j]));
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
                      const unsigned char* __restrict__ mask, int n_pad,
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
  double s = 0.0;
  for (long long i = start + threadIdx.x; i < end; i += K12_THREADS)
    if (es_gather_mask(mask, n_pad, docs[i])) s += (double)vals[i];
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

static long long k12_align(long long b) { return (b + 15) & ~15LL; }

static long long k12_max_chunks(int Vp, long long Mp) {
  return Mp / K12_CHUNK + Vp;
}

// Workspace bytes for mode 0 (counts), 1 (counts + prefix), 2 (sums).
extern "C" long long es_agg_masked_scan_workspace_bytes(int Vp, int Mp,
                                                        int mode) {
  const long long n_words = ((long long)Mp + 31) / 32;
  const long long n_tiles = (n_words + K12_TILE_WORDS - 1) / K12_TILE_WORDS;
  if (mode == 2)
    return k12_align(4LL * (Vp + 1)) + 8LL * k12_max_chunks(Vp, Mp);
  return k12_align(4 * n_words) + k12_align(4 * (n_tiles + 1)) +
         k12_align(4 * (n_words + 1));
}

extern "C" int es_agg_masked_scan(const int* offsets, int Vp,
                                  const int* pair_docs,
                                  const float* pair_vals, int Mp,
                                  const unsigned char* mask, int n_pad,
                                  int mode, int* out_counts, int* out_c,
                                  float* out_sums, void* workspace,
                                  void* stream) {
  if (mode < 0 || mode > 2) return ES_ERR_ARG;
  cudaStream_t st = (cudaStream_t)stream;
  char* ws = (char*)workspace;
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
          offsets, Vp, chunk_base, pair_docs, pair_vals, mask, n_pad,
          partial);
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
        pair_docs, Mp, mask, n_pad, n_words, bits, tile_prefix);
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
