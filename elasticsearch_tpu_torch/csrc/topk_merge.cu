// K3: row-wise tie-stable top-k over candidate lists.
//
// Replaces elasticsearch_tpu/ops/tiered_bm25.py:merge_topk_lists (exact
// union of two top-k lists, a doc present in both keeps its higher score),
// parallel/dist_search.py:_global_topk_reduce (cross-shard top-k over
// shard-major lists, ids globalised as s * n_pad + local) and the final
// stage of ops/topk.py:batched_blockwise_topk / the running top-k of
// ops/tiered_bm25.py:dense_stream_topk (here: the reduce of K2's per-tile
// partial lists, and of K6's per-chunk lists).
//
// A row is the concatenation [a | b] of two lists (b may be empty).
// Column c's id is id + (c / seg_len) * seg_stride (the shard
// globalisation; seg_stride 0 leaves ids as they are). Entries whose value
// is -inf or NaN, or whose id is >= fill_id, take no part. With dedup, an
// entry is dropped when another entry has its id and a higher value (or
// the same value at an earlier column). The k outputs are the best entries
// under the total order (value desc, id asc, column asc): the order
// lax.top_k gives over doc-ascending lists and lax.sort gives in
// merge_topk_lists. Rows with fewer than k entries pad with (-inf,
// fill_id). With out_sel, each output also records its column in [a | b]
// (0 on padded slots): the payload channels of _global_topk_reduce (the
// rescore secondaries) follow the selection through one gather.
//
// Design. Each entry becomes a 64-bit key whose unsigned order is the
// order above: the value's bits mapped to an ascending unsigned and
// flipped (-0 taken as +0, so the two tie as the reference's compares
// do), then the id's bits with the sign flipped; the column breaks ties,
// so (key, column) is unique in a row. A block takes a segment of a row
// into shared memory (or, past it, into its slice of a device-memory
// workspace: the code is the same) and finds its k best without k passes:
//   - a radix select over the 12 bytes of (key, column), from the top: a
//     256-bin histogram of the next byte over the entries that match the
//     bytes fixed so far, one pass over the segment each, until the
//     entries at or below the bin of the k-th fit the survivor buffer (a
//     power of two, at least 2k);
//   - those survivors, copied out, sorted by a bitonic sort;
//   - dedup first, where asked: the segment sorted by (id, value desc,
//     column), every entry after the first of its id dropped.
// A launch with few rows, or rows longer than shared memory, splits each
// row into G segments over G blocks (ops/topk.py:topk_merge_plan), each
// writing its k best keys and columns to the workspace; a second kernel
// of the same code takes each row's G lists and selects the k best of
// them. This is exact: the top-k of a union lies in the union of the
// parts' top-ks, and with dedup an entry cut from its segment's list has k
// better ids in that segment alone. The entry launches both kernels (one
// counted launch).
//
// Bound: the card's memory rate (8 bytes per entry read, 8 per output);
// the select re-reads a segment from shared memory a few times (each pass
// fixes 8 bits of the key).

#include "topk_common.cuh"

#define K3_THREADS 256
#define K3_INVALID 0xffffffffffffffffull

typedef unsigned long long k3u64;

struct K3Args {
  const float* a_vals;
  const int* a_ids;
  int ma;
  const float* b_vals;
  const int* b_ids;
  int mb;
  int k, dedup, seg_len, seg_stride, fill_id;
  float* out_vals;
  int* out_ids;
  int* out_sel;
};

// The key of a valid entry: its unsigned order is (value desc, id asc).
__device__ __forceinline__ k3u64 k3_key(float v, int id) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  const unsigned up = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((k3u64)(~up) << 32) | (k3u64)((unsigned)id ^ 0x80000000u);
}

__device__ __forceinline__ int k3_key_id(k3u64 key) {
  return (int)((unsigned)key ^ 0x80000000u);
}

// Byte p (0: the top) of the 12-byte (key, column).
__device__ __forceinline__ int k3_digit(k3u64 key, unsigned col, int p) {
  return p < 8 ? (int)((key >> (56 - 8 * p)) & 255u)
               : (int)((col >> (24 - 8 * (p - 8))) & 255u);
}

// The first p bytes of (key, column) against the prefix (phi: the first
// min(p, 8) bytes, plo: the rest): -1 below, 0 equal, 1 above.
__device__ __forceinline__ int k3_cmp(k3u64 key, unsigned col, int p,
                                      k3u64 phi, unsigned plo) {
  if (p == 0) return 0;
  const int ph = p < 8 ? p : 8;
  const k3u64 a = key >> (64 - 8 * ph);
  if (a != phi) return a < phi ? -1 : 1;
  if (p <= 8) return 0;
  const unsigned b = col >> (32 - 8 * (p - 8));
  if (b != plo) return b < plo ? -1 : 1;
  return 0;
}

__device__ __forceinline__ bool k3_less(k3u64 x, unsigned cx, k3u64 y,
                                        unsigned cy) {
  return x < y || (x == y && cx < cy);
}

// Sorts n2 (a power of two) (key, column) pairs ascending. Every thread
// calls it; ends with a barrier.
__device__ void k3_sort(k3u64* key, unsigned* col, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n2 >> 1); t += K3_THREADS) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const k3u64 x = key[i], y = key[j];
        const unsigned cx = col[i], cy = col[j];
        const bool up = (i & size) == 0;
        if (up ? k3_less(y, cy, x, cx) : k3_less(x, cx, y, cy)) {
          key[i] = y;
          key[j] = x;
          col[i] = cy;
          col[j] = cx;
        }
      }
    }
  }
  __syncthreads();
}

// Block-wide sum of one int a thread; every thread gets it.
__device__ __forceinline__ int k3_block_sum(int v, int* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(slot, v);
  __syncthreads();
  const int sum = *slot;
  __syncthreads();
  return sum;
}

__host__ __device__ inline int k3_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of a block's buffers: cap row entries and S survivors, 12 bytes
// each (key and column), rounded to 16.
static inline size_t k3_block_bytes(int cap, int S) {
  return ((size_t)(cap + S) * 12 + 15) & ~(size_t)15;
}

// One block: the kout best entries of its segment. Level 0 (in_key null)
// reads columns [y * cap, y * cap + cap) of row x of [a | b]; level 1
// reads the cap partial keys and columns of row x. out_key null: write
// the final outputs; else the block's kout keys and columns (invalid keys
// past the entries).
__global__ void __launch_bounds__(K3_THREADS)
topk_merge_kernel(K3Args p, int m, int cap, int S2, int kout,
                  const k3u64* __restrict__ in_key,
                  const unsigned* __restrict__ in_col, k3u64* out_key,
                  unsigned* out_col, unsigned char* ws, size_t ws_block) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  __shared__ unsigned hist[256];
  __shared__ unsigned wsum[K3_THREADS / 32];
  __shared__ int s_cnt, s_b, s_excl, s_h;

  const int r = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t blk = (size_t)r * gridDim.y + g;
  unsigned char* base = ws != nullptr ? ws + blk * ws_block : k3_smem;
  k3u64* key = reinterpret_cast<k3u64*>(base);     // [cap]
  k3u64* skey = key + cap;                         // [S2]
  unsigned* col = reinterpret_cast<unsigned*>(skey + S2);  // [cap]
  unsigned* scol = col + cap;                      // [S2]

  // ---- the segment's keys -------------------------------------------------
  const int lo = in_key != nullptr ? 0 : g * cap;
  const int n = in_key != nullptr ? cap : min(cap, m - lo);
  int nv = 0;
  for (int i = tid; i < n; i += K3_THREADS) {
    k3u64 kx;
    unsigned cx;
    if (in_key != nullptr) {
      kx = in_key[(size_t)r * cap + i];
      cx = in_col[(size_t)r * cap + i];
    } else {
      const int c = lo + i;
      float v;
      int id;
      if (c < p.ma) {
        v = p.a_vals[(size_t)r * p.ma + c];
        id = p.a_ids[(size_t)r * p.ma + c];
      } else {
        v = p.b_vals[(size_t)r * p.mb + (c - p.ma)];
        id = p.b_ids[(size_t)r * p.mb + (c - p.ma)];
      }
      id += (c / p.seg_len) * p.seg_stride;
      kx = (v > -CUDART_INF_F && id < p.fill_id) ? k3_key(v, id)
                                                 : K3_INVALID;
      cx = (unsigned)c;
    }
    key[i] = kx;
    col[i] = cx;
    nv += kx != K3_INVALID;
  }
  int nvalid = k3_block_sum(nv, &s_cnt);

  // ---- dedup: sort by (id, value desc, position), drop all but the first
  // of an id. Equal (id, value) entries lie in column order in a segment
  // and in the concatenated partial lists alike, so the position breaks
  // their tie as the column does.
  if (p.dedup) {
    const int nd = k3_pow2(n > 0 ? n : 1);
    for (int i = tid; i < nd; i += K3_THREADS) {
      const k3u64 kx = i < n ? key[i] : K3_INVALID;
      skey[i] = kx == K3_INVALID ? K3_INVALID : (kx << 32) | (kx >> 32);
      scol[i] = (unsigned)i;
    }
    k3_sort(skey, scol, nd);
    for (int i = tid + 1; i < nvalid; i += K3_THREADS)
      if ((skey[i] >> 32) == (skey[i - 1] >> 32)) key[scol[i]] = K3_INVALID;
    __syncthreads();
    nv = 0;
    for (int i = tid; i < n; i += K3_THREADS) nv += key[i] != K3_INVALID;
    nvalid = k3_block_sum(nv, &s_cnt);
  }

  // ---- radix select: fix bytes of (key, column) from the top until the
  // entries at or below the k-th's bin fit the survivor buffer.
  const int kk = min(kout, nvalid);
  int pd = 0;
  k3u64 phi = 0;
  unsigned plo = 0;
  if (nvalid > S2) {
    int need = kk, lt = 0;
    for (;;) {
      hist[tid] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += K3_THREADS) {
        const int i = i0 + tid;
        int d = -1;
        if (i < n) {
          const k3u64 kx = key[i];
          const unsigned cx = col[i];
          if (kx != K3_INVALID && k3_cmp(kx, cx, pd, phi, plo) == 0)
            d = k3_digit(kx, cx, pd);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (d >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[d], (unsigned)__popc(peers));
      }
      __syncthreads();
      // the bin holding the need-th entry: an inclusive scan of the 256
      const unsigned h = hist[tid];
      unsigned x = h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) wsum[tid >> 5] = x;
      __syncthreads();
      for (int w = 0; w < (tid >> 5); ++w) x += wsum[w];
      const unsigned excl = x - h;
      if (excl < (unsigned)need && x >= (unsigned)need) {
        s_b = tid;
        s_excl = (int)excl;
        s_h = (int)h;
      }
      __syncthreads();
      lt += s_excl;
      need -= s_excl;
      if (pd < 8)
        phi = (phi << 8) | (k3u64)s_b;
      else
        plo = (plo << 8) | (unsigned)s_b;
      ++pd;
      if (lt + s_h <= S2 || pd == 12) break;
    }
  }

  // ---- the survivors (every valid entry where no select ran), sorted ----
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += K3_THREADS) {
    const int i = i0 + tid;
    bool take = false;
    k3u64 kx = K3_INVALID;
    unsigned cx = 0;
    if (i < n) {
      kx = key[i];
      cx = col[i];
      take = kx != K3_INVALID && k3_cmp(kx, cx, pd, phi, plo) <= 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if (lane == 0 && bal != 0) at = atomicAdd(&s_cnt, __popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (take) {
      const int pos = at + __popc(bal & ((1u << lane) - 1u));
      skey[pos] = kx;
      scol[pos] = cx;
    }
  }
  __syncthreads();
  const int cnt = s_cnt;
  const int n2 = k3_pow2(cnt > 0 ? cnt : 1);
  for (int i = cnt + tid; i < n2; i += K3_THREADS) {
    skey[i] = K3_INVALID;
    scol[i] = 0xffffffffu;
  }
  k3_sort(skey, scol, n2);

  // ---- out ------------------------------------------------------------------
  if (out_key != nullptr) {
    k3u64* ok = out_key + blk * kout;
    unsigned* oc = out_col + blk * kout;
    for (int j = tid; j < kout; j += K3_THREADS) {
      ok[j] = j < kk ? skey[j] : K3_INVALID;
      oc[j] = j < kk ? scol[j] : 0xffffffffu;
    }
    return;
  }
  float* ov = p.out_vals + (size_t)r * kout;
  int* oi = p.out_ids + (size_t)r * kout;
  int* os = p.out_sel != nullptr ? p.out_sel + (size_t)r * kout : nullptr;
  for (int j = tid; j < kout; j += K3_THREADS) {
    if (j < kk) {
      const int c = (int)scol[j];
      ov[j] = c < p.ma ? p.a_vals[(size_t)r * p.ma + c]
                       : p.b_vals[(size_t)r * p.mb + (c - p.ma)];
      oi[j] = k3_key_id(skey[j]);
      if (os != nullptr) os[j] = c;
    } else {
      ov[j] = -CUDART_INF_F;
      oi[j] = p.fill_id;
      if (os != nullptr) os[j] = 0;
    }
  }
}

// The plan (ops/topk.py:topk_merge_plan): G segments of L columns a row;
// S0 and S1 the survivor buffers of the segment and merge kernels;
// glob0/glob1 put a kernel's buffers in the workspace instead of shared
// memory. The workspace holds, in order: the partial keys [R, G, k] and
// columns (G > 1), then glob0's block buffers, then glob1's, each part at
// a multiple of 16 bytes. Returns ES_ERR_SIZE for a plan that does not
// cover the rows, ES_ERR_SHARED for buffers past a block's shared memory.
extern "C" int es_topk_merge(const float* a_vals, const int* a_ids, int ma,
                             const float* b_vals, const int* b_ids, int mb,
                             int R, int k, int dedup, int seg_len,
                             int seg_stride, int fill_id, int G, int L,
                             int S0, int S1, int glob0, int glob1,
                             float* out_vals, int* out_ids, int* out_sel,
                             void* workspace, void* stream) {
  const int m = ma + mb;
  if (R < 1 || k < 1 || G < 1 || G > 65535 || L < 0 || seg_len < 1 ||
      (long long)G * L < m || (G > 1 && ((long long)(G - 1) * L >= m ||
                                         L < k)) ||
      S0 < 1 || S1 < 1 || (S0 & (S0 - 1)) || (S1 & (S1 - 1)) ||
      (dedup && S0 < L) || (dedup && G > 1 && S1 < G * k) ||
      S0 < min(k, L) || (G > 1 && S1 < k) ||
      ((glob0 || G > 1) && workspace == nullptr))
    return ES_ERR_SIZE;
  K3Args p{a_vals, a_ids, ma, b_vals, b_ids, mb, k, dedup, seg_len,
           seg_stride, fill_id, out_vals, out_ids, out_sel};
  unsigned char* ws = reinterpret_cast<unsigned char*>(workspace);
  const size_t part = G > 1 ? (size_t)R * G * k : 0;
  k3u64* pkey = reinterpret_cast<k3u64*>(ws);
  unsigned* pcol = reinterpret_cast<unsigned*>(pkey + part);
  size_t off = (part * 12 + 15) & ~(size_t)15;
  const int cap1 = G * k;
  const size_t blk0 = k3_block_bytes(L, S0), blk1 = k3_block_bytes(cap1, S1);
  unsigned char* ws0 = glob0 ? ws + off : nullptr;
  off += glob0 ? (size_t)R * G * blk0 : 0;
  unsigned char* ws1 = (G > 1 && glob1) ? ws + off : nullptr;
  const size_t shm0 = glob0 ? 0 : blk0;
  const size_t shm1 = (G > 1 && !glob1) ? blk1 : 0;
  // the kernel's dynamic shared memory is opened to the whole block once
  static long long room = -1;
  if (room < 0) {
    const long long r = (long long)es_max_shared_bytes() -
                        (long long)es_static_shared_bytes(topk_merge_kernel);
    const int e = (int)cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)r);
    if (e != 0) return e;
    room = r;
  }
  if ((long long)shm0 > room || (long long)shm1 > room) return ES_ERR_SHARED;
  cudaStream_t st = (cudaStream_t)stream;
  topk_merge_kernel<<<dim3(R, G), K3_THREADS, shm0, st>>>(
      p, m, L, S0, k, nullptr, nullptr, G > 1 ? pkey : nullptr,
      G > 1 ? pcol : nullptr, ws0, blk0);
  if (G > 1)
    topk_merge_kernel<<<dim3(R, 1), K3_THREADS, shm1, st>>>(
        p, m, cap1, S1, k, pkey, pcol, nullptr, nullptr, ws1, blk1);
  return (int)cudaGetLastError();
}
