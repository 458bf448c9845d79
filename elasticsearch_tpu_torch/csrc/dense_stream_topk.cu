// K2: dense-tier scoring + per-tile top-k for a batch of queries.
//
// Replaces elasticsearch_tpu/ops/tiered_bm25.py:dense_stream_topk (the
// lax.scan over [n_blk, T, C] bf16 blocks of W[B, T] @ f32(block) with a
// running top-k), together with the step's used-row gather
// (parallel/dist_search.py:build_tiered_bm25_step, jnp.take over u_ids):
// rows are read in place through u_ids, never copied.
//
// The reference's product is f32 over all T rows; a query's weight row
// W[b, :] has at most Q non-zeros, so only those are summed, in ascending
// column order, with fmaf in f32 (an exact zero product adds nothing, so
// this equals the full product summed in column order; the reference's
// own order is XLA's, hence a stated rtol). No bf16 or TF32 tensor-core
// shortcut: the reference product is f32, and the work is 2 flops a
// non-zero weight and doc, far below the card's f32 rate. Then the s > 0
// mask (and the min_should_match count when msm > 1), the matched count,
// and a top-k per query keyed (score desc, doc asc). Each block writes its
// tile's k best per query; K3 (topk_merge.cu) reduces the tiles.
//
// Bound: the card's memory rate. The function must read each dense row
// the batch uses once (n_pad bf16 values a row). Design:
//  - a prep kernel finds the columns of W any query of a shard uses (the
//    staged rows, R of them) and compacts each query's non-zero (column,
//    weight) pairs in column order into a workspace;
//  - the tile kernel's grid is (doc tile, shard, group of up to 64
//    queries), one block an SM over the card, one wave. A copying warp
//    stages the R rows' slice of a chunk of docs into a shared-memory ring
//    of K2_STAGES slots with bulk copies (the copy engine's; 8-byte
//    cp.async where the rows are not 16-byte aligned), each slot's
//    arrival and release on barriers in shared memory: each row slice is
//    read from device memory once a tile, for every query of the batch,
//    and no block-wide barrier couples the scoring warps, which may drift
//    apart by the ring's slots (one warp merging while another scores). A
//    chunk is 128 docs times as many passes (a power of two up to 8) as
//    the ring holds at R rows; when even one pass does not fit, the rows
//    split into groups staged one after the other, each query's sums kept
//    between groups in a device-memory scratch;
//  - warp w owns queries w, w + 16, ...: a lane scores 4 consecutive docs
//    of a 128-doc pass (one 8-byte shared load a row; at 4 docs a lane the
//    tile kernel takes 96 registers with a few spill stores, at 8 or 16 it
//    spills more and runs slower), so the queries' selection state is the
//    warp's own and needs no block barrier. A warp max of a pass's scores
//    against the query's k-th key at the last merge says whether any doc
//    may beat it; the docs that do go to the query's candidate buffer at
//    places a warp scan of the lanes' counts gives. When a buffer would
//    overflow, and once at the tile's end, the warp sorts it (bitonic)
//    and merges it into the query's sorted list, each entry placed at its
//    rank among both (binary searches), no thread inserting one at a
//    time. Matched counts stay in registers and reach device memory as
//    one atomic a block and query.

#include <limits.h>

#include <cub/block/block_scan.cuh>

#include "topk_common.cuh"

// one block an SM: 16 warps, K2_QW queries a warp
#define K2_THREADS 512
#define K2_WARPS (K2_THREADS / 32)
#define K2_QW 4
#define K2_QUERIES (K2_WARPS * K2_QW)
// candidate buffer of a query (a power of two, at least 32)
#define K2_CAND 64
// non-zero weights a query keeps in shared memory (more: read in place)
#define K2_NZ 16
#define K2_STAGES 4
// docs of a pass: 32 lanes x 4
#define K2_PASS 128
#define K2_MAX_PASSES 8
#define K2_PREP_THREADS 1024

struct K2Nz {
  int j;      // staged row
  float w;
};

__host__ __device__ static size_t k2_align(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Bytes of the tile kernel's dynamic shared memory, in the kernel's order:
// the candidate buffers, the per-query state (candidates, list fill, the
// k-th key), the weights, the staged row ids, the lists (kTopShared), the
// ring's barriers and the ring.
static size_t k2_shared_bytes(int QB, int U, int k, int top_shared,
                              int rows_max) {
  return k2_align((size_t)QB * K2_CAND * 8) + k2_align((size_t)QB * 16) +
         k2_align((size_t)QB * K2_NZ * 8) + k2_align((size_t)U * 4) +
         (top_shared ? k2_align((size_t)QB * k * 8) : 0) +
         k2_align((size_t)K2_STAGES * 16) +
         (size_t)K2_STAGES * rows_max * K2_PASS * 2;
}

// One block a shard: the used columns (any query's weight non-zero), their
// staged positions, and each query's non-zero pairs in column order.
__global__ void __launch_bounds__(K2_PREP_THREADS)
k2_prep_kernel(const float* __restrict__ W, const int* __restrict__ u_ids,
               int B, int S, int U, K2Nz* __restrict__ nz,
               int* __restrict__ nz_n, int* __restrict__ stage_row,
               int* __restrict__ R_out) {
  typedef cub::BlockScan<int, K2_PREP_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  extern __shared__ int colpos[];                       // [U]
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  for (int u = tid; u < U; u += K2_PREP_THREADS) {
    int used = 0;
    for (int b = 0; b < B && !used; ++b)
      used = W[((size_t)b * S + s) * U + u] != 0.0f;
    colpos[u] = used;
  }
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < U; base += K2_PREP_THREADS) {
    const int u = base + tid;
    const int used = u < U ? colpos[u] : 0;
    int excl, agg;
    Scan(tmp).ExclusiveSum(used, excl, agg);
    if (used) {
      colpos[u] = carry + excl;
      stage_row[(size_t)s * U + carry + excl] =
          u_ids != nullptr ? u_ids[(size_t)s * U + u] : u;
    }
    carry += agg;
    __syncthreads();
  }
  if (tid == 0) R_out[s] = carry;
  const int lane = tid & 31, warp = tid >> 5;
  for (int b = warp; b < B; b += K2_PREP_THREADS / 32) {
    const float* wrow = W + ((size_t)b * S + s) * U;
    K2Nz* out = nz + ((size_t)b * S + s) * U;
    int n = 0;
    for (int u0 = 0; u0 < U; u0 += 32) {
      const int u = u0 + lane;
      const float w = u < U ? wrow[u] : 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, w != 0.0f);
      if (w != 0.0f)
        out[n + __popc(m & ((1u << lane) - 1u))] = {colpos[u], w};
      n += __popc(m);
    }
    if (lane == 0) nz_n[(size_t)b * S + s] = n;
  }
}

__device__ __forceinline__ unsigned k2_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void k2_bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void k2_bar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "K2_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra K2_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void k2_bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void k2_bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// A bulk copy (the copy engine's, no thread moving bytes) of ``bytes``
// (a multiple of 16, both ends 16-byte aligned) that completes on ``bar``.
__device__ __forceinline__ void k2_bulk(void* dst, const void* src,
                                        unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(k2_smem(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An 8-byte copy by this thread; k2_cp_done makes ``bar`` count the
// thread's copies issued so far once they land.
__device__ __forceinline__ void k2_cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(k2_smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void k2_cp_done(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// Sorts the n candidates of (cs, cd) (n <= K2_CAND) best first and merges
// them into the sorted list (ls, ld) of f entries, keeping the k best;
// every lane of the warp calls it. Returns the list's new fill.
__device__ __noinline__ int k2_merge(float* cs, int* cd, int n, float* ls,
                                     int* ld, int f, int k) {
  const int lane = threadIdx.x & 31;
  int n2 = 32;
  while (n2 < n) n2 <<= 1;
  for (int i = n + lane; i < n2; i += 32) {
    cs[i] = -CUDART_INF_F;
    cd[i] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const float xs = cs[i], ys = cs[j];
        const int xd = cd[i], yd = cd[j];
        const bool up = (i & size) == 0;
        if (up ? key_better(ys, yd, xs, xd) : key_better(xs, xd, ys, yd)) {
          cs[i] = ys;
          cd[i] = yd;
          cs[j] = xs;
          cd[j] = xd;
        }
      }
      __syncwarp();
    }
  }
  // each candidate's rank: its place among the candidates plus the list
  // entries better than it
  float hs[K2_CAND / 32];
  int hd[K2_CAND / 32], hr[K2_CAND / 32];
#pragma unroll
  for (int h = 0; h < K2_CAND / 32; ++h) {
    const int jj = lane + 32 * h;
    hs[h] = 0.0f;
    hd[h] = 0;
    hr[h] = INT_MAX;
    if (jj < n) {
      hs[h] = cs[jj];
      hd[h] = cd[jj];
      int lo = 0, hi = f;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_better(ls[mid], ld[mid], hs[h], hd[h])) lo = mid + 1;
        else hi = mid;
      }
      hr[h] = jj + lo;
    }
  }
  __syncwarp();
  // each list entry moves down by the candidates better than it: from the
  // top, 32 at a time, all read before any is written (a new place is at
  // or past the old one)
  for (int base = ((f - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int i = base + lane;
    float s = 0.0f;
    int d = 0, r = INT_MAX;
    if (i < f) {
      s = ls[i];
      d = ld[i];
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_better(cs[mid], cd[mid], s, d)) lo = mid + 1;
        else hi = mid;
      }
      r = i + lo;
    }
    __syncwarp();
    if (r < k) {
      ls[r] = s;
      ld[r] = d;
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < K2_CAND / 32; ++h) {
    if (hr[h] < k) {
      ls[hr[h]] = hs[h];
      ld[hr[h]] = hd[h];
    }
  }
  __syncwarp();
  return min(k, f + n);
}

// The per-query state of a block, in shared memory.
struct K2State {
  int* ncand;
  int* filled;
  float* thr_s;     // the k-th key at the last merge ((0, INT_MIN) until
  int* thr_d;       // the list fills: every matched doc beats it)
};

// Merges query q's candidates into its list and sets its threshold.
__device__ __forceinline__ void k2_flush(const K2State& st, int q,
                                         float* cs, int* cd, float* ls,
                                         int* ld, int k) {
  const int f = k2_merge(cs, cd, st.ncand[q], ls, ld, st.filled[q], k);
  if ((threadIdx.x & 31) == 0) {
    st.ncand[q] = 0;
    st.filled[q] = f;
    st.thr_s[q] = f == k ? ls[k - 1] : 0.0f;
    st.thr_d[q] = f == k ? ld[k - 1] : INT_MIN;
  }
  __syncwarp();
}

__device__ __forceinline__ bool k2_beats(float sc, int doc, float ts,
                                         int td) {
  return sc > ts || (sc == ts && doc < td);
}

// Grid (n_tiles, S, query groups of QB), one block an SM: K2_WARPS
// scoring warps and a copying warp. kMsm: msm > 1 (a match count a doc);
// kTopShared: the lists sit in shared memory, else in the block's own
// slices of part_vals / part_docs; kBulk: the rows are 16-byte aligned
// (bulk copies), else 8-byte copies by the copying warp's lanes.
// ``carry`` (null when the rows always fit one group): a block's sums
// between row groups, [block][QB][32 lanes] float4 and int4.
template <bool kMsm, bool kTopShared, bool kBulk>
__global__ void __launch_bounds__(K2_THREADS + 32, 1)
k2_tile_kernel(const __nv_bfloat16* __restrict__ dense,
               const K2Nz* __restrict__ nz_g, const int* __restrict__ nz_n_g,
               const int* __restrict__ stage_row_g,
               const int* __restrict__ R_g, int B, int S, int U, int n_blk,
               int T, int C, int n_pad, int k, int msm, int docs_per_tile,
               int n_tiles, int QB, int rows_max,
               float* __restrict__ part_vals, int* __restrict__ part_docs,
               int* __restrict__ n_matched, float4* __restrict__ carry) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, s = blockIdx.y;
  const int b0 = blockIdx.z * QB;
  const int nq = min(QB, B - b0);
  unsigned char* p = smem;
  float* cand_s = reinterpret_cast<float*>(p);                 // [QB][CAND]
  int* cand_d = reinterpret_cast<int*>(cand_s + (size_t)QB * K2_CAND);
  p += k2_align((size_t)QB * K2_CAND * 8);
  K2State st;
  st.ncand = reinterpret_cast<int*>(p);
  st.filled = st.ncand + QB;
  st.thr_s = reinterpret_cast<float*>(st.filled + QB);
  st.thr_d = reinterpret_cast<int*>(st.thr_s + QB);
  p += k2_align((size_t)QB * 16);
  K2Nz* nz_s = reinterpret_cast<K2Nz*>(p);                     // [QB][NZ]
  p += k2_align((size_t)QB * K2_NZ * 8);
  int* srow = reinterpret_cast<int*>(p);                       // [U]
  p += k2_align((size_t)U * 4);
  float* top_s = reinterpret_cast<float*>(p);                  // [QB][k]
  int* top_d = reinterpret_cast<int*>(top_s + (size_t)QB * k);
  if (kTopShared) p += k2_align((size_t)QB * k * 8);
  // a slot's copies landed (full) / its scoring warps are done (empty)
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(p);
  p += k2_align((size_t)K2_STAGES * 16);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(p);
  const unsigned full0 = k2_smem(bars), empty0 = k2_smem(bars + K2_STAGES);
  if (tid == 0) {
    for (int i = 0; i < K2_STAGES; ++i) {
      k2_bar_init(full0 + 8 * i, kBulk ? 1 : 32);
      k2_bar_init(empty0 + 8 * i, K2_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  const int R = R_g[s];
  for (int i = tid; i < R; i += K2_THREADS + 32)
    srow[i] = stage_row_g[(size_t)s * U + i];
  for (int q = tid; q < nq; q += K2_THREADS + 32) {
    st.ncand[q] = 0;
    st.filled[q] = 0;
    st.thr_s[q] = k > 0 ? 0.0f : CUDART_INF_F;
    st.thr_d[q] = INT_MIN;
  }
  for (int i = tid; i < nq * K2_NZ; i += K2_THREADS + 32) {
    const int q = i / K2_NZ, e = i % K2_NZ;
    const int n = nz_n_g[(size_t)(b0 + q) * S + s];
    if (e < n && n <= K2_NZ)
      nz_s[i] = nz_g[((size_t)(b0 + q) * S + s) * U + e];
  }
  // query q's list: in shared memory or its slice of the output
  auto list_s = [&](int q) {
    return kTopShared
               ? top_s + (size_t)q * k
               : part_vals + (((size_t)(b0 + q) * S + s) * n_tiles + tile) * k;
  };
  auto list_d = [&](int q) {
    return kTopShared
               ? top_d + (size_t)q * k
               : part_docs + (((size_t)(b0 + q) * S + s) * n_tiles + tile) * k;
  };

  // the ring's plan for R rows: passes a chunk, or row groups
  const int ngroups = R > 0 ? (R + rows_max - 1) / rows_max : 0;
  const int GR = ngroups ? (R + ngroups - 1) / ngroups : 0;
  int npass = 1;                                // a power of two
  while (ngroups == 1 && 2 * npass <= min(K2_MAX_PASSES, rows_max / R))
    npass *= 2;
  const int CH = K2_PASS * npass;
  const int doc_lo = tile * docs_per_tile;
  const int doc_hi = min(n_pad, doc_lo + docs_per_tile);
  const int nchunks = ngroups ? (doc_hi - doc_lo + CH - 1) / CH : 0;
  const int nsteps = nchunks * ngroups;
  const size_t slot_elems = (size_t)GR * CH;
  const size_t blk_id =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  __syncthreads();

  if (warp == K2_WARPS) {
    // the copying warp: step t's rows into slot t % K2_STAGES, once the
    // scoring warps are done with its last use
    for (int t = 0; t < nsteps; ++t) {
      const int slot_i = t % K2_STAGES;
      if (t >= K2_STAGES)
        k2_bar_wait(empty0 + 8 * slot_i, (t / K2_STAGES - 1) & 1);
      const int c = t / ngroups, g = t % ngroups;
      const int row0 = g * GR, nrows = min(R, row0 + GR) - row0;
      const int d0 = doc_lo + c * CH;
      const int len = min(CH, doc_hi - d0);           // docs of each row
      __nv_bfloat16* slot = ring + (size_t)slot_i * slot_elems;
      const unsigned full = full0 + 8 * slot_i;
      if (kBulk) {
        if (lane == 0) k2_bar_expect(full, (unsigned)(nrows * len * 2));
        __syncwarp();
        for (int r = lane; r < nrows; r += 32) {
          // a row's slice, split where it crosses a block of C docs
          for (int d = d0; d < d0 + len;) {
            const int blk = d / C, off = d - blk * C;
            const int n = min(d0 + len - d, C - off);
            k2_bulk(slot + (size_t)r * CH + (d - d0),
                    dense + ((((size_t)s * n_blk + blk) * T +
                              srow[row0 + r]) * C + off),
                    (unsigned)(n * 2), full);
            d += n;
          }
        }
      } else {
        for (int idx = lane; idx < nrows * (len >> 2); idx += 32) {
          const int r = idx / (len >> 2), pc = idx - r * (len >> 2);
          const int doc = d0 + 4 * pc;
          const int blk = doc / C, off = doc - blk * C;
          k2_cp8(slot + (size_t)r * CH + 4 * pc,
                 dense + ((((size_t)s * n_blk + blk) * T + srow[row0 + r]) *
                              C + off));
        }
        k2_cp_done(full);
      }
    }
    if (!kBulk) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // this warp's queries: q = warp + K2_WARPS * qi; their weights, k-th
  // keys and this lane's matched docs, in registers
  int qn[K2_QW], nm[K2_QW], tdq[K2_QW];
  float tsq[K2_QW];
  const K2Nz* zqs[K2_QW];
#pragma unroll
  for (int qi = 0; qi < K2_QW; ++qi) {
    const int q = warp + K2_WARPS * qi;
    qn[qi] = q < nq ? nz_n_g[(size_t)(b0 + q) * S + s] : 0;
    zqs[qi] = qn[qi] <= K2_NZ ? nz_s + (size_t)q * K2_NZ
                              : nz_g + ((size_t)(b0 + q) * S + s) * U;
    tsq[qi] = q < nq ? st.thr_s[q] : 0.0f;
    tdq[qi] = INT_MIN;
    nm[qi] = 0;
  }

  for (int t = 0; t < nsteps; ++t) {
    k2_bar_wait(full0 + 8 * (t % K2_STAGES), (t / K2_STAGES) & 1);
    const int c = t / ngroups, g = t % ngroups;
    const int row0 = g * GR, row1 = min(R, row0 + GR);
    const bool first = g == 0, last = g == ngroups - 1;
    const __nv_bfloat16* slot =
        ring + (size_t)(t % K2_STAGES) * slot_elems;
    const int cdoc = doc_lo + c * CH;                // the chunk's first doc
    const bool ragged = cdoc + CH > doc_hi;
    for (int pass = 0; pass < npass; ++pass) {
      const int col = pass * K2_PASS + lane * 4;     // doc in the chunk
      const int doc0 = cdoc + col;
#pragma unroll
      for (int qi = 0; qi < K2_QW; ++qi) {
        const int q = warp + K2_WARPS * qi;
        if (q >= nq) break;
        const int n = qn[qi];
        const K2Nz* zq = zqs[qi];
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int cn[4] = {0, 0, 0, 0};
        float4* cy = carry + ((size_t)blk_id * QB + q) * 64 + lane;
        int e = 0, e1 = n;
        if (ngroups > 1) {
          if (!first) {
            const float4 v = cy[0];
            a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
            if (kMsm) {
              const float4 u = cy[32];
              cn[0] = __float_as_int(u.x); cn[1] = __float_as_int(u.y);
              cn[2] = __float_as_int(u.z); cn[3] = __float_as_int(u.w);
            }
          }
          while (e < n && zq[e].j < row0) ++e;
          e1 = e;
          while (e1 < n && zq[e1].j < row1) ++e1;
        }
        // this group's weights, in column order
        for (; e < e1; ++e) {
          const K2Nz z = zq[e];
          const uint2 r = *reinterpret_cast<const uint2*>(
              slot + (size_t)(z.j - row0) * CH + col);
          const float v[4] = {__uint_as_float(r.x << 16),
                              __uint_as_float(r.x & 0xffff0000u),
                              __uint_as_float(r.y << 16),
                              __uint_as_float(r.y & 0xffff0000u)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j] = fmaf(z.w, v[j], a[j]);
            if (kMsm) cn[j] += (z.w > 0.0f) & (v[j] > 0.0f);
          }
        }
        if (!last) {
          cy[0] = make_float4(a[0], a[1], a[2], a[3]);
          if (kMsm)
            cy[32] = make_float4(__int_as_float(cn[0]), __int_as_float(cn[1]),
                                 __int_as_float(cn[2]),
                                 __int_as_float(cn[3]));
          continue;
        }
        // the tile's selection for these docs of query q: matched docs
        // (score > 0) counted, and a warp max of the scores' bits (a
        // positive float orders as its bits; an unmatched doc's 0, -0 or
        // below never passes a threshold >= 0) against the k-th key
        // decides whether any may beat it
        int mb = INT_MIN;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kMsm && cn[j] < msm) a[j] = -CUDART_INF_F;
          if (ragged && doc0 + j >= doc_hi) a[j] = -CUDART_INF_F;
          nm[qi] += a[j] > 0.0f;
          mb = max(mb, __float_as_int(a[j]));
        }
        mb = __reduce_max_sync(0xffffffffu, mb);
        const int tb = __float_as_int(tsq[qi]);
        if (mb > tb || (mb == tb && tdq[qi] > cdoc)) {
          // the matched docs that beat it, placed by a warp scan of the
          // lanes' counts
          unsigned bm = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (a[j] > 0.0f && k2_beats(a[j], doc0 + j, tsq[qi], tdq[qi]))
              bm |= 1u << j;
          const int cnt = __popc(bm);
          int incl = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
          }
          const int total = __shfl_sync(0xffffffffu, incl, 31);
          float* cs = cand_s + (size_t)q * K2_CAND;
          int* cd = cand_d + (size_t)q * K2_CAND;
          int nc = st.ncand[q];
          if (nc + total > K2_CAND) {
            // past the buffer's room: a ballot a doc of the lanes (at most
            // 32 pushes), the buffer merged first when they do not fit,
            // each doc tested against the threshold as it stands
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bool mine = ((bm >> j) & 1u) &&
                          k2_beats(a[j], doc0 + j, st.thr_s[q], st.thr_d[q]);
              unsigned m = __ballot_sync(0xffffffffu, mine);
              if (!m) continue;
              nc = st.ncand[q];
              if (nc + __popc(m) > K2_CAND) {
                k2_flush(st, q, cs, cd, list_s(q), list_d(q), k);
                nc = 0;
                mine = mine && k2_beats(a[j], doc0 + j, st.thr_s[q],
                                        st.thr_d[q]);
                m = __ballot_sync(0xffffffffu, mine);
              }
              if (mine) {
                const int at = nc + __popc(m & ((1u << lane) - 1u));
                cs[at] = a[j];
                cd[at] = doc0 + j;
              }
              __syncwarp();
              if (lane == 0) st.ncand[q] = nc + __popc(m);
              __syncwarp();
            }
            tsq[qi] = st.thr_s[q];
            tdq[qi] = st.thr_d[q];
          } else {
            int at = nc + incl - cnt;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if ((bm >> j) & 1u) {
                cs[at] = a[j];
                cd[at] = doc0 + j;
                ++at;
              }
            }
            __syncwarp();
            if (lane == 0) st.ncand[q] = nc + total;
            __syncwarp();
          }
        }
      }
    }
    // this warp is done with the slot
    __syncwarp();
    if (lane == 0) k2_bar_arrive(empty0 + 8 * (t % K2_STAGES));
  }
  // the tile's end: the last candidates, the lists, the counts
#pragma unroll
  for (int qi = 0; qi < K2_QW; ++qi) {
    const int q = warp + K2_WARPS * qi;
    if (q >= nq) break;
    float* ls = list_s(q);
    int* ld = list_d(q);
    if (st.ncand[q] > 0)
      k2_flush(st, q, cand_s + (size_t)q * K2_CAND,
               cand_d + (size_t)q * K2_CAND, ls, ld, k);
    const int f = st.filled[q];
    const size_t o = (((size_t)(b0 + q) * S + s) * n_tiles + tile) * k;
    for (int i = lane; i < k; i += 32) {
      const bool have = i < f;
      if (kTopShared || !have) {
        part_vals[o + i] = have ? ls[i] : -CUDART_INF_F;
        part_docs[o + i] = have ? ld[i] : n_pad;
      }
    }
    const int tot = __reduce_add_sync(0xffffffffu, nm[qi]);
    if (lane == 0 && tot)
      atomicAdd(&n_matched[(size_t)(b0 + q) * S + s], tot);
  }
}

// The tile kernel's arguments after the template's.
struct K2Args {
  const __nv_bfloat16* dense;
  const K2Nz* nz;
  const int *nz_n, *srow, *R;
  int B, S, U, n_blk, T, C, n_pad, k, msm, per, n_tiles, QB, rows_max;
  float* part_vals;
  int *part_docs, *n_matched;
  float4* carry;
};

template <bool kMsm, bool kTopShared, bool kBulk>
static int k2_launch(dim3 grid, size_t shm, cudaStream_t st,
                     const K2Args& a) {
  auto kernel = k2_tile_kernel<kMsm, kTopShared, kBulk>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  kernel<<<grid, K2_THREADS + 32, shm, st>>>(
      a.dense, a.nz, a.nz_n, a.srow, a.R, a.B, a.S, a.U, a.n_blk, a.T, a.C,
      a.n_pad, a.k, a.msm, a.per, a.n_tiles, a.QB, a.rows_max, a.part_vals,
      a.part_docs, a.n_matched, a.carry);
  return (int)cudaGetLastError();
}

template <bool kMsm>
static int k2_launch_msm(bool top_shared, bool bulk, dim3 grid, size_t shm,
                         cudaStream_t st, const K2Args& a) {
  if (top_shared)
    return bulk ? k2_launch<kMsm, true, true>(grid, shm, st, a)
                : k2_launch<kMsm, true, false>(grid, shm, st, a);
  return bulk ? k2_launch<kMsm, false, true>(grid, shm, st, a)
              : k2_launch<kMsm, false, false>(grid, shm, st, a);
}

// Bytes of the workspace's sections: the compacted weights [B * S][U],
// their counts [B * S], the staged rows [S][U], R [S], and, when U rows
// may pass one group of the ring (U > rows_max), each block's sums
// between groups (QB x 1 KB a block).
static size_t k2_ws_section(int i, int B, int S, int U, int n_tiles, int QB,
                            int rows_max) {
  const size_t groups = (size_t)(B + QB - 1) / QB;
  const size_t sizes[5] = {
      k2_align((size_t)B * S * U * 8), k2_align((size_t)B * S * 4),
      k2_align((size_t)S * U * 4), k2_align((size_t)S * 4),
      U > rows_max ? (size_t)n_tiles * S * groups * QB * 1024 : 0};
  return sizes[i];
}

// W f32[B, S, U], dense bf16[S, n_blk, T, C] (8-byte aligned, C % 4 == 0),
// u_ids i32[S, U] or null (U == T); the plan (ops/tiered_bm25.py:
// dense_stream_topk_plan): docs_per_tile (a multiple of 1,024), n_tiles,
// QB queries a block (<= K2_QUERIES), top_shared, rows_max (rows the ring
// holds at one pass); the workspace of workspace_bytes, refused when its
// sections (k2_ws_section) need more. n_matched must be zero on entry.
extern "C" int es_dense_stream_topk(
    const float* W, const void* dense, const int* u_ids, int B, int S,
    int U, int n_blk, int T, int C, int n_pad, int k, int msm,
    int docs_per_tile, int n_tiles, int QB, int top_shared, int rows_max,
    float* part_vals, int* part_docs, int* n_matched, void* workspace,
    long long workspace_bytes, void* stream) {
  if (QB < 1 || QB > K2_QUERIES || rows_max < 1 || docs_per_tile % 1024 ||
      C % 4 || ((uintptr_t)dense & 7) || k < 0)
    return ES_ERR_SIZE;
  size_t need = 0;
  for (int i = 0; i < 5; ++i)
    need += k2_ws_section(i, B, S, U, n_tiles, QB, rows_max);
  if ((long long)need > workspace_bytes) return ES_ERR_SIZE;
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  char* sec[5];
  sec[0] = (char*)workspace;
  for (int i = 1; i < 5; ++i)
    sec[i] = sec[i - 1] + k2_ws_section(i - 1, B, S, U, n_tiles, QB,
                                        rows_max);
  K2Nz* nz = (K2Nz*)sec[0];
  int *nz_n = (int*)sec[1], *srow = (int*)sec[2], *R = (int*)sec[3];
  const size_t prep_shm = (size_t)U * 4;
  int e = es_set_shared(k2_prep_kernel, prep_shm);
  if (e != 0) return e;
  k2_prep_kernel<<<S, K2_PREP_THREADS, prep_shm, st>>>(W, u_ids, B, S, U, nz,
                                                       nz_n, srow, R);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const K2Args a{(const __nv_bfloat16*)dense, nz, nz_n, srow, R, B, S, U,
                 n_blk, T, C, n_pad, k, msm, docs_per_tile, n_tiles, QB,
                 rows_max, part_vals, part_docs, n_matched,
                 U > rows_max ? (float4*)sec[4] : nullptr};
  const size_t shm = k2_shared_bytes(QB, U, k, top_shared, rows_max);
  const dim3 grid(n_tiles, S, (B + QB - 1) / QB);
  const bool bulk = C % 8 == 0 && ((uintptr_t)dense & 15) == 0;
  return msm > 1 ? k2_launch_msm<true>(top_shared, bulk, grid, shm, st, a)
                 : k2_launch_msm<false>(top_shared, bulk, grid, shm, st, a);
}
