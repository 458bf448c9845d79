// K6: the exact kNN scan: every (query, shard, chunk of rows)'s k best rows.
//
// Replaces elasticsearch_tpu/parallel/dist_search.py:_knn_shard_scan (the
// [B,D] x [block,D]^T products streamed over the corpus with a lax.scan
// carried running top-k) under build_knn_step. Scores are q . v, or for l2
// (2 q.v - |v|^2) - |q|^2 with |v|^2 the pack-time row and |q|^2 of the raw
// query, -inf where the row does not exist; the lists are ordered (score
// desc, row asc), lax.top_k's order over the row-ascending scan. K3
// (topk_merge.cu) reduces the chunks' lists, then the shards'.
//
// Each dot product is one chain of f32 FMAs in ascending d, starting from
// 0, in one thread: no tensor-core, TF32 or split-d shortcut (the reference
// product is f32). A row's score thus never depends on where the row lies:
// a duplicate row ties bitwise, and K8 (ivf_rerank.cu), which sums the same
// chain, gives a row the same bits as this scan.
//
// Bound: the card's memory rate while the batch is below about 40 queries.
// One batch reads each existing row once (D f32 values, |v|^2 for l2) and
// the exists flags, and does 2 B D operations a row: at B = 16 the f32
// products take about 40 % of the bytes' time. Reaching that rate needs
// tens of KB of loads in flight on every SM, and a shared-memory diet
// that keeps the FMA pipes busy: one 16-byte load in flight a thread
// behind a barrier leaves the SM waiting on device memory, and reading 32
// distinct rows a warp instruction makes shared memory, not the FMAs, the
// limit.
//
// Design:
// - a block's rows stream through a ring of nst stages of KS_ROWS rows x
//   dc d values (32 or 64), filled by cp.async 16-byte copies (4-byte
//   where a row is not 16-byte aligned): while the FMAs run on stage g,
//   the copies of stages g + 1 .. g + nst - 1 are in flight, and a tile's
//   epilogue and list merge overlap the next tile's copies. The plan
//   (k6_plan) picks dc, nst and so the blocks an SM from what shared
//   memory holds beside the queries and the lists;
// - the block's query tile (up to KS_BT queries, all of D) is loaded once;
//   past what shared memory holds the tile shrinks (more query tiles, each
//   re-reading the rows, from L2 where it can);
// - each thread keeps 2 rows x 4 queries of accumulators, and a warp's
//   lanes cover 16 rows x 16 queries (lane & 7 picks rows, lane >> 3 a
//   group of 4 queries): a 16-byte read of the stage is 8 rows, each
//   broadcast to 4 lanes, and one of the queries 4 queries, each broadcast
//   to 8 lanes, one wavefront each. Rows sit dc + 4 floats (an odd number
//   of float4s) apart and each group of 4 queries 4 floats past the last,
//   so neither read has a bank conflict;
// - a block first marks which of its tiles (chunk, chunk + gridDim.x, ...)
//   hold an existing row (up to K6_BM_WORDS x 32 tiles; later tiles count
//   as live), so padding tiles read nothing; within a live tile every row
//   is copied and a missing one is not offered to the lists. A tile's
//   exists flags (and |v|^2) are loaded when its first stage is issued and
//   kept in a ring of their own until its epilogue.
//
// The lists are knn_common.cuh's QueryLists. The host
// sizes the grid from es_knn_scan_blocks_per_sm (ops/knn.py:scan_chunks).

#include <stdint.h>

#include "knn_common.cuh"

#define K6_NST_MAX 8      // stages of the row ring, at most
#define K6_BM_WORDS 128   // the live-tile bitmap: 4096 tiles a block

// A stage holds kDC d values of a row (32 or 64); rows sit kDC + 4 floats
// apart, an odd number of float4s.
template <int kDC>
struct K6Stage {
  static constexpr int kRS = kDC + 4;
};

__device__ __forceinline__ void k6_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void k6_cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void k6_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void k6_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n of this thread's copy groups are pending.
__device__ __forceinline__ void k6_wait_n(int n) {
  switch (n) {
    case 1: k6_wait<1>(); break;
    case 2: k6_wait<2>(); break;
    case 3: k6_wait<3>(); break;
    case 4: k6_wait<4>(); break;
    case 5: k6_wait<5>(); break;
    case 6: k6_wait<6>(); break;
    default: k6_wait<0>(); break;
  }
}

// Offset in floats of query q's values in the query tile: rows dq apart
// (dq a multiple of 8), each group of 4 queries shifted 4 floats more.
__device__ __host__ __forceinline__ int k6_qoff(int q, int dq) {
  return q * dq + (q >> 2) * 4;
}

// acc[i][j] += row (r + 8 i) . query j over d0 .. d0 + dlen - 1 of one
// stage, one FMA a d in ascending d; query j's values start at
// q_s + qoff[j]. kFull: a whole stage (dlen = kDC), unrolled.
template <int kDC, bool kFull>
__device__ __forceinline__ void k6_stage_dot(const float* rows,
                                             const float* q_s,
                                             const int qoff[4], int d0,
                                             int dlen, int r,
                                             float acc[2][4]) {
  constexpr int kRS = K6Stage<kDC>::kRS;
  const float* r0p = rows + r * kRS;
  const float* r1p = r0p + 8 * kRS;
  const int d4 = kFull ? kDC : dlen & ~3;
#pragma unroll
  for (int c = 0; c < d4; c += 4) {
    const float4 r0 = *reinterpret_cast<const float4*>(r0p + c);
    const float4 r1 = *reinterpret_cast<const float4*>(r1p + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 qv =
          *reinterpret_cast<const float4*>(q_s + qoff[j] + d0 + c);
      acc[0][j] = fmaf(r0.x, qv.x, acc[0][j]);
      acc[0][j] = fmaf(r0.y, qv.y, acc[0][j]);
      acc[0][j] = fmaf(r0.z, qv.z, acc[0][j]);
      acc[0][j] = fmaf(r0.w, qv.w, acc[0][j]);
      acc[1][j] = fmaf(r1.x, qv.x, acc[1][j]);
      acc[1][j] = fmaf(r1.y, qv.y, acc[1][j]);
      acc[1][j] = fmaf(r1.z, qv.z, acc[1][j]);
      acc[1][j] = fmaf(r1.w, qv.w, acc[1][j]);
    }
  }
  for (int c = d4; !kFull && c < dlen; ++c) {
    const float x0 = r0p[c], x1 = r1p[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float qv = q_s[qoff[j] + d0 + c];
      acc[0][j] = fmaf(x0, qv, acc[0][j]);
      acc[1][j] = fmaf(x1, qv, acc[1][j]);
    }
  }
}

template <bool kShared, bool kVec4, int kDC>
__global__ void __launch_bounds__(KS_THREADS, 2)
knn_scan_kernel(const float* __restrict__ vecs, const float* __restrict__ vn,
                const bool* __restrict__ exists,
                const float* __restrict__ qq, const float* __restrict__ qn,
                int B, int S, int n_pad, int D, int k, int l2, int bt, int dq,
                int nst, float* __restrict__ part_vals,
                int* __restrict__ part_rows, float* ws_vals, int* ws_rows) {
  constexpr int kRS = K6Stage<kDC>::kRS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);       // [nst][ROWS][kRS]
  float* q_s = ring + nst * KS_ROWS * kRS;              // k6_qoff
  float* c_v = q_s + k6_qoff(bt, dq);                   // [bt][ROWS]
  int* c_i = reinterpret_cast<int*>(c_v + bt * KS_ROWS);
  unsigned char* lists = reinterpret_cast<unsigned char*>(c_i + bt * KS_ROWS);

  __shared__ int filled[KS_BT], ncand[KS_BT], thr_id[KS_BT];
  __shared__ float thr_v[KS_BT], qn_s[KS_BT];
  __shared__ bool ex_ring[K6_NST_MAX][KS_ROWS];
  __shared__ float vn_ring[K6_NST_MAX][KS_ROWS];
  __shared__ unsigned live_bm[K6_BM_WORDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.z * bt;
  const int nb = min(bt, B - b0);
  const size_t ostride = (size_t)S * n_chunks * k;
  const size_t out0 = ((size_t)b0 * S + s) * n_chunks * k + (size_t)chunk * k;
  QueryLists L = ks_lists(kShared, lists, part_vals + out0, part_rows + out0,
                          ws_vals + out0, ws_rows + out0, ostride, c_v, c_i,
                          filled, ncand, thr_v, thr_id, k, bt);
  if (tid < KS_BT) {
    filled[tid] = 0;
    ncand[tid] = 0;
    qn_s[tid] = (tid < nb && l2) ? qn[b0 + tid] : 0.0f;
  }
  for (int w = tid; w < K6_BM_WORDS; w += KS_THREADS) live_bm[w] = 0u;
  // the query tile, once: zero past the batch and past D
  for (int e = tid; e < bt * dq; e += KS_THREADS) {
    const int q = e / dq, d = e - q * dq;
    q_s[k6_qoff(q, dq) + d] =
        (q < nb && d < D) ? qq[(size_t)(b0 + q) * D + d] : 0.0f;
  }
  __syncthreads();

  const size_t base = (size_t)s * n_pad;
  const int n_tiles = (n_pad + KS_ROWS - 1) / KS_ROWS;
  const int n_mine =
      chunk < n_tiles ? (n_tiles - 1 - chunk) / n_chunks + 1 : 0;
  const int n_bm = min(n_mine, K6_BM_WORDS * 32);
  auto tile_row0 = [&](int j) {
    return ((long long)chunk + (long long)j * n_chunks) * KS_ROWS;
  };
  // which of my tiles hold an existing row: a warp checks four tiles at a
  // time, four flags a lane
  for (int j0 = warp * 4; j0 < n_bm; j0 += (KS_THREADS / 32) * 4) {
    bool e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      e[u] = false;
      if (j0 + u < n_bm) {
        const long long r0 = tile_row0(j0 + u) + lane * 4;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          e[u] = e[u] || (r0 + v < n_pad && exists[base + r0 + v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned any = __ballot_sync(0xffffffffu, e[u]);
      if (lane == 0 && any != 0u)
        atomicOr(&live_bm[(j0 + u) >> 5], 1u << ((j0 + u) & 31));
    }
  }
  __syncthreads();
  // the first of my tiles from j on that may hold an existing row (past
  // the bitmap, every tile); n_mine or more when none is left
  auto next_live = [&](int j) {
    while (j < n_bm) {
      const unsigned w = live_bm[j >> 5] >> (j & 31);
      if (w != 0u) return j + __ffs(w) - 1;
      j = (j | 31) + 1;
    }
    return j;
  };

  // ---- the producer side: the next stage's copies ------------------------
  const int nch = (D + kDC - 1) / kDC;
  int ij = next_live(0), ic = 0, islot = 0, itslot = 0;
  bool pend = false, pend_ex = false;
  float pend_vn = 0.0f;
  int pend_slot = 0;
  // Issues the stage at (tile ij, chunk ic) into ring slot islot, or an
  // empty group past the last tile. A tile's flags and |v|^2, loaded with
  // its first stage, land in their ring at the next issue: by then the
  // loads have returned, and the tile's epilogue is a barrier later.
  auto issue = [&]() {
    if (pend) {
      ex_ring[pend_slot][tid] = pend_ex;
      vn_ring[pend_slot][tid] = pend_vn;
      pend = false;
    }
    if (ij < n_mine) {
      const long long row0 = tile_row0(ij);
      const int d0 = ic * kDC, dlen = min(kDC, D - d0);
      const int rows = (int)min((long long)KS_ROWS, n_pad - row0);
      float* dst = ring + islot * (KS_ROWS * kRS);
      const float* src = vecs + (base + row0) * D + d0;
      if (kVec4 && dlen == kDC) {
        // a whole stage: 16-byte piece tid % n4 of rows tid / n4 + m
        // KS_THREADS / n4, n4 = kDC / 4 pieces a row
        constexpr int n4 = kDC / 4;
        const int c = (tid % n4) * 4;
#pragma unroll
        for (int m = 0; m < KS_ROWS * n4 / KS_THREADS; ++m) {
          const int r = tid / n4 + m * (KS_THREADS / n4);
          if (r < rows)
            k6_cp16(dst + r * kRS + c, src + (size_t)r * D + c);
        }
      } else if (kVec4) {
        const int per = dlen >> 2;
        for (int e = tid; e < KS_ROWS * per; e += KS_THREADS) {
          const int r = e / per, c = (e - r * per) * 4;
          if (r < rows)
            k6_cp16(dst + r * kRS + c, src + (size_t)r * D + c);
        }
      } else {
        for (int e = tid; e < KS_ROWS * dlen; e += KS_THREADS) {
          const int r = e / dlen, c = e - r * dlen;
          if (r < rows)
            k6_cp4(dst + r * kRS + c, src + (size_t)r * D + c);
        }
      }
      if (ic == 0 && tid < KS_ROWS) {
        const long long row = row0 + tid;
        pend_ex = row < n_pad && exists[base + row];
        pend_vn = (l2 && pend_ex) ? vn[base + row] : 0.0f;
        pend_slot = itslot;
        pend = true;
      }
      if (++ic == nch) {
        ic = 0;
        ij = next_live(ij + 1);
        itslot = itslot + 1 == nst ? 0 : itslot + 1;
      }
    }
    k6_commit();
    islot = islot + 1 == nst ? 0 : islot + 1;
  };

  // ---- the consumer side -----------------------------------------------
  for (int p = 0; p < nst - 1; ++p) issue();
  // this thread's rows r0 and r0 + 8 of a tile, its queries 4 qg .. 4 qg + 3
  const int r0 = warp * 16 + (lane & 7), qg = lane >> 3;
  int qoff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) qoff[j] = k6_qoff(min(qg * 4 + j, bt - 1), dq);
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  int cj = next_live(0), cc = 0, cslot = 0, ctslot = 0;
  while (cj < n_mine) {
    // stage (cj, cc) has landed, and every thread is done with the slot
    // the issue below refills
    k6_wait_n(nst - 2);
    __syncthreads();
    issue();
    const int d0 = cc * kDC, dlen = min(kDC, D - d0);
    const float* rows = ring + cslot * (KS_ROWS * kRS);
    if (dlen == kDC)
      k6_stage_dot<kDC, true>(rows, q_s, qoff, d0, dlen, r0, acc);
    else
      k6_stage_dot<kDC, false>(rows, q_s, qoff, d0, dlen, r0, acc);
    cslot = cslot + 1 == nst ? 0 : cslot + 1;
    if (++cc < nch) continue;
    const int row0 = (int)tile_row0(cj);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const bool live = ex_ring[ctslot][r];
      const float vnr = vn_ring[ctslot][r];
      const int row = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = qg * 4 + j;
        float sc = acc[i][j];
        if (l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vnr), qn_s[q]);
        L.push(q, live && q < nb && L.beats(q, sc, row), sc, row);
        acc[i][j] = 0.0f;
      }
    }
    __syncthreads();
    L.merge();
    cc = 0;
    cj = next_live(cj + 1);
    ctslot = ctslot + 1 == nst ? 0 : ctslot + 1;
  }
  k6_wait<0>();
  __syncthreads();
  for (int q = 0; q < nb; ++q)
    L.write(q, part_vals + out0 + q * ostride, part_rows + out0 + q * ostride,
            n_pad, !kShared);
}

typedef decltype(&knn_scan_kernel<true, true, 32>) K6Kernel;

static K6Kernel k6_kernel(bool shared, bool vec4, int dc) {
  if (dc == 64) {
    if (shared)
      return vec4 ? knn_scan_kernel<true, true, 64>
                  : knn_scan_kernel<true, false, 64>;
    return vec4 ? knn_scan_kernel<false, true, 64>
                : knn_scan_kernel<false, false, 64>;
  }
  if (shared)
    return vec4 ? knn_scan_kernel<true, true, 32>
                : knn_scan_kernel<true, false, 32>;
  return vec4 ? knn_scan_kernel<false, true, 32>
              : knn_scan_kernel<false, false, 32>;
}

// Dynamic shared memory of a block without its lists: the row ring of
// nst stages of dc values, the query tile (k6_qoff) and the candidate
// buffers.
static size_t k6_base_bytes(int nst, int dc, int bt, int dq) {
  return (size_t)nst * KS_ROWS * (dc + 4) * 4 +
         (size_t)k6_qoff(bt, dq) * 4 + (size_t)bt * KS_ROWS * 8;
}

// Shared memory of one SM.
static size_t k6_sm_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  return (size_t)bytes;
}

// A launch's plan: the query tile (the largest up to KS_BT whose queries
// fit beside a ring of 3 stages of 32 values), the stage width dc and the
// ring's stages nst, whether the lists fit beside them, the dynamic shared
// memory and the blocks an SM holds (two at most: __launch_bounds__). Of
// the rings that fit: lists in shared memory first, then the most blocks
// an SM (one block's list merges overlap another's products), then the
// wider stage (fewer barriers a row), then the deepest ring. False when
// not even one query fits.
struct K6Plan {
  int bt, dq, dc, nst, per_sm;
  bool shared;
  size_t shm;
};

static bool k6_plan(int B, int D, int k, K6Plan* p) {
  const size_t stat =
      es_static_shared_bytes(knn_scan_kernel<true, true, 32>);
  const size_t room = (size_t)es_max_shared_bytes() - stat;
  p->dq = (D + 7) / 8 * 8;
  int bt = B < KS_BT ? B : KS_BT;
  if (bt < 1) bt = 1;
  while (bt > 1 && k6_base_bytes(3, 32, bt, p->dq) > room) bt = (bt + 1) / 2;
  if (k6_base_bytes(3, 32, bt, p->dq) > room) return false;
  p->bt = bt;
  int best = -1;  // shared lists, then blocks an SM, then dc, then stages
  for (int dc = 32; dc <= 64; dc += 32) {
    for (int nst = 3; nst <= K6_NST_MAX; ++nst) {
      const size_t base = k6_base_bytes(nst, dc, bt, p->dq);
      if (base > room) break;
      const bool shared = base + ks_list_bytes(bt, k) <= room;
      const size_t shm = base + (shared ? ks_list_bytes(bt, k) : 0);
      // the runtime keeps 1 KB of an SM's shared memory for each block
      size_t per_sm = k6_sm_bytes() / (shm + stat + 1024);
      if (per_sm > 2) per_sm = 2;
      if (per_sm < 1) per_sm = 1;
      const int score =
          (shared ? 1000 : 0) + 100 * (int)per_sm + dc + nst;
      if (score > best) {
        best = score;
        p->dc = dc;
        p->nst = nst;
        p->per_sm = (int)per_sm;
        p->shared = shared;
        p->shm = shm;
      }
    }
  }
  return true;
}

// Workspace bytes of a launch: 0 when the lists fit shared memory.
extern "C" long long es_knn_scan_workspace_bytes(int B, int S, int n_chunks,
                                                 int k, int D) {
  K6Plan p;
  if (!k6_plan(B, D, k, &p) || p.shared) return 0;
  return (long long)B * S * n_chunks * k * 8;
}

// Blocks of a launch that one SM holds at once (0 when none fits).
extern "C" int es_knn_scan_blocks_per_sm(int B, int D, int k) {
  K6Plan p;
  return k6_plan(B, D, k, &p) ? p.per_sm : 0;
}

// The ring of a launch: its stages x 100 + the d values a stage holds (0
// when none fits).
extern "C" int es_knn_scan_ring(int B, int D, int k) {
  K6Plan p;
  return k6_plan(B, D, k, &p) ? p.nst * 100 + p.dc : 0;
}

extern "C" int es_knn_scan(const float* vecs, const float* vn,
                           const void* exists, const float* qq,
                           const float* qn, int B, int S, int n_pad, int D,
                           int k, int l2, int n_chunks, float* part_vals,
                           int* part_rows, float* ws, void* stream) {
  K6Plan p;
  if (!k6_plan(B, D, k, &p)) return ES_ERR_SHARED;
  if (!p.shared && ws == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec4 = D % 4 == 0 && ((uintptr_t)vecs & 15) == 0;
  const K6Kernel kernel = k6_kernel(p.shared, vec4, p.dc);
  const int e = es_set_shared(kernel, p.shm);
  if (e != 0) return e;
  const size_t n_ws = (size_t)B * S * n_chunks * k;
  dim3 grid(n_chunks, S, (B + p.bt - 1) / p.bt);
  kernel<<<grid, KS_THREADS, p.shm, (cudaStream_t)stream>>>(
      vecs, vn, (const bool*)exists, qq, qn, B, S, n_pad, D, k, l2, p.bt,
      p.dq, p.nst, part_vals, part_rows, ws,
      ws == nullptr ? nullptr : (int*)(ws + n_ws));
  return (int)cudaGetLastError();
}
