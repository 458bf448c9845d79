// K2: dense-tier scoring + per-tile top-k for a batch of queries.
//
// Replaces elasticsearch_tpu/ops/tiered_bm25.py:dense_stream_topk (the
// lax.scan over [n_blk, T, C] bf16 blocks of W[B, T] @ f32(block) with a
// running top-k), together with the step's used-row gather
// (parallel/dist_search.py:build_tiered_bm25_step, jnp.take over u_ids):
// rows are read in place through u_ids, never copied.
//
// Grid: (batch tile of bt <= 16 queries, doc tile, shard); the launcher
// takes the largest bt whose tables fit the card's shared memory, and keeps
// the running top-k lists there too when they fit, else in the block's own
// slice of the partial output in device memory. Each thread owns 4
// consecutive docs per 1024-doc chunk and reads their bf16 values of a row
// as one 8-byte load, coalesced along C. The reference's product is f32 over
// all T rows; a query's weight row W[b, :] has at most Q non-zeros, so the
// block first compacts each query's non-zero (row, weight) pairs into
// shared memory and sums only those, in ascending row order, in f32 (an
// exact zero product adds nothing, so this equals the full product summed
// in row order; the reference's own order is XLA's, hence a stated rtol).
// No bf16 or TF32 tensor-core shortcut: the reference product is f32.
// Then the s > 0 mask (and the min_should_match count when msm > 1), the
// matched count, and a block-wide running top-k per query keyed
// (score desc, doc asc). Each block writes its tile's k best per query;
// K3 (topk_merge.cu) reduces the tiles.
//
// Bound: the card's memory rate. The function must read each dense row the
// batch uses once (n_pad bf16 values per row); the f32 work is 2 flops per
// non-zero weight per doc, far below the FP32 rate. Rows shared by queries
// of one tile are re-read from L1/L2, not from device memory.

#include "topk_common.cuh"

#define K2_THREADS 256
#define K2_DPT 4
#define K2_CHUNK (K2_THREADS * K2_DPT)
#define K2_BT_MAX 16

// kTopShared: the running top-k lists sit in shared memory (a template
// argument, so the compiler addresses them as shared)
template <bool kTopShared>
__global__ void __launch_bounds__(K2_THREADS)
dense_stream_topk_kernel(
    const float* __restrict__ W, const __nv_bfloat16* __restrict__ dense,
    const int* __restrict__ u_ids, int B, int S, int U, int n_blk, int T,
    int C, int n_pad, int k, int msm, int docs_per_tile, int n_tiles,
    int bt, float* __restrict__ part_vals,
    int* __restrict__ part_docs, int* __restrict__ n_matched) {
  extern __shared__ unsigned char smem[];
  float* buf_s = reinterpret_cast<float*>(smem);               // [CHUNK]
  int* buf_d = reinterpret_cast<int*>(buf_s + K2_CHUNK);       // [CHUNK]
  int* nz_row = buf_d + K2_CHUNK;                              // [bt][U]
  float* nz_w = reinterpret_cast<float*>(nz_row + bt * U);     // [bt][U]
  float* top_sh = nz_w + bt * U;                               // [bt][k]
  int* top_dh = reinterpret_cast<int*>(top_sh + bt * k);       // [bt][k]

  __shared__ int nz_n[K2_BT_MAX], filled[K2_BT_MAX], match[K2_BT_MAX],
      ncand[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * bt;
  const int tile = blockIdx.y;
  const int s = blockIdx.z;
  const int nb = min(bt, B - b0);
  // query bi's running top-k: in shared memory, or in its partial output
  auto top_of = [&](int bi) {
    const size_t o = (((size_t)(b0 + bi) * S + s) * n_tiles + tile) * k;
    return kTopShared
               ? RunningTopK{top_sh + bi * k, top_dh + bi * k, &filled[bi], k}
               : RunningTopK{part_vals + o, part_docs + o, &filled[bi], k};
  };

  // compact each query's non-zero weights: warp w takes queries w, w+8
  for (int bi = warp; bi < bt; bi += K2_THREADS / 32) {
    int n = 0;
    if (bi < nb) {
      const float* wrow = W + ((size_t)(b0 + bi) * S + s) * U;
      for (int u0 = 0; u0 < U; u0 += 32) {
        int u = u0 + lane;
        float w = u < U ? wrow[u] : 0.0f;
        unsigned m = __ballot_sync(0xffffffffu, w != 0.0f);
        if (w != 0.0f) {
          int pos = n + __popc(m & ((1u << lane) - 1u));
          nz_row[bi * U + pos] =
              u_ids != nullptr ? u_ids[(size_t)s * U + u] : u;
          nz_w[bi * U + pos] = w;
        }
        n += __popc(m);
      }
    }
    if (lane == 0) {
      nz_n[bi] = n;
      filled[bi] = 0;
      match[bi] = 0;
    }
  }
  if (tid == 0) ncand[0] = 0;
  __syncthreads();

  CandBuffer cand{buf_s, buf_d, ncand};
  const size_t rows_s = (size_t)s * n_blk * T;
  const int doc_lo = tile * docs_per_tile;
  const int doc_hi = min(n_pad, doc_lo + docs_per_tile);
  int round = 0;
  for (int c0 = doc_lo; c0 < doc_hi; c0 += K2_CHUNK) {
    const int doc0 = c0 + tid * K2_DPT;
    const bool in = doc0 < doc_hi;     // n_pad and tiles are multiples of 4
    const int blk = doc0 / C;
    const int off = doc0 % C;
    for (int bi = 0; bi < nb; ++bi, ++round) {
      cand.reset_next(round);
      float acc[K2_DPT] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cnt[K2_DPT] = {0, 0, 0, 0};
      if (in) {
        const int n = nz_n[bi];
        for (int i = 0; i < n; ++i) {
          const int row = nz_row[bi * U + i];
          const float w = nz_w[bi * U + i];
          const uint2 raw = *reinterpret_cast<const uint2*>(
              dense + ((rows_s + (size_t)blk * T + row) * C + off));
          const __nv_bfloat162 lo =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          const float r[K2_DPT] = {__low2float(lo), __high2float(lo),
                                   __low2float(hi), __high2float(hi)};
#pragma unroll
          for (int j = 0; j < K2_DPT; ++j) {
            acc[j] = fmaf(w, r[j], acc[j]);
            cnt[j] += (w > 0.0f) & (r[j] > 0.0f);
          }
        }
      }
      int nm = 0;
      RunningTopK top = top_of(bi);
#pragma unroll
      for (int j = 0; j < K2_DPT; ++j) {
        float sc = acc[j];
        if (msm > 1 && cnt[j] < msm) sc = -CUDART_INF_F;
        if (!(sc > 0.0f)) sc = -CUDART_INF_F;
        if (in && sc > -CUDART_INF_F) {
          ++nm;
          if (top.beats(sc, doc0 + j)) cand.push(round, sc, doc0 + j);
        }
      }
      nm = __reduce_add_sync(0xffffffffu, nm);
      if (lane == 0 && nm) atomicAdd(&match[bi], nm);
      cand.flush(round, top);
    }
  }
  __syncthreads();
  for (int bi = 0; bi < nb; ++bi) {
    const size_t o = (((size_t)(b0 + bi) * S + s) * n_tiles + tile) * k;
    top_of(bi).write(part_vals + o, part_docs + o, n_pad);
    if (tid == 0 && match[bi])
      atomicAdd(&n_matched[(size_t)(b0 + bi) * S + s], match[bi]);
  }
}

extern "C" int es_dense_stream_topk(
    const float* W, const void* dense, const int* u_ids, int B, int S,
    int U, int n_blk, int T, int C, int n_pad, int k, int msm,
    int docs_per_tile, int n_tiles, float* part_vals, int* part_docs,
    int* n_matched, void* stream) {
  const size_t max_shm = (size_t)es_max_shared_bytes();
  const size_t base = (size_t)K2_CHUNK * 8;
  int bt = K2_BT_MAX;
  while (bt > 1 && base + (size_t)bt * U * 8 > max_shm) bt >>= 1;
  size_t shm = base + (size_t)bt * U * 8;
  const bool top_shared = shm + (size_t)bt * k * 8 <= max_shm;
  if (top_shared) shm += (size_t)bt * k * 8;
  auto kernel = top_shared ? dense_stream_topk_kernel<true>
                           : dense_stream_topk_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  dim3 grid((B + bt - 1) / bt, n_tiles, S);
  kernel<<<grid, K2_THREADS, shm, (cudaStream_t)stream>>>(
      W, (const __nv_bfloat16*)dense, u_ids, B, S, U, n_blk, T, C, n_pad, k,
      msm, docs_per_tile, n_tiles, bt, part_vals, part_docs, n_matched);
  return (int)cudaGetLastError();
}
