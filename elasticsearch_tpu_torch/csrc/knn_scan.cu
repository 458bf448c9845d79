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
// Grid: (chunk, shard, query tile of up to KS_BT queries). A block takes the
// shard's tiles of KS_ROWS rows chunk, chunk + gridDim.x, ..., so padding
// tiles spread over all blocks; a tile whose rows all lack `exists` reads
// no vectors (its flags are read one tile ahead), and within a tile a
// missing row reads none. The rows pass through shared memory with
// coalesced 16-byte loads, a row of up to 128 values in one load phase
// (knn_common.cuh); each dot product is a chain of f32 FMAs in ascending d,
// with no tensor-core or TF32 shortcut (the reference product is f32).
//
// Bound: the card's memory rate while the batch is below about 40 queries.
// One batch reads each existing row once (D f32 values, |v|^2 for l2) and
// the exists flags; it does 2 B D operations a row. Each query tile re-reads
// the rows, from L2 when it can.

#include <stdint.h>

#include "knn_common.cuh"

template <bool kShared>
__global__ void __launch_bounds__(KS_THREADS)
knn_scan_kernel(const float* __restrict__ vecs, const float* __restrict__ vn,
                const bool* __restrict__ exists,
                const float* __restrict__ qq, const float* __restrict__ qn,
                int B, int S, int n_pad, int D, int k, int l2, int bt,
                int dc, int rs, int vec4, float* __restrict__ part_vals,
                int* __restrict__ part_rows, float* ws_vals, int* ws_rows) {
  extern __shared__ float4 smem4[];
  float* rows_s = reinterpret_cast<float*>(smem4);       // [ROWS][rs]
  float* q_s = rows_s + KS_ROWS * rs;                    // [BT][dc]
  float* c_v = q_s + KS_BT * dc;                         // [bt][ROWS]
  int* c_i = reinterpret_cast<int*>(c_v + bt * KS_ROWS);
  unsigned char* lists = reinterpret_cast<unsigned char*>(c_i + bt * KS_ROWS);

  __shared__ int filled[KS_BT], ncand[KS_BT], thr_id[KS_BT];
  __shared__ float thr_v[KS_BT], qn_s[KS_BT];
  __shared__ unsigned char ex_s[KS_ROWS];

  const int tid = threadIdx.x;
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
  // a row of up to dc values: the queries are loaded once
  if (D <= dc) ks_load_queries(q_s, qq, b0, nb, D, 0, dc);
  __syncthreads();

  const int rr = tid & 63, qg = tid >> 6;
  const int dc4 = dc / 4;
  const size_t base = (size_t)s * n_pad;
  const int n_tiles = (n_pad + KS_ROWS - 1) / KS_ROWS;
  // a tile's exists flag is read one tile ahead, behind the current work
  auto exists_at = [&](int tile) {
    const int row = tile * KS_ROWS + tid;
    return tid < KS_ROWS && tile < n_tiles && row < n_pad &&
           exists[base + row];
  };
  int ex_next = exists_at(chunk);
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int row0 = tile * KS_ROWS;
    const int ex = ex_next;
    if (tid < KS_ROWS) ex_s[tid] = ex;
    ex_next = exists_at(tile + n_chunks);
    if (!__syncthreads_or(ex)) continue;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int d0 = 0; d0 < D; d0 += dc) {
      for (int e = tid; e < KS_ROWS * dc4; e += KS_THREADS) {
        const int r = e / dc4, c = (e - r * dc4) * 4, d = d0 + c;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ex_s[r] && d < D) {
          const float* src = vecs + (base + row0 + r) * D + d;
          if (vec4) {
            x = *reinterpret_cast<const float4*>(src);
          } else {
            x.x = src[0];
            if (d + 1 < D) x.y = src[1];
            if (d + 2 < D) x.z = src[2];
            if (d + 3 < D) x.w = src[3];
          }
        }
        *reinterpret_cast<float4*>(rows_s + r * rs + c) = x;
      }
      if (D > dc) ks_load_queries(q_s, qq, b0, nb, D, d0, dc);
      __syncthreads();
      ks_tile_dot(rows_s, q_s, rr, qg, dc, rs, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr + 64 * i;
      const bool live = ex_s[r];
      const int row = row0 + r;
      const float vnr = l2 && live ? vn[base + row] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = qg * 4 + j;
        float sc = acc[i][j];
        if (l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vnr), qn_s[q]);
        L.push_warp(q, live && q < nb && L.beats(q, sc, row), sc, row);
      }
    }
    __syncthreads();
    L.merge();
  }
  __syncthreads();
  for (int q = 0; q < nb; ++q)
    L.write(q, part_vals + out0 + q * ostride, part_rows + out0 + q * ostride,
            n_pad, !kShared);
}

// Dynamic shared memory a block of the shared-list kernel may have.
static size_t knn_scan_shared_room() {
  return (size_t)es_max_shared_bytes() -
         es_static_shared_bytes(knn_scan_kernel<true>);
}

// Workspace bytes of a launch: 0 when the lists fit shared memory.
extern "C" long long es_knn_scan_workspace_bytes(int B, int S, int n_chunks,
                                                 int k, int D) {
  const int bt = B < KS_BT ? B : KS_BT;
  if (ks_base_bytes(bt, D) + ks_list_bytes(bt, k) <=
      knn_scan_shared_room())
    return 0;
  return (long long)B * S * n_chunks * k * 8;
}

extern "C" int es_knn_scan(const float* vecs, const float* vn,
                           const void* exists, const float* qq,
                           const float* qn, int B, int S, int n_pad, int D,
                           int k, int l2, int n_chunks, float* part_vals,
                           int* part_rows, float* ws, void* stream) {
  const int bt = B < KS_BT ? B : KS_BT;
  size_t shm = ks_base_bytes(bt, D);
  const bool shared =
      shm + ks_list_bytes(bt, k) <= knn_scan_shared_room();
  if (shared) shm += ks_list_bytes(bt, k);
  else if (ws == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = shared ? knn_scan_kernel<true> : knn_scan_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  const size_t n_ws = (size_t)B * S * n_chunks * k;
  const int dc = ks_dc(D);
  const int vec4 = D % 4 == 0 && ((uintptr_t)vecs & 15) == 0;
  dim3 grid(n_chunks, S, (B + bt - 1) / bt);
  kernel<<<grid, KS_THREADS, shm, (cudaStream_t)stream>>>(
      vecs, vn, (const bool*)exists, qq, qn, B, S, n_pad, D, k, l2, bt, dc,
      ks_rs(dc), vec4, part_vals, part_rows, ws,
      ws == nullptr ? nullptr : (int*)(ws + n_ws));
  return (int)cudaGetLastError();
}
