// K7: the IVF scan: every (query, shard, chunk of the probed union)'s
// r_cand best rows of the quantized tier.
//
// Replaces the scan half of elasticsearch_tpu/parallel/dist_search.py:
// build_ivf_knn_step: the jnp.take of the probed-union blocks, the
// dequantized score scale * (qq . c) + off * sum(qq) (l2: (2 s - |v|^2) -
// |q|^2, |v|^2 gathered by the row id clipped to n_pad - 1), the mask of
// rows that are padding or whose cluster the query did not probe, and the
// lax.scan carried top-r_cand window. The window's ids are the positions
// p * BLK + i of the gathered union; the lists are ordered (value desc,
// position asc), which is the window the reference's scan carries, with
// its -inf entries left out. K3 reduces the chunks' lists into the window;
// K8 (ivf_rerank.cu) re-scores it.
//
// Grid: (chunk, shard, query tile of up to KS_BT queries). A block first
// turns its queries' probed cluster ids into one bitmap a query in shared
// memory, then takes tiles of KS_ROWS gathered rows chunk, chunk +
// gridDim.x, ...: a row is scored for the queries whose bitmap holds its
// cluster, a row no query of the tile probes reads no codes, the sentinel
// block NB (all padding) is not read at all, and a tile with no scored row
// is skipped. Codes (int8 or bf16) are widened to f32 in shared memory;
// each dot product is a chain of f32 FMAs in ascending d (knn_common.cuh).
//
// Bound: latency and launch. At the repository's IVF shape (2^20 rows, d =
// 64, nlist 1024, nprobe 8, B = 16) a batch reads a few MB of codes and
// metadata, microseconds at the card's memory rate; the work is a few
// dozen dependent tile steps a block.

#include <cuda_bf16.h>
#include <stdint.h>

#include "knn_common.cuh"

// Dynamic shared memory before the lists: base plus the probe bitmaps.
static size_t ivf_base_bytes(int bt, int nlist, int D) {
  return ks_base_bytes(bt, D) + (size_t)bt * ((nlist + 31) / 32) * 4;
}

template <bool kShared>
__global__ void __launch_bounds__(KS_THREADS)
ivf_scan_kernel(const void* __restrict__ codes, int is_bf16,
                const float* __restrict__ scale, const float* __restrict__ off,
                const int* __restrict__ rowid, const int* __restrict__ rcl,
                const float* __restrict__ vn, const float* __restrict__ qq,
                const float* __restrict__ qsum, const float* __restrict__ qn,
                const int* __restrict__ probed,
                const int* __restrict__ u_blocks, int B, int S, int NB1,
                int BLK, int D, int n_pad, int nlist, int nprobe, int P,
                int k, int l2, int bt, int dc, int rs,
                float* __restrict__ part_vals, int* __restrict__ part_pos,
                float* ws_vals, int* ws_pos) {
  extern __shared__ float4 smem4[];
  float* rows_s = reinterpret_cast<float*>(smem4);       // [ROWS][rs]
  float* q_s = rows_s + KS_ROWS * rs;                    // [BT][dc]
  float* c_v = q_s + KS_BT * dc;                         // [bt][ROWS]
  int* c_i = reinterpret_cast<int*>(c_v + bt * KS_ROWS);
  const int nw = (nlist + 31) / 32;
  unsigned* bm = reinterpret_cast<unsigned*>(c_i + bt * KS_ROWS);  // [bt][nw]
  unsigned char* lists = reinterpret_cast<unsigned char*>(bm + bt * nw);

  __shared__ int filled[KS_BT], ncand[KS_BT], thr_id[KS_BT];
  __shared__ float thr_v[KS_BT], qsum_s[KS_BT], qn_s[KS_BT];
  __shared__ unsigned mask_s[KS_ROWS];
  __shared__ long long src_s[KS_ROWS];
  __shared__ float sc_s[KS_ROWS], of_s[KS_ROWS], vn_s[KS_ROWS];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.z * bt;
  const int nb = min(bt, B - b0);
  const size_t ostride = (size_t)S * n_chunks * k;
  const size_t out0 = ((size_t)b0 * S + s) * n_chunks * k + (size_t)chunk * k;
  QueryLists L = ks_lists(kShared, lists, part_vals + out0, part_pos + out0,
                          ws_vals + out0, ws_pos + out0, ostride, c_v, c_i,
                          filled, ncand, thr_v, thr_id, k, bt);
  if (tid < KS_BT) {
    filled[tid] = 0;
    ncand[tid] = 0;
    qsum_s[tid] = tid < nb ? qsum[b0 + tid] : 0.0f;
    qn_s[tid] = (tid < nb && l2) ? qn[b0 + tid] : 0.0f;
  }
  for (int e = tid; e < bt * nw; e += KS_THREADS) bm[e] = 0u;
  // a row of up to dc values: the queries are loaded once
  if (D <= dc) ks_load_queries(q_s, qq, b0, nb, D, 0, dc);
  __syncthreads();
  for (int e = tid; e < nb * nprobe; e += KS_THREADS) {
    const int q = e / nprobe;
    const int c = probed[(size_t)(b0 + q) * nprobe + e % nprobe];
    if (c >= 0 && c < nlist) atomicOr(&bm[q * nw + c / 32], 1u << (c % 32));
  }
  __syncthreads();

  const int rr = tid & 63, qg = tid >> 6;
  const int n_rows = P * BLK;
  const int n_tiles = (n_rows + KS_ROWS - 1) / KS_ROWS;
  const int8_t* c8 = static_cast<const int8_t*>(codes);
  const __nv_bfloat16* c16 = static_cast<const __nv_bfloat16*>(codes);
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int g0 = tile * KS_ROWS;
    unsigned mask = 0u;
    if (tid < KS_ROWS && g0 + tid < n_rows) {
      const int g = g0 + tid;
      const int u = u_blocks[(size_t)s * P + g / BLK];
      const long long src = ((long long)s * NB1 + u) * BLK + g % BLK;
      const bool real = u < NB1 - 1;  // block NB: all padding, not read
      const int rid = real ? rowid[src] : n_pad;
      const int cl = real ? rcl[src] : -1;
      if (rid < n_pad && cl >= 0 && cl < nlist)
        for (int q = 0; q < nb; ++q)
          mask |= ((bm[q * nw + cl / 32] >> (cl % 32)) & 1u) << q;
      if (mask) {
        src_s[tid] = src;
        sc_s[tid] = scale[src];
        of_s[tid] = off[src];
        vn_s[tid] = l2 ? vn[(size_t)s * n_pad + min(max(rid, 0), n_pad - 1)]
                       : 0.0f;
      }
    }
    if (tid < KS_ROWS) mask_s[tid] = mask;
    if (!__syncthreads_or(mask != 0u)) continue;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int d0 = 0; d0 < D; d0 += dc) {
      for (int e = tid; e < KS_ROWS * dc; e += KS_THREADS) {
        const int r = e / dc, c = e - r * dc, d = d0 + c;
        float x = 0.0f;
        if (mask_s[r] && d < D) {
          const size_t at = (size_t)src_s[r] * D + d;
          x = is_bf16 ? __bfloat162float(c16[at]) : (float)c8[at];
        }
        rows_s[r * rs + c] = x;
      }
      if (D > dc) ks_load_queries(q_s, qq, b0, nb, D, d0, dc);
      __syncthreads();
      ks_tile_dot(rows_s, q_s, rr, qg, dc, rs, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr + 64 * i;
      const unsigned m = mask_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = qg * 4 + j;
        float sc = __fadd_rn(__fmul_rn(sc_s[r], acc[i][j]),
                             __fmul_rn(of_s[r], qsum_s[q]));
        if (l2) sc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, sc), vn_s[r]),
                               qn_s[q]);
        L.push(q, ((m >> q) & 1u) && L.beats(q, sc, g0 + r), sc, g0 + r);
      }
    }
    __syncthreads();
    L.merge();
  }
  __syncthreads();
  for (int q = 0; q < nb; ++q)
    L.write(q, part_vals + out0 + q * ostride, part_pos + out0 + q * ostride,
            n_rows, !kShared);
}

// Dynamic shared memory a block of the shared-list kernel may have.
static size_t ivf_scan_shared_room() {
  return (size_t)es_max_shared_bytes() -
         es_static_shared_bytes(ivf_scan_kernel<true>);
}

// Workspace bytes of a launch: 0 when the lists fit shared memory.
extern "C" long long es_ivf_scan_workspace_bytes(int B, int S, int n_chunks,
                                                 int k, int nlist, int D) {
  const int bt = B < KS_BT ? B : KS_BT;
  if (ivf_base_bytes(bt, nlist, D) + ks_list_bytes(bt, k) <=
      ivf_scan_shared_room())
    return 0;
  return (long long)B * S * n_chunks * k * 8;
}

extern "C" int es_ivf_scan(const void* codes, int is_bf16, const float* scale,
                           const float* off, const int* rowid, const int* rcl,
                           const float* vn, const float* qq,
                           const float* qsum, const float* qn,
                           const int* probed, const int* u_blocks, int B,
                           int S, int NB1, int BLK, int D, int n_pad,
                           int nlist, int nprobe, int P, int k, int l2,
                           int n_chunks, float* part_vals, int* part_pos,
                           float* ws, void* stream) {
  const int bt = B < KS_BT ? B : KS_BT;
  size_t shm = ivf_base_bytes(bt, nlist, D);
  const bool shared =
      shm + ks_list_bytes(bt, k) <= ivf_scan_shared_room();
  if (shared) shm += ks_list_bytes(bt, k);
  else if (ws == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = shared ? ivf_scan_kernel<true> : ivf_scan_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  const size_t n_ws = (size_t)B * S * n_chunks * k;
  const int dc = ks_dc(D);
  dim3 grid(n_chunks, S, (B + bt - 1) / bt);
  kernel<<<grid, KS_THREADS, shm, (cudaStream_t)stream>>>(
      codes, is_bf16, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
      u_blocks, B, S, NB1, BLK, D, n_pad, nlist, nprobe, P, k, l2, bt, dc,
      ks_rs(dc), part_vals, part_pos, ws,
      ws == nullptr ? nullptr : (int*)(ws + n_ws));
  return (int)cudaGetLastError();
}
