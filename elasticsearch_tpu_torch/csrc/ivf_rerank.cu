// K8: the exact re-rank of the IVF window.
//
// Replaces the re-rank half of elasticsearch_tpu/parallel/dist_search.py:
// build_ivf_knn_step: the gather of each window entry's original row id
// (rowid at its union position), the jnp.take of its f32 row, and the
// exact score qq . v (l2: (2 dot - |v|^2) - |q|^2), -inf where the window
// held -inf. The reference then sorts the candidates by row id and takes
// lax.top_k; K3 (topk_merge.cu) selects the same keys, (score desc, row asc),
// with the rows as ids.
//
// Grid: one block per (query, shard), threads over the window. The query
// sits in shared memory; a thread reads its row (16-byte loads when d
// allows) and sums the products in ascending d with one FMA a term, the
// order of K6, so a row scores bitwise alike in the exact scan and here.
//
// Bound: latency. The work is B * S * r_cand rows of D f32 values (640 rows
// of 256 bytes at the repository's IVF shape), a few hundred kilobytes.

#include <stdint.h>

#include "topk_common.cuh"

#define K8_THREADS 128

__global__ void __launch_bounds__(K8_THREADS)
ivf_rerank_kernel(const float* __restrict__ win_vals,
                  const int* __restrict__ win_pos,
                  const int* __restrict__ u_blocks,
                  const int* __restrict__ rowid,
                  const float* __restrict__ vecs,
                  const float* __restrict__ vn, const float* __restrict__ qq,
                  const float* __restrict__ qn, int S, int R, int P, int NB1,
                  int BLK, int n_pad, int D, int l2, int vec4,
                  float* __restrict__ out_score, int* __restrict__ out_rows) {
  extern __shared__ float q_s[];                         // [D]
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  for (int d = threadIdx.x; d < D; d += K8_THREADS)
    q_s[d] = qq[(size_t)b * D + d];
  __syncthreads();
  const size_t o = ((size_t)b * S + s) * R;
  for (int r = threadIdx.x; r < R; r += K8_THREADS) {
    const int pos = win_pos[o + r];
    if (!(win_vals[o + r] > -CUDART_INF_F) || pos < 0 || pos >= P * BLK) {
      out_score[o + r] = -CUDART_INF_F;
      out_rows[o + r] = n_pad;
      continue;
    }
    const int u = u_blocks[(size_t)s * P + pos / BLK];
    const int row = rowid[((size_t)s * NB1 + u) * BLK + pos % BLK];
    const int safe = min(max(row, 0), n_pad - 1);
    const float* v = vecs + ((size_t)s * n_pad + safe) * D;
    float acc = 0.0f;
    if (vec4) {
      for (int d = 0; d < D; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(v + d);
        acc = fmaf(x.x, q_s[d], acc);
        acc = fmaf(x.y, q_s[d + 1], acc);
        acc = fmaf(x.z, q_s[d + 2], acc);
        acc = fmaf(x.w, q_s[d + 3], acc);
      }
    } else {
      for (int d = 0; d < D; ++d) acc = fmaf(v[d], q_s[d], acc);
    }
    if (l2)
      acc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc), vn[(size_t)s * n_pad +
                                                          safe]),
                      qn[b]);
    out_score[o + r] = acc;
    out_rows[o + r] = row;
  }
}

extern "C" int es_ivf_rerank(const float* win_vals, const int* win_pos,
                             const int* u_blocks, const int* rowid,
                             const float* vecs, const float* vn,
                             const float* qq, const float* qn, int B, int S,
                             int R, int P, int NB1, int BLK, int n_pad, int D,
                             int l2, float* out_score, int* out_rows,
                             void* stream) {
  const size_t shm = (size_t)D * 4;
  int e = es_set_shared(ivf_rerank_kernel, shm);
  if (e != 0) return e;
  const int vec4 = D % 4 == 0 && ((uintptr_t)vecs & 15) == 0;
  ivf_rerank_kernel<<<B * S, K8_THREADS, shm, (cudaStream_t)stream>>>(
      win_vals, win_pos, u_blocks, rowid, vecs, vn, qq, qn, S, R, P, NB1, BLK,
      n_pad, D, l2, vec4, out_score, out_rows);
  return (int)cudaGetLastError();
}
