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
// Grid (chunk of K8_WARPS window entries, query * shard): one warp an
// entry. Lane 0 resolves the entry's position to its union block, its row
// id and its row; the warp copies the row into shared memory in 16-byte
// lane copies (cp.async; 4-byte copies where a row is not 16-byte
// aligned) while the block's threads load the query; lane 0 then sums the
// products in ascending d with one FMA a term, the order of K6, so a row
// scores bitwise alike in the exact scan and here.
//
// Bound: latency. The work is B * S * r_cand rows of D f32 values (640 rows
// of 256 bytes at the repository's IVF shape), a few hundred kilobytes: a
// chain of three dependent loads an entry, then its row. A call's host
// side (the wrapper's checks and the launch) costs more than the device
// time, so the launch sets the kernel's shared-memory attribute only for a
// size past the default 48 KB that the current device has not been given.

#include <stdint.h>

#include "topk_common.cuh"

#define K8_WARPS 4
#define K8_THREADS (K8_WARPS * 32)
// Devices whose shared-memory attribute the launch remembers.
#define K8_MAX_DEVICES 64

__device__ __forceinline__ void k8_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void k8_cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Floats of shared memory a row takes: D rounded up to a 16-byte multiple.
__host__ __device__ __forceinline__ int k8_row_floats(int D) {
  return (D + 3) & ~3;
}

// Dynamic shared memory: the query, then a row a warp.
static size_t k8_shared_bytes(int D) {
  return (size_t)(1 + K8_WARPS) * k8_row_floats(D) * 4;
}

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
  extern __shared__ float smem[];
  const int Dr = k8_row_floats(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = smem;                                     // [D]
  float* v_s = smem + (size_t)(1 + warp) * Dr;           // [D]
  const int bs = blockIdx.y, b = bs / S, s = bs % S;
  const int r = blockIdx.x * K8_WARPS + warp;
  const size_t o = (size_t)bs * R + r;
  // lane 0: the entry's position -> union block -> row id
  int row = n_pad, live = 0;
  if (r < R && lane == 0) {
    const int pos = win_pos[o];
    if (win_vals[o] > -CUDART_INF_F && pos >= 0 && pos < P * BLK) {
      const int u = u_blocks[(size_t)s * P + pos / BLK];
      row = rowid[((size_t)s * NB1 + u) * BLK + pos % BLK];
      live = 1;
    }
  }
  row = __shfl_sync(0xffffffffu, row, 0);
  live = __shfl_sync(0xffffffffu, live, 0);
  const int safe = min(max(row, 0), n_pad - 1);
  if (live) {
    const float* v = vecs + ((size_t)s * n_pad + safe) * D;
    if (vec4) {
      for (int d = lane * 4; d < D; d += 128) k8_cp16(v_s + d, v + d);
    } else {
      for (int d = lane; d < D; d += 32) k8_cp4(v_s + d, v + d);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int d = threadIdx.x; d < D; d += K8_THREADS)
    q_s[d] = qq[(size_t)b * D + d];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (r >= R || lane != 0) return;
  if (!live) {
    out_score[o] = -CUDART_INF_F;
    out_rows[o] = n_pad;
    return;
  }
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(v_s[d], q_s[d], acc);
  if (l2)
    acc = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc),
                              vn[(size_t)s * n_pad + safe]),
                    qn[b]);
  out_score[o] = acc;
  out_rows[o] = row;
}

extern "C" int es_ivf_rerank(const float* win_vals, const int* win_pos,
                             const int* u_blocks, const int* rowid,
                             const float* vecs, const float* vn,
                             const float* qq, const float* qn, int B, int S,
                             int R, int P, int NB1, int BLK, int n_pad, int D,
                             int l2, float* out_score, int* out_rows,
                             void* stream) {
  // the attribute last set on each device (0: none, the default 48 KB)
  static size_t set_bytes[K8_MAX_DEVICES];
  const size_t shm = k8_shared_bytes(D);
  if (shm > (size_t)48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= K8_MAX_DEVICES || set_bytes[dev] != shm) {
      const int e = es_set_shared(ivf_rerank_kernel, shm);
      if (e != 0) return e;
      if (dev >= 0 && dev < K8_MAX_DEVICES) set_bytes[dev] = shm;
    }
  }
  if (B * S > 65535) return ES_ERR_SIZE;
  const int vec4 = D % 4 == 0 && ((uintptr_t)vecs & 15) == 0;
  const dim3 grid((R + K8_WARPS - 1) / K8_WARPS, B * S);
  ivf_rerank_kernel<<<grid, K8_THREADS, shm, (cudaStream_t)stream>>>(
      win_vals, win_pos, u_blocks, rowid, vecs, vn, qq, qn, S, R, P, NB1, BLK,
      n_pad, D, l2, vec4, out_score, out_rows);
  return (int)cudaGetLastError();
}
