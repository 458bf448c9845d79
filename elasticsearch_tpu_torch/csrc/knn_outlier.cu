// K21: the kNN distance of outlier detection: per row, the root of the mean
// of its kk smallest squared distances to the other rows.
//
// Replaces the device half of elasticsearch_tpu/xpack/ml.py:
// _knn_outlier_scores (:627, the pairwise-distance matmul, the diagonal set
// to +inf and lax.top_k of -d2). For X f32[n, f]:
//   sq[i]    = sum_d x[i,d]^2                  (an FMA chain, ascending d)
//   d2[i, j] = max((sq[i] + sq[j]) - 2 (x_i . x_j), 0)   for j != i
//   dk[i]    = sqrt((sum of the kk smallest d2[i, :], ascending) / kk)
// Each dot product is a chain of f32 FMAs in ascending d, with no tensor
// core or TF32 shortcut (the reference's product is f32); every other step
// is one correctly rounded operation (_rn intrinsics), so the plain version
// (elasticsearch_tpu_torch/xpack/ml.py:knn_kdist_plain) that forms the
// same chain is bitwise equal. The sigmoid of the z-scored dk is n-element
// torch work on the card, outside this kernel.
//
// The n x n matrix is never formed. A block owns K21_ROWS rows, one a
// thread, and streams every column past them in tiles of K21_COLS columns
// (K21_FC features at a time) through shared memory; a thread holds its
// row's features and the tile's K21_COLS dot products in registers. Each
// row keeps its kk smallest d2 in shared memory ([kk][K21_ROWS], ascending)
// and its threshold (the kk-th) in a register: a distance below it is
// inserted (rare once the list fills: about kk ln(n / kk) times a row on
// random data). The whole row fits one block, so no cross-block reduce is
// needed. The list is the limit: kk * K21_ROWS * 4 bytes of shared memory
// beside 4,352 static bytes (kk <= 445 on an H100's 232,448 bytes a
// block); beyond it the entry returns ES_ERR_SHARED.
//
// Bound: operations, 2 n^2 f f32 FMA operations against the card's 67
// TFLOP/s (the data, 4 n f bytes, is read once from device memory and
// re-read from L2); each FMA needs a quarter of a 16-byte broadcast
// shared-memory load.

#include "topk_common.cuh"

#define K21_ROWS 128
#define K21_COLS 64
#define K21_FC 16

__global__ void __launch_bounds__(K21_ROWS)
k21_sqnorm(const float* __restrict__ X, int n, int f,
           float* __restrict__ sq) {
  const int i = blockIdx.x * K21_ROWS + threadIdx.x;
  if (i >= n) return;
  const float* x = X + (size_t)i * f;
  float s = 0.0f;
  for (int d = 0; d < f; ++d) s = __fmaf_rn(x[d], x[d], s);
  sq[i] = s;
}

// Inserts v (below the list's last entry) into a thread's ascending list;
// returns the new last entry.
__device__ __noinline__ float k21_insert(float* lst, int tid, int kk,
                                         float v) {
  int p = kk - 1;
  while (p > 0) {
    const float prev = lst[(p - 1) * K21_ROWS + tid];
    if (!(prev > v)) break;
    lst[p * K21_ROWS + tid] = prev;
    --p;
  }
  lst[p * K21_ROWS + tid] = v;
  return lst[(kk - 1) * K21_ROWS + tid];
}

__global__ void __launch_bounds__(K21_ROWS)
k21_kdist(const float* __restrict__ X, const float* __restrict__ sq, int n,
          int f, int kk, float* __restrict__ dk) {
  extern __shared__ float lst[];                  // [kk][K21_ROWS]
  __shared__ __align__(16) float cols_s[K21_FC][K21_COLS];
  __shared__ float sqc_s[K21_COLS];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * K21_ROWS + tid;
  const bool live = i < n;
  for (int c = 0; c < kk; ++c) lst[c * K21_ROWS + tid] = CUDART_INF_F;
  float thr = CUDART_INF_F;
  const float sq_i = live ? sq[i] : 0.0f;
  const float* xrow = X + (size_t)(live ? i : 0) * f;
  const bool one_chunk = f <= K21_FC;
  float xi[K21_FC];
#pragma unroll
  for (int dd = 0; dd < K21_FC; ++dd)
    xi[dd] = (one_chunk && live && dd < f) ? xrow[dd] : 0.0f;

  for (int j0 = 0; j0 < n; j0 += K21_COLS) {
    float acc[K21_COLS];
#pragma unroll
    for (int jj = 0; jj < K21_COLS; ++jj) acc[jj] = 0.0f;
    for (int d0 = 0; d0 < f; d0 += K21_FC) {
      __syncthreads();                  // the previous chunk's reads are done
      for (int e = tid; e < K21_COLS * K21_FC; e += K21_ROWS) {
        const int jj = e / K21_FC, dd = e - jj * K21_FC;
        const int col = j0 + jj, d = d0 + dd;
        cols_s[dd][jj] = (col < n && d < f) ? X[(size_t)col * f + d] : 0.0f;
      }
      if (d0 == 0 && tid < K21_COLS)
        sqc_s[tid] = j0 + tid < n ? sq[j0 + tid] : 0.0f;
      if (!one_chunk) {
#pragma unroll
        for (int dd = 0; dd < K21_FC; ++dd)
          xi[dd] = (live && d0 + dd < f) ? xrow[d0 + dd] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < K21_FC; ++dd) {
        if (d0 + dd < f) {
          const float x = xi[dd];
#pragma unroll
          for (int jj = 0; jj < K21_COLS; jj += 4) {
            const float4 c4 = *reinterpret_cast<const float4*>(
                &cols_s[dd][jj]);
            acc[jj] = __fmaf_rn(x, c4.x, acc[jj]);
            acc[jj + 1] = __fmaf_rn(x, c4.y, acc[jj + 1]);
            acc[jj + 2] = __fmaf_rn(x, c4.z, acc[jj + 2]);
            acc[jj + 3] = __fmaf_rn(x, c4.w, acc[jj + 3]);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int jj = 0; jj < K21_COLS; ++jj) {
        const int col = j0 + jj;
        if (col < n && col != i) {
          float d2 = __fsub_rn(__fadd_rn(sq_i, sqc_s[jj]),
                               __fmul_rn(2.0f, acc[jj]));
          d2 = d2 < 0.0f ? 0.0f : d2;
          if (d2 < thr) thr = k21_insert(lst, tid, kk, d2);
        }
      }
    }
  }
  if (live) {
    float s = 0.0f;
    for (int c = 0; c < kk; ++c) s = __fadd_rn(s, lst[c * K21_ROWS + tid]);
    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));
  }
}

// sq: a workspace of n floats (the squared norms); dk: f32[n]. Needs
// n >= 2, f >= 1 and 1 <= kk <= n - 1, else returns ES_ERR_SIZE.
extern "C" int es_knn_outlier(const float* X, int n, int f, int kk,
                              float* sq, float* dk, void* stream) {
  if (n < 2 || f < 1 || kk < 1 || kk > n - 1) return ES_ERR_SIZE;
  const size_t lst_bytes = (size_t)kk * K21_ROWS * sizeof(float);
  const int err = es_set_shared(k21_kdist, lst_bytes);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + K21_ROWS - 1) / K21_ROWS;
  k21_sqnorm<<<blocks, K21_ROWS, 0, st>>>(X, n, f, sq);
  k21_kdist<<<blocks, K21_ROWS, lst_bytes, st>>>(X, sq, n, f, kk, dk);
  return (int)cudaGetLastError();
}
