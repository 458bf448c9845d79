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
// The n x n matrix is never formed. It is tiled as an SGEMM is: a block
// owns K21_BM rows and streams every column past them in tiles of K21_BN
// columns, K21_SUB tiles a stage where f <= K21_FC (else a tile's K21_FC
// features a stage, their sums carried over); a thread holds a register
// tile of K21_TM rows x K21_TN columns (its rows' features in registers,
// its columns tx + 16 b of a tile from shared memory, so one 16-byte
// shared load feeds 16 FMAs).
// Column tiles arrive by 16-byte cp.async copies into a double buffer (the
// next stage's copies overlap this one's FMAs), a column's 8 features
// together, their halves swizzled so that a quarter-warp's loads hit
// distinct banks; eight features a stage, so f = 8 wastes nothing (a
// shorter last stage is zero-filled: a zero term leaves a chain's value
// as it is). A stage holds four tiles, so a block meets a barrier once
// every 512 columns.
//
// The steady-state epilogue is three operations a pair: s = sq_i + sq_j,
// d2 = fma(-2, acc, s) and a min over the thread's columns of a row (a
// tree); one compare of that min with the row's threshold (its list's
// kk-th value, never negative) and one vote of the warp decide whether a
// row's pairs go to the insert, which clamps d2 to 0 and inserts what
// beats the list. fma(-2, acc, s) equals (s - 2 acc) rounded twice
// whenever 2 acc does not overflow: the squared-norm pass flags rows whose
// norm could let it (sq > 2^124, or not finite) and the kernel then forms
// both roundings (on an H100 at n = 131,072, f = 8 the fused form saves
// about 4 % of the kernel: kernel_probe.py's two_roundings variant). The
// diagonal tile and a last tile past n are peeled:
// their pairs j == i and j >= n are set to +inf before the min. Each row's
// list (its kk smallest d2, ascending) is shared by the 16 threads of a
// half-warp that hold the row; their inserts take turns (the two halves'
// rows differ, so their turns run together), rare once the list fills,
// and each thread re-reads its rows' thresholds after a turn. At the end a
// thread a row sums its list in ascending order.
//
// The lists are the limit: kk * K21_BM * 4 bytes of shared memory beside
// the 36,864 static bytes of the stages (kk <= 764 on an H100's 232,448
// bytes a block); beyond it the entry returns ES_ERR_SHARED.
//
// Bound: operations, 2 n^2 f f32 FMA operations against the card's 67
// TFLOP/s (the data, 4 n f bytes, is read once from device memory and
// re-read from L2). The epilogue's 3 operations a pair beside 8 FMAs at
// f = 8 cap the kernel at 8/11 of the FMA rate.

#include "topk_common.cuh"

#define K21_BM 64
#define K21_BN 128
#define K21_TM 4
#define K21_TN 8
#define K21_FC 8
#define K21_SUB 4
#define K21_THREADS 256
// rows whose squared norm exceeds it (or is not finite) take the two
// roundings: below it |2 acc| <= 2 sqrt(sq_i sq_j) (1 + 2^-20) < FLT_MAX
#define K21_FMA_SAFE 2.126764793255865e37f

__global__ void __launch_bounds__(K21_THREADS)
k21_sqnorm(const float* __restrict__ X, int n, int f,
           float* __restrict__ sq, int* __restrict__ big) {
  const int i = blockIdx.x * K21_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* x = X + (size_t)i * f;
  float s = 0.0f;
  for (int d = 0; d < f; ++d) s = __fmaf_rn(x[d], x[d], s);
  sq[i] = s;
  if (!(s <= K21_FMA_SAFE)) *big = 1;
}

__device__ __forceinline__ void k21_cp16(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void k21_cp4(void* dst, const void* src,
                                        int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Float offset of feature half q (0, 1) of column c in a stage's tile: a
// column's 8 features together, the halves of columns 4..7 of each 8
// swapped, so that the same half of 8 consecutive columns lies in 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int k21_half(int c, int q) {
  return (2 * c + (q ^ ((c >> 2) & 1))) * 4;
}

// Inserts v (below the list's last entry) into an ascending list of kk;
// returns the new last entry.
__device__ __forceinline__ float k21_insert(float* ls, int kk, float v) {
  int p = kk - 1;
  while (p > 0) {
    const float prev = ls[p - 1];
    if (!(prev > v)) break;
    ls[p] = prev;
    --p;
  }
  ls[p] = v;
  return ls[kk - 1];
}

// Stage s into cs and the squared norms of its tiles into sqc: with one
// feature chunk (f <= 8) tiles K21_SUB s .. K21_SUB s + K21_SUB - 1, else
// tile s / nch's feature chunk s % nch (and its norms on the first chunk).
// A thread copies half q of column c of each tile: 16 bytes where f is a
// multiple of 4, else 4 bytes at a time (zero past f and past n).
__device__ __forceinline__ void k21_stage(const float* __restrict__ X,
                                          const float* __restrict__ sq,
                                          int n, int f, int nch, int s,
                                          float* cs, float* sqc) {
  const int tid = threadIdx.x;
  const int c = tid >> 1, q = tid & 1;
  const int w = tid & (K21_BN / 4 - 1), v = tid / (K21_BN / 4);
  int t0, ch, nsub;
  if (nch == 1) {
    t0 = s * K21_SUB;
    ch = 0;
    nsub = K21_SUB;
  } else {
    t0 = s / nch;
    ch = s - t0 * nch;
    nsub = 1;
  }
  const int d0 = ch * K21_FC + 4 * q;
  if ((f & 3) == 0) {
#pragma unroll
    for (int u = 0; u < K21_SUB; ++u) {
      const int j = (t0 + u) * K21_BN + c;
      const bool ok = u < nsub && j < n && d0 < f;
      if (u < nsub)
        k21_cp16(cs + u * (K21_BN * K21_FC) + k21_half(c, q),
                 ok ? X + (size_t)j * f + d0 : X, ok ? 16 : 0);
    }
  } else {
    for (int u = 0; u < nsub; ++u) {
      const int j = (t0 + u) * K21_BN + c;
      float* dst = cs + u * (K21_BN * K21_FC) + k21_half(c, q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j < n && d0 + e < f;
        k21_cp4(dst + e, ok ? X + (size_t)j * f + d0 + e : X, ok ? 4 : 0);
      }
    }
  }
  if (ch == 0 && v < nsub) {
    const int j = (t0 + v) * K21_BN + 4 * w;
    const int left = n - j;
    const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
    k21_cp16(sqc + v * K21_BN + 4 * w, bytes ? sq + j : sq, bytes);
  }
}

// d2 clamped to 0 as the reference clamps it (a NaN stays NaN)
__device__ __forceinline__ float k21_clamp0(float v) {
  return v < 0.0f ? 0.0f : v;
}

// fminf over 8 values as a tree (3 steps deep, not 8)
__device__ __forceinline__ float k21_min8(float v0, float v1, float v2,
                                          float v3, float v4, float v5,
                                          float v6, float v7) {
  return fminf(fminf(fminf(v0, v1), fminf(v2, v3)),
               fminf(fminf(v4, v5), fminf(v6, v7)));
}

// A stage's 8 features of a thread's register tile: acc[a][b] += x_a . c_b
// in ascending d, column c_b = tx + 16 b of the tile. kFirst: the chain
// starts here, and its first product is fma(x, c, 0), that is x * c but
// for the sign of a zero, which no d2 keeps.
template <bool kFirst>
__device__ __forceinline__ void k21_tile_fma(
    float (&acc)[K21_TM][K21_TN], const float (&xi)[K21_TM][K21_FC],
    const float* cs, int tx) {
#pragma unroll
  for (int b = 0; b < K21_TN; ++b) {
    const int c = tx + 16 * b;
    const float4 lo = *reinterpret_cast<const float4*>(cs + k21_half(c, 0));
    const float4 hi = *reinterpret_cast<const float4*>(cs + k21_half(c, 1));
    const float xc[K21_FC] = {lo.x, lo.y, lo.z, lo.w,
                              hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int a = 0; a < K21_TM; ++a)
      acc[a][b] = kFirst ? __fmul_rn(xi[a][0], xc[0])
                         : __fmaf_rn(xi[a][0], xc[0], acc[a][b]);
#pragma unroll
    for (int d = 1; d < K21_FC; ++d)
#pragma unroll
      for (int a = 0; a < K21_TM; ++a)
        acc[a][b] = __fmaf_rn(xi[a][d], xc[d], acc[a][b]);
  }
}

template <bool kFma>
__device__ __forceinline__ void k21_body(
    const float* __restrict__ X, const float* __restrict__ sq, int n, int f,
    int kk, float* __restrict__ dk, float* lst,
    float (*cols_s)[K21_SUB * K21_BN * K21_FC],
    float (*sqc_s)[K21_SUB * K21_BN]) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * K21_BM;
  const int nch = (f + K21_FC - 1) / K21_FC;
  const int ntiles = (n + K21_BN - 1) / K21_BN;
  const int nsub = nch == 1 ? K21_SUB : 1;
  const int n_stages = nch == 1 ? (ntiles + K21_SUB - 1) / K21_SUB
                                : ntiles * nch;
  const int diag = r0 / K21_BN;

  int row[K21_TM];
  float sqi[K21_TM], thr[K21_TM];
  float xi[K21_TM][K21_FC];
#pragma unroll
  for (int a = 0; a < K21_TM; ++a) {
    row[a] = r0 + ty * K21_TM + a;
    const bool live = row[a] < n;
    sqi[a] = live ? sq[row[a]] : 0.0f;
    thr[a] = live ? CUDART_INF_F : -CUDART_INF_F;
#pragma unroll
    for (int d = 0; d < K21_FC; ++d)
      xi[a][d] = (live && nch == 1 && d < f) ? X[(size_t)row[a] * f + d]
                                             : 0.0f;
  }
  for (int i = tid; i < K21_BM * kk; i += K21_THREADS) lst[i] = CUDART_INF_F;

  float acc[K21_TM][K21_TN];
  k21_stage(X, sq, n, f, nch, 0, cols_s[0], sqc_s[0]);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int s = 0; s < n_stages; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    int t0 = s * K21_SUB, ch = 0, sqb = s & 1;
    if (nch > 1) {
      t0 = s / nch;
      ch = s - t0 * nch;
      sqb = t0 & 1;
    }
    if (s + 1 < n_stages)
      k21_stage(X, sq, n, f, nch, s + 1, cols_s[(s + 1) & 1],
                sqc_s[nch == 1 ? (s + 1) & 1 : ((s + 1) / nch) & 1]);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* sqc = sqc_s[sqb];
    if (nch > 1) {
#pragma unroll
      for (int a = 0; a < K21_TM; ++a)
#pragma unroll
        for (int d = 0; d < K21_FC; ++d) {
          const int dd = ch * K21_FC + d;
          xi[a][d] = (row[a] < n && dd < f) ? X[(size_t)row[a] * f + dd]
                                            : 0.0f;
        }
    }
    for (int u = 0; u < nsub; ++u) {
      const int t = t0 + u;
      if (t >= ntiles) break;
      const float* cs = cols_s[s & 1] + u * (K21_BN * K21_FC);
      if (ch == 0)
        k21_tile_fma<true>(acc, xi, cs, tx);
      else
        k21_tile_fma<false>(acc, xi, cs, tx);
      if (ch != nch - 1) continue;

      // ---- epilogue: d2 in place of acc ----------------------------------
#pragma unroll
      for (int b = 0; b < K21_TN; ++b) {
        const float sqj = sqc[u * K21_BN + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < K21_TM; ++a) {
          const float s2 = __fadd_rn(sqi[a], sqj);
          acc[a][b] = kFma ? __fmaf_rn(-2.0f, acc[a][b], s2)
                           : __fsub_rn(s2, __fmul_rn(2.0f, acc[a][b]));
        }
      }
      if (t == diag || (t + 1) * K21_BN > n) {    // peeled: j == i, j >= n
#pragma unroll
        for (int a = 0; a < K21_TM; ++a)
#pragma unroll
          for (int b = 0; b < K21_TN; ++b) {
            const int j = t * K21_BN + tx + 16 * b;
            if (j >= n || j == row[a]) acc[a][b] = CUDART_INF_F;
          }
      }
      // ---- inserts: a row whose min beats its threshold (the list's
      // kk-th value, never negative) offers its values; a row's list is
      // shared by the 16 threads of a half-warp, which take turns (the two
      // halves' rows differ, so their turns run together)
      bool cand[K21_TM], any = false;
#pragma unroll
      for (int a = 0; a < K21_TM; ++a) {
        cand[a] = thr[a] > 0.0f &&
                  k21_min8(acc[a][0], acc[a][1], acc[a][2], acc[a][3],
                           acc[a][4], acc[a][5], acc[a][6], acc[a][7]) <
                      thr[a];
        any = any || cand[a];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int a = 0; a < K21_TM; ++a) {
        unsigned pend = __ballot_sync(0xffffffffu, cand[a]);
        if (pend == 0) continue;
        float* ls = lst + (ty * K21_TM + a) * kk;
        while (pend != 0) {
          const unsigned lo = pend & 0xffffu, hi = pend & 0xffff0000u;
          const unsigned turn = (lo & (0u - lo)) | (hi & (0u - hi));
          pend &= ~turn;
          if (turn & (1u << lane)) {
            float th = ls[kk - 1];
#pragma unroll
            for (int b = 0; b < K21_TN; ++b) {
              const float v = k21_clamp0(acc[a][b]);
              if (v < th) th = k21_insert(ls, kk, v);
            }
          }
          __syncwarp();
        }
        if (row[a] < n) thr[a] = ls[kk - 1];
      }
    }
  }
  __syncthreads();
  for (int rr = tid; rr < K21_BM; rr += K21_THREADS) {
    const int i = r0 + rr;
    if (i >= n) continue;
    const float* ls = lst + rr * kk;
    float s = 0.0f;
    for (int c = 0; c < kk; ++c) s = __fadd_rn(s, ls[c]);
    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));
  }
}

__global__ void __launch_bounds__(K21_THREADS, 2)
k21_kdist(const float* __restrict__ X, const float* __restrict__ sq,
          const int* __restrict__ big, int n, int f, int kk,
          float* __restrict__ dk) {
  extern __shared__ float lst[];                  // [K21_BM][kk]
  __shared__ __align__(16) float cols_s[2][K21_SUB * K21_BN * K21_FC];
  __shared__ __align__(16) float sqc_s[2][K21_SUB * K21_BN];
  if (*big == 0)
    k21_body<true>(X, sq, n, f, kk, dk, lst, cols_s, sqc_s);
  else
    k21_body<false>(X, sq, n, f, kk, dk, lst, cols_s, sqc_s);
}

// sq: a workspace of n + 1 floats (the squared norms, then the pass's
// flag); dk: f32[n]. Needs n >= 2, f >= 1 and 1 <= kk <= n - 1, else
// returns ES_ERR_SIZE.
extern "C" int es_knn_outlier(const float* X, int n, int f, int kk,
                              float* sq, float* dk, void* stream) {
  if (n < 2 || f < 1 || kk < 1 || kk > n - 1) return ES_ERR_SIZE;
  const size_t lst_bytes = (size_t)kk * K21_BM * sizeof(float);
  const int err = es_set_shared(k21_kdist, lst_bytes);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  int* big = reinterpret_cast<int*>(sq + n);
  cudaMemsetAsync(big, 0, sizeof(int), st);
  k21_sqnorm<<<(n + K21_THREADS - 1) / K21_THREADS, K21_THREADS, 0, st>>>(
      X, n, f, sq, big);
  k21_kdist<<<(n + K21_BM - 1) / K21_BM, K21_THREADS, lst_bytes, st>>>(
      X, sq, big, n, f, kk, dk);
  return (int)cudaGetLastError();
}

// Blocks of the distance kernel one SM holds at this kk (0: none fits).
extern "C" int es_knn_outlier_blocks_per_sm(int kk) {
  const size_t lst_bytes = (size_t)kk * K21_BM * sizeof(float);
  if (es_set_shared(k21_kdist, lst_bytes) != 0) return 0;
  int nb = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k21_kdist, K21_THREADS,
                                                lst_bytes);
  return nb;
}
