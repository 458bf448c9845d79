// K22: full-batch softmax (multinomial logistic) regression, every step in
// one persistent launch.
//
// Replaces elasticsearch_tpu/xpack/ml.py:_train_logreg (:660, a
// lax.fori_loop of `steps` iterations of
//   W -= lr * (Xb^T (softmax(Xb W) - Y) / n + 1e-4 W)
// with Xb = [X, 1] and W0 = 0). One call of the C entry runs all `steps`
// as one cooperative launch: every block is resident for the whole run,
// one block an SM, and block b takes the row tiles b, b + grid, ... of
// K22_ROWS rows. Each block keeps its own copy of W in shared memory, and
// its tiles' rows of Xb too where they fit (else it reads them again from
// L2 each step, a group of tiles at a time). A step:
//  (a) a thread a row of the block's tiles: the logits Xb[r] . W[:, c] (f32
//      FMAs in ascending d), a max-subtracted softmax as jax.nn.softmax
//      forms it (exp(z - max) / sum, the sum in ascending c), R = P - Y
//      with Y built from the int labels (a label outside [0, C) gives a
//      zero row, as jax.nn.one_hot);
//  (b) each tile's partial Xb^T R, [F1, C]: an entry is an FMA chain over
//      the tile's rows in ascending order, the block's threads taking
//      (tile, entry) pairs; the partials go to one of two buffers by the
//      step's parity;
//  (c) one grid barrier;
//  (d) every block sums the partials of all tiles in tile order (staged
//      from L2 into shared memory a chunk at a time), then
//      g = G / n + 1e-4 W and W = W - lr g, each one rounding, into its
//      own copy of W. Every copy gets the same bits, so the next step
//      needs no second barrier; the parity keeps a slow block's reads of
//      this step's partials apart from the next step's writes.
// Every sum runs in a fixed order (a partial over ascending rows, the
// partials over ascending tiles), the order of the earlier kernel that
// took one launch a step, so W keeps that kernel's bits. No float
// atomics: W does not change from run to run. Block 0 writes W at the
// end.
//
// The grid barrier is an arrival counter in the workspace, zeroed by the
// entry before the launch: barrier i waits for (i + 1) x grid arrivals.
// The cooperative launch guarantees that every block is resident, and
// refuses a grid that cannot be (the library's own message).
//
// Bound: operations, steps x (4 n F1 C + 6 n C) f32 operations (Xb and y
// need reading once a run). At (m)'s 131,072 x 8 rows a step's few
// microseconds are latency: a 256-link FMA chain (a tile's partial), an
// n / 256-link add chain (the sum), the barrier and the partials' trip
// through L2. Shared memory holds W, K tiles of rows (K22_ROWS (F1 + 1)
// floats each) and their residuals (K22_ROWS (C + 1) floats each), where
// the staged partials go too: at least (K22_ROWS (F1 + C + 2) + F1 C) * 4
// bytes (one tile). Past what a block may have (on an H100, C > 210
// classes at F1 = 8) the entry returns ES_ERR_SHARED.

#include "topk_common.cuh"

#define K22_ROWS 256
#define K22_THREADS 512
#define K22_REG_C 8

__device__ __forceinline__ unsigned long long k22_load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Waits until every block of the grid has arrived `target / gridDim.x`
// times: the block's writes before it are visible to every block after.
__device__ __forceinline__ void k22_grid_sync(unsigned long long* count,
                                              unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ULL);
    while (k22_load_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// A row's residuals R = softmax(x . W) - Y into z (C floats): the logits
// as f32 FMAs in ascending d, exp(z - max) / sum with the sum in
// ascending c, as jax.nn.softmax forms it; Y the one-hot of `label` (a
// label outside [0, C) gives a zero row, as jax.nn.one_hot). For C <=
// K22_REG_C the logits stay in registers, their chains side by side; the
// two forms round alike.
__device__ __forceinline__ void k22_residual_regs(const float* x,
                                                  const float* W_s, int F1,
                                                  int C, int label,
                                                  float* z) {
  float zr[K22_REG_C];
#pragma unroll
  for (int c = 0; c < K22_REG_C; ++c) zr[c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < F1; ++d) {
    const float xd = x[d];
#pragma unroll
    for (int c = 0; c < K22_REG_C; ++c)
      if (c < C) zr[c] = __fmaf_rn(xd, W_s[d * C + c], zr[c]);
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < K22_REG_C; ++c)
    if (c < C) m = fmaxf(m, zr[c]);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < K22_REG_C; ++c) {
    if (c >= C) break;
    zr[c] = expf(__fsub_rn(zr[c], m));
    sum = __fadd_rn(sum, zr[c]);
  }
#pragma unroll
  for (int c = 0; c < K22_REG_C; ++c) {
    if (c >= C) break;
    z[c] = __fsub_rn(__fdiv_rn(zr[c], sum), label == c ? 1.0f : 0.0f);
  }
}

__device__ __forceinline__ void k22_residual_shared(const float* x,
                                                    const float* W_s, int F1,
                                                    int C, int label,
                                                    float* z) {
  float m = -CUDART_INF_F;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    for (int d = 0; d < F1; ++d) acc = __fmaf_rn(x[d], W_s[d * C + c], acc);
    z[c] = acc;
    m = fmaxf(m, acc);
  }
  float sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float e = expf(__fsub_rn(z[c], m));
    z[c] = e;
    sum = __fadd_rn(sum, e);
  }
  for (int c = 0; c < C; ++c)
    z[c] = __fsub_rn(__fdiv_rn(z[c], sum), label == c ? 1.0f : 0.0f);
}

// Rows of the block's tiles g0 .. g0 + kk - 1 (tile b + g G, g counting
// the block's own) into X_s, padded to F1 + 1 floats a row.
__device__ __forceinline__ void k22_load_rows(const float* __restrict__ Xb,
                                              int n, int F1, int g0, int kk,
                                              float* X_s) {
  const int F1p = F1 + 1;
  for (int j = 0; j < kk; ++j) {
    const int r0 = (blockIdx.x + (g0 + j) * gridDim.x) * K22_ROWS;
    const int nr = min(K22_ROWS, n - r0);
    float* xs = X_s + j * K22_ROWS * F1p;
    for (int e = threadIdx.x; e < nr * F1; e += K22_THREADS) {
      const int r = e / F1, d = e - r * F1;
      xs[r * F1p + d] = Xb[(size_t)r0 * F1 + e];
    }
  }
}

__global__ void __launch_bounds__(K22_THREADS, 1)
k22_train(const float* __restrict__ Xb, const int* __restrict__ y, int n,
          int F1, int C, float lr, int steps, int K, int stage,
          float* __restrict__ W, unsigned long long* count,
          float* partials) {
  extern __shared__ float sm[];
  const int F1p = F1 + 1, Cp = C + 1, FC = F1 * C;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int tiles = (n + K22_ROWS - 1) / K22_ROWS;
  const int mine = (tiles - 1 - (int)blockIdx.x) / G + 1;  // tiles it takes
  const bool resident = mine <= K;
  float* W_s = sm;
  float* X_s = W_s + (FC + 3) / 4 * 4;            // [K][K22_ROWS][F1p]
  float* R_s = X_s + K * K22_ROWS * F1p;          // [K][K22_ROWS][Cp]
  for (int e = tid; e < FC; e += K22_THREADS) W_s[e] = W[e];

  if (resident) k22_load_rows(Xb, n, F1, 0, mine, X_s);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    float* P = partials + (size_t)(s & 1) * tiles * FC;
    for (int g0 = 0; g0 < mine; g0 += K) {
      const int kk = min(K, mine - g0);
      if (!resident) {
        k22_load_rows(Xb, n, F1, g0, kk, X_s);
        __syncthreads();
      }
      // (a) a thread a row: the residuals R = softmax - Y
      for (int q = tid; q < kk * K22_ROWS; q += K22_THREADS) {
        const int j = q / K22_ROWS, r = q - j * K22_ROWS;
        const int r0 = (blockIdx.x + (g0 + j) * G) * K22_ROWS;
        if (r0 + r >= n) continue;
        const int label = y[r0 + r];
        const float* x = X_s + (j * K22_ROWS + r) * F1p;
        float* z = R_s + (j * K22_ROWS + r) * Cp;
        if (C <= K22_REG_C)
          k22_residual_regs(x, W_s, F1, C, label, z);
        else
          k22_residual_shared(x, W_s, F1, C, label, z);
      }
      __syncthreads();
      // (b) the tiles' partials, an FMA chain over a tile's rows an entry
      for (int q = tid; q < kk * FC; q += K22_THREADS) {
        const int j = q / FC, e = q - j * FC;
        const int d = e / C, c = e - d * C;
        const int t = blockIdx.x + (g0 + j) * G;
        const int nr = min(K22_ROWS, n - t * K22_ROWS);
        const float* xs = X_s + j * K22_ROWS * F1p + d;
        const float* rs = R_s + j * K22_ROWS * Cp + c;
        float g = 0.0f;
#pragma unroll 32
        for (int r = 0; r < nr; ++r)
          g = __fmaf_rn(xs[r * F1p], rs[r * Cp], g);
        __stcg(P + (size_t)t * FC + e, g);
      }
      __syncthreads();
    }
    // (c) every tile's partial of this step is written
    k22_grid_sync(count, (unsigned long long)(s + 1) * G);
    // (d) the gradient sum: the partials summed in tile order, an entry a
    // thread, staged from L2 in chunks of tiles x entries
    for (int e0 = 0; e0 < FC; e0 += K22_THREADS) {
      const int E = min(K22_THREADS, FC - e0);
      const int Tc = stage / E;
      float g = 0.0f;
      for (int t0 = 0; t0 < tiles; t0 += Tc) {
        const int tc = min(Tc, tiles - t0);
        if (E == FC && (FC & 3) == 0) {           // one contiguous run
          const float4* src = (const float4*)(P + (size_t)t0 * FC);
          float4* dst = (float4*)R_s;
#pragma unroll 8
          for (int i = tid; i < tc * FC / 4; i += K22_THREADS)
            dst[i] = __ldcg(src + i);
        } else {
#pragma unroll 8
          for (int i = tid; i < tc * E; i += K22_THREADS) {
            const int t = i / E, j = i - t * E;
            R_s[i] = __ldcg(P + (size_t)(t0 + t) * FC + e0 + j);
          }
        }
        __syncthreads();
        if (tid < E) {
#pragma unroll 32
          for (int t = 0; t < tc; ++t) g = __fadd_rn(g, R_s[t * E + tid]);
        }
        __syncthreads();
      }
      if (tid < E) {
        const float w = W_s[e0 + tid];
        const float gr = __fadd_rn(__fdiv_rn(g, (float)n), __fmul_rn(1e-4f, w));
        W_s[e0 + tid] = __fsub_rn(w, __fmul_rn(lr, gr));
      }
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int e = tid; e < FC; e += K22_THREADS) W[e] = W_s[e];
}

// Tiles of K22_ROWS rows.
static long long k22_tiles(int n) {
  return ((long long)n + K22_ROWS - 1) / K22_ROWS;
}

// Bytes of the workspace the entry needs for (n, F1, C): the barrier's
// counter (16 bytes) and two buffers of every tile's partial.
extern "C" long long es_logreg_workspace_bytes(int n, int F1, int C) {
  return 16 + 2 * k22_tiles(n) * F1 * C * (long long)sizeof(float);
}

// The launch for (n, F1, C): the grid (a block an SM, at most a block a
// tile), K tiles of rows a block keeps in shared memory, the floats that
// stage the partials (the residuals' room, grown into what is left of
// shared memory, up to a chunk of every tile) and the shared bytes; or
// ES_ERR_SHARED when one tile does not fit.
static int k22_plan(int n, int F1, int C, int* G, int* K, int* stage,
                    size_t* smem) {
  const int tiles = (int)k22_tiles(n);
  *G = tiles < es_sm_count() ? tiles : es_sm_count();
  const long long mine = (tiles + *G - 1) / *G;
  const long long w = (F1 * C + 3) / 4 * 4;
  const long long room = es_max_shared_bytes() / (long long)sizeof(float) - w;
  const long long tile = (long long)K22_ROWS * (F1 + 1 + C + 1);
  if (room < tile) return ES_ERR_SHARED;
  *K = (int)(mine < room / tile ? mine : room / tile);
  const long long rows = (long long)*K * K22_ROWS * (F1 + 1);
  const long long res = (long long)*K * K22_ROWS * (C + 1);
  const long long want = (long long)tiles *
                         (F1 * C < K22_THREADS ? F1 * C : K22_THREADS);
  const long long left = (room - rows) / 4 * 4;
  *stage = (int)(res > want ? res : (want < left ? want : left));
  *smem = (size_t)(w + rows + *stage) * sizeof(float);
  return 0;
}

// Xb f32[n, F1] (the features and a column of ones), y i32[n], W f32[F1, C]
// (the start, then the result, in place), workspace:
// es_logreg_workspace_bytes(n, F1, C) bytes, 16-byte aligned. Needs n,
// F1, C >= 1 and steps >= 0, else returns ES_ERR_SIZE; steps = 0 launches
// nothing.
extern "C" int es_logreg_train(const float* Xb, const int* y, int n, int F1,
                               int C, float lr, int steps, float* W,
                               void* workspace, void* stream) {
  if (n < 1 || F1 < 1 || C < 1 || steps < 0) return ES_ERR_SIZE;
  if (steps == 0) return 0;
  int G, K, stage;
  size_t smem;
  int err = k22_plan(n, F1, C, &G, &K, &stage, &smem);
  if (err == 0) err = es_set_shared(k22_train, smem);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* count = (unsigned long long*)workspace;
  float* partials = (float*)((char*)workspace + 16);
  cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  void* args[] = {(void*)&Xb, (void*)&y,     (void*)&n,     (void*)&F1,
                  (void*)&C,  (void*)&lr,    (void*)&steps, (void*)&K,
                  (void*)&stage, (void*)&W,  (void*)&count,
                  (void*)&partials};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)k22_train, dim3(G), dim3(K22_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
