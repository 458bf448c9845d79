// K22: one step of full-batch softmax (multinomial logistic) regression.
//
// Replaces elasticsearch_tpu/xpack/ml.py:_train_logreg (:660, a
// lax.fori_loop of `steps` iterations of
//   W -= lr * (Xb^T (softmax(Xb W) - Y) / n + 1e-4 W)
// with Xb = [X, 1] and W0 = 0). One call of the C entry is one iteration,
// two kernels on one stream:
//  (a) a block per tile of K22_ROWS rows: the row's logits Xb[r] . W[:, c]
//      (f32 FMAs in ascending d), a max-subtracted softmax as
//      jax.nn.softmax forms it (exp(z - max) / sum, the sum in ascending c),
//      R = P - Y with Y built from the int labels (a label outside [0, C)
//      gives a zero row, as jax.nn.one_hot), then the tile's partial
//      Xb^T R, [F1, C], each entry an FMA chain over the tile's rows in
//      ascending order;
//  (b) one block sums the partials in block order (deterministic), then
//      g = G / n + 1e-4 W and W = W - lr g, each one rounding.
// No float atomics, so the result does not change from run to run. The
// wrapper (elasticsearch_tpu_torch/xpack/ml.py:logreg_train) calls the
// entry once a step; W is updated in place.
//
// Bound: bytes, 4 n F1 + 4 n + 8 F1 C a step (Xb and y read once by (a),
// W read and written; the partials are small). A tile holds its rows of Xb, its residuals and W in shared
// memory, (K22_ROWS (F1 + C + 2) + F1 C) * 4 bytes: past what a block may
// have (on an H100, C > 210 classes at F1 = 8) the entry returns
// ES_ERR_SHARED.

#include "topk_common.cuh"

#define K22_ROWS 256
#define K22_UPDATE_THREADS 256

__global__ void __launch_bounds__(K22_ROWS)
k22_partials(const float* __restrict__ Xb, const int* __restrict__ y, int n,
             int F1, int C, const float* __restrict__ W,
             float* __restrict__ partials) {
  extern __shared__ float sm[];
  const int F1p = F1 + 1, Cp = C + 1;   // padded rows: fewer bank conflicts
  float* W_s = sm;                      // [F1][C]
  float* X_s = W_s + F1 * C;            // [K22_ROWS][F1p]
  float* R_s = X_s + K22_ROWS * F1p;    // [K22_ROWS][Cp]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * K22_ROWS;
  const int nr = min(K22_ROWS, n - r0);
  for (int e = tid; e < F1 * C; e += K22_ROWS) W_s[e] = W[e];
  for (int e = tid; e < nr * F1; e += K22_ROWS) {
    const int r = e / F1, d = e - r * F1;
    X_s[r * F1p + d] = Xb[(size_t)r0 * F1 + e];
  }
  __syncthreads();
  if (tid < nr) {
    const float* x = X_s + tid * F1p;
    float* z = R_s + tid * Cp;
    float m = -CUDART_INF_F;
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
      for (int d = 0; d < F1; ++d) acc = __fmaf_rn(x[d], W_s[d * C + c], acc);
      z[c] = acc;
      m = fmaxf(m, acc);
    }
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float e = expf(__fsub_rn(z[c], m));
      z[c] = e;
      s = __fadd_rn(s, e);
    }
    const int label = y[r0 + tid];
    for (int c = 0; c < C; ++c)
      z[c] = __fsub_rn(__fdiv_rn(z[c], s), label == c ? 1.0f : 0.0f);
  }
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * F1 * C;
  for (int e = tid; e < F1 * C; e += K22_ROWS) {
    const int d = e / C, c = e - d * C;
    float g = 0.0f;
    for (int r = 0; r < nr; ++r)
      g = __fmaf_rn(X_s[r * F1p + d], R_s[r * Cp + c], g);
    out[e] = g;
  }
}

__global__ void __launch_bounds__(K22_UPDATE_THREADS)
k22_update(const float* __restrict__ partials, int n_blocks, int n, int F1,
           int C, float lr, float* __restrict__ W) {
  const int FC = F1 * C;
  for (int e = threadIdx.x; e < FC; e += K22_UPDATE_THREADS) {
    float G = 0.0f;
    for (int b = 0; b < n_blocks; ++b)
      G = __fadd_rn(G, partials[(size_t)b * FC + e]);
    const float w = W[e];
    const float g = __fadd_rn(__fdiv_rn(G, (float)n), __fmul_rn(1e-4f, w));
    W[e] = __fsub_rn(w, __fmul_rn(lr, g));
  }
}

static size_t k22_shared_bytes(int F1, int C) {
  return ((size_t)K22_ROWS * (F1 + 1 + C + 1) + (size_t)F1 * C) *
         sizeof(float);
}

// Bytes of the partials workspace the entry needs for (n, F1, C).
extern "C" long long es_logreg_workspace_bytes(int n, int F1, int C) {
  const long long blocks = ((long long)n + K22_ROWS - 1) / K22_ROWS;
  return blocks * F1 * C * (long long)sizeof(float);
}

// Xb f32[n, F1] (the features and a column of ones), y i32[n], W f32[F1, C]
// updated in place, partials: es_logreg_workspace_bytes(n, F1, C) bytes.
// Needs n, F1, C >= 1, else returns ES_ERR_SIZE.
extern "C" int es_logreg_step(const float* Xb, const int* y, int n, int F1,
                              int C, float lr, float* W, float* partials,
                              void* stream) {
  if (n < 1 || F1 < 1 || C < 1) return ES_ERR_SIZE;
  const size_t smem = k22_shared_bytes(F1, C);
  const int err = es_set_shared(k22_partials, smem);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + K22_ROWS - 1) / K22_ROWS;
  k22_partials<<<blocks, K22_ROWS, smem, st>>>(Xb, y, n, F1, C, W,
                                               partials);
  k22_update<<<1, K22_UPDATE_THREADS, 0, st>>>(partials, blocks, n, F1, C,
                                               lr, W);
  return (int)cudaGetLastError();
}
