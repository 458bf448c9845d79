// K11: the rescore window's reorder.
//
// Replaces elasticsearch_tpu/ops/fused_query.py:rescore_reorder_body with
// rescore_combine (all five score modes), the last stage of
// parallel/dist_search.py:build_bool_bm25_step (with Q2 > 0) and of
// build_fused_hybrid_step's `finish`.
//
// One block per query over the n entries of its ranking. An entry is live
// iff its value is finite; it is in the window iff live and its position is
// below the query's window (a runtime value). A window entry the rescore
// query matched combines qw * primary with rw * secondary per mode; every
// other live entry keeps ps = qw * primary. XLA:CPU compiles the
// reference's total/avg as fma(rw, secondary, ps), so this kernel does too
// (__fmaf_rn), with every other operation rounded on its own. The block
// then sorts the keys (region, k2, k3, position) of
// lax.sort((region, k2, k3, ns, ids), num_keys=3): region 0 the window,
// k2 = -ns, k3 = id; region 1 the rest of the live entries and region 2
// the entries at -inf, both with k2 = position, k3 = 0. Outputs past the
// entries pad with (-inf, pad_id).
//
// Bound: tiny work per query (one sort of n entries); latency bound.

#include "sort_common.cuh"

#define K11_THREADS 512

__global__ void __launch_bounds__(K11_THREADS)
rescore_reorder_kernel(const float* __restrict__ vals,
                       const int* __restrict__ ids,
                       const float* __restrict__ secondary,
                       const bool* __restrict__ matched,
                       const float* __restrict__ qw,
                       const float* __restrict__ rw,
                       const int* __restrict__ window, int n, int mode,
                       int n2, int k_out, int pad_id,
                       float* __restrict__ out_vals,
                       int* __restrict__ out_ids, SortKey* workspace) {
  extern __shared__ unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  SortKey* a = workspace != nullptr ? workspace + (size_t)b * n2
                                    : reinterpret_cast<SortKey*>(smem);
  const float* vb = vals + (size_t)b * n;
  const int* ib = ids + (size_t)b * n;
  const float* sb = secondary + (size_t)b * n;
  const bool* mb = matched + (size_t)b * n;
  const float qwb = qw[b], rwb = rw[b];
  const int win = window[b];

  for (int j = tid; j < n2; j += K11_THREADS) {
    SortKey key{3, 0.0f, 0, j};
    if (j < n) {
      const float v = vb[j];
      if (!(v > -CUDART_INF_F)) {
        key = SortKey{2, (float)j, 0, j};
      } else if (j >= win) {
        key = SortKey{1, (float)j, 0, j};
      } else {
        const float ps = __fmul_rn(qwb, v);
        float ns = ps;
        if (mb[j]) {
          const float sec = sb[j];
          const float rs = __fmul_rn(rwb, sec);
          switch (mode) {
            case 0: ns = __fmaf_rn(rwb, sec, ps); break;             // total
            case 1: ns = __fmul_rn(ps, rs); break;                   // multiply
            case 2: ns = __fdiv_rn(__fmaf_rn(rwb, sec, ps), 2.0f); break;
            case 3: ns = fmaxf(ps, rs); break;                       // max
            default: ns = fminf(ps, rs); break;                      // min
          }
        }
        key = SortKey{0, -ns, ib[j], j};
      }
    }
    a[j] = key;
  }
  block_bitonic_sort(a, n2);

  float* ov = out_vals + (size_t)b * k_out;
  int* oi = out_ids + (size_t)b * k_out;
  for (int i = tid; i < k_out; i += K11_THREADS) {
    float v = -CUDART_INF_F;
    int id = pad_id;
    if (i < n) {
      const SortKey key = a[i];
      if (key.r == 0) {
        v = -key.k2;
      } else if (key.r == 1) {
        v = __fmul_rn(qwb, vb[key.c]);
      }
      if (v > -CUDART_INF_F) id = ib[key.c];
    }
    ov[i] = v;
    oi[i] = id;
  }
}

// Bytes of device-memory workspace for B rows of n entries: 0 when a row's
// keys fit shared memory.
extern "C" long long es_rescore_reorder_workspace_bytes(int n, int B) {
  return es_sort_workspace_bytes(n, B);
}

// mode: 0 total, 1 multiply, 2 avg, 3 max, 4 min.
extern "C" int es_rescore_reorder(const float* vals, const int* ids,
                                  const float* secondary,
                                  const bool* matched, const float* qw,
                                  const float* rw, const int* window, int B,
                                  int n, int mode, int k_out, int pad_id,
                                  float* out_vals, int* out_ids,
                                  void* workspace, void* stream) {
  if (mode < 0 || mode > 4) return ES_ERR_ARG;
  const int n2 = es_pow2_at_least(n);
  size_t shm = workspace != nullptr ? 0 : (size_t)n2 * sizeof(SortKey);
  int e = es_set_shared(rescore_reorder_kernel, shm);
  if (e != 0) return e;
  rescore_reorder_kernel<<<B, K11_THREADS, shm, (cudaStream_t)stream>>>(
      vals, ids, secondary, matched, qw, rw, window, n, mode, n2, k_out,
      pad_id, out_vals, out_ids, (SortKey*)workspace);
  return (int)cudaGetLastError();
}
