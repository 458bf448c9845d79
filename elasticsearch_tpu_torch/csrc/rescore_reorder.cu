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
// (__fmaf_rn), with every other operation rounded on its own. The output
// is the order of lax.sort((region, k2, k3, ns, ids), num_keys=3): region
// 0 the window, k2 = -ns, k3 = id; region 1 the rest of the live entries
// and region 2 the entries at -inf, both with k2 = position, k3 = 0.
// Outputs past the entries pad with (-inf, pad_id).
//
// Two paths, by n:
//   n <= K11_COUNT_MAX: ranking by counting. A thread an entry (the block
//     n rounded up to a warp): a window entry's output position is the
//     count of window entries with a smaller (-ns, id, position), its key
//     the ordered bits of -ns (+0 and -0 one value, a NaN after every
//     number, as lax.sort and torch.sort order them) above the id, read
//     from static shared memory; a live tail entry's is the window's
//     count plus the live tail entries before it, a -inf entry's the live
//     count plus the -inf entries before it, both counts from one block
//     prefix count (warp ballots, one barrier). Only positions below k
//     are written, then the pad. No workspace, no dynamic shared memory.
//     K11_COUNT_MAX = 512, K10's: at the serving shapes (n = 100 and 200,
//     windows of 50) a window entry compares 50 keys; at n = 512 and a
//     window past it, 512 keys a thread, about the barrier-separated
//     stages of one bitonic sort of 512 keys.
//   n > K11_COUNT_MAX: one block sorts the keys (region, k2, k3, position)
//     (sort_common.cuh), in shared memory while a row's keys fit it, else
//     in a device-memory workspace (es_rescore_reorder_workspace_bytes).
//
// Bound: tiny work per query; latency bound at the serving shapes (16
// queries, one block each).

#include "sort_common.cuh"

#define K11_THREADS 512
// the counting path's largest n; its block is n rounded up to a warp
#define K11_COUNT_MAX 512
#define K11_WARPS (K11_COUNT_MAX / 32)
#define K11_MAX_DEVICES 64

// The combined score of a window entry (mode: 0 total, 1 multiply, 2 avg,
// 3 max, 4 min).
__device__ __forceinline__ float k11_combine(float ps, float rw, float sec,
                                             int mode) {
  const float rs = __fmul_rn(rw, sec);
  switch (mode) {
    case 0: return __fmaf_rn(rw, sec, ps);
    case 1: return __fmul_rn(ps, rs);
    case 2: return __fdiv_rn(__fmaf_rn(rw, sec, ps), 2.0f);
    case 3: return fmaxf(ps, rs);
    default: return fminf(ps, rs);
  }
}

// A window entry's key: -ns's order-preserving bits (zeros made +0, NaNs
// the canonical NaN) above the id's. Below ~0ull, the key of no entry.
__device__ __forceinline__ unsigned long long k11_key(float ns, int id) {
  float k2 = -ns;
  if (k2 == 0.0f) k2 = 0.0f;
  unsigned u = k2 != k2 ? 0x7FC00000u : __float_as_uint(k2);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(id ^ (int)0x80000000);
}

// The counting path (n <= K11_COUNT_MAX), one block a query.
__global__ void __launch_bounds__(K11_COUNT_MAX)
rescore_count_kernel(const float* __restrict__ vals,
                     const int* __restrict__ ids,
                     const float* __restrict__ secondary,
                     const bool* __restrict__ matched,
                     const float* __restrict__ qw,
                     const float* __restrict__ rw,
                     const int* __restrict__ window, int n, int mode,
                     int k_out, int pad_id, float* __restrict__ out_vals,
                     int* __restrict__ out_ids) {
  __shared__ unsigned long long key[K11_COUNT_MAX];
  __shared__ int warp_count[3][K11_WARPS];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const size_t row = (size_t)b * n;
  const int win = window[b];
  const int m = min(n, max(win, 0));   // the positions that may be window

  // region 0 the window, 1 the live tail, 2 at -inf, 3 no entry
  int region = 3, id = pad_id;
  float ns = -CUDART_INF_F;
  if (j < n) {
    const float v = vals[row + j];
    id = ids[row + j];
    if (!(v > -CUDART_INF_F)) {
      region = 2;
    } else {
      const float ps = __fmul_rn(qw[b], v);
      ns = ps;
      region = j < win ? 0 : 1;
      if (region == 0 && matched[row + j])
        ns = k11_combine(ps, rw[b], secondary[row + j], mode);
    }
  }
  if (j < m) key[j] = region == 0 ? k11_key(ns, id) : ~0ull;
  const unsigned below = (1u << lane) - 1u;
  const unsigned w0 = __ballot_sync(0xFFFFFFFFu, region == 0);
  const unsigned w1 = __ballot_sync(0xFFFFFFFFu, region == 1);
  const unsigned w2 = __ballot_sync(0xFFFFFFFFu, region == 2);
  if (lane == 0) {
    warp_count[0][warp] = __popc(w0);
    warp_count[1][warp] = __popc(w1);
    warp_count[2][warp] = __popc(w2);
  }
  __syncthreads();

  int n_window = 0, n_tail = 0, tail_before = __popc(w1 & below),
      inf_before = __popc(w2 & below);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    n_window += warp_count[0][w];
    n_tail += warp_count[1][w];
    if (w < warp) {
      tail_before += warp_count[1][w];
      inf_before += warp_count[2][w];
    }
  }
  int r = k_out;
  if (region == 0) {
    const unsigned long long kj = key[j];
    int c = 0;
    for (int i = 0; i < m; ++i) {
      const unsigned long long ki = key[i];
      c += (ki < kj || (ki == kj && i < j)) ? 1 : 0;
    }
    r = c;
  } else if (region == 1) {
    r = n_window + tail_before;
  } else if (region == 2) {
    r = n_window + n_tail + inf_before;
  }
  float* ov = out_vals + (size_t)b * k_out;
  int* oi = out_ids + (size_t)b * k_out;
  if (r < k_out) {
    ov[r] = ns;
    oi[r] = ns > -CUDART_INF_F ? id : pad_id;
  }
  for (int i = n + j; i < k_out; i += blockDim.x) {
    ov[i] = -CUDART_INF_F;
    oi[i] = pad_id;
  }
}

// The sorting path (n > K11_COUNT_MAX), one block a query.
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
        const float ns = mb[j] ? k11_combine(ps, rwb, sb[j], mode) : ps;
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

// Bytes of device-memory workspace for B rows of n entries: 0 on the
// counting path, and when a row's sort keys fit shared memory.
extern "C" long long es_rescore_reorder_workspace_bytes(int n, int B) {
  return n <= K11_COUNT_MAX ? 0 : es_sort_workspace_bytes(n, B);
}

// mode: 0 total, 1 multiply, 2 avg, 3 max, 4 min. The sorting path (n >
// K11_COUNT_MAX) needs a workspace of B rows of pow2(n) SortKeys when a
// row does not fit a block's shared memory (refused without it).
extern "C" int es_rescore_reorder(const float* vals, const int* ids,
                                  const float* secondary,
                                  const bool* matched, const float* qw,
                                  const float* rw, const int* window, int B,
                                  int n, int mode, int k_out, int pad_id,
                                  float* out_vals, int* out_ids,
                                  void* workspace, void* stream) {
  if (mode < 0 || mode > 4) return ES_ERR_ARG;
  if (B == 0 || k_out == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= K11_COUNT_MAX) {
    const int threads = n > 32 ? (n + 31) / 32 * 32 : 32;
    rescore_count_kernel<<<B, threads, 0, st>>>(
        vals, ids, secondary, matched, qw, rw, window, n, mode, k_out,
        pad_id, out_vals, out_ids);
    return (int)cudaGetLastError();
  }
  // the attribute last set on each device (0: none, the default 48 KB)
  static size_t set_bytes[K11_MAX_DEVICES];
  const int n2 = es_pow2_at_least(n);
  const size_t shm =
      workspace != nullptr ? 0 : (size_t)n2 * sizeof(SortKey);
  if (shm > (size_t)48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= K11_MAX_DEVICES || set_bytes[dev] < shm) {
      const int e = es_set_shared(rescore_reorder_kernel, shm);
      if (e != 0) return e;
      if (dev >= 0 && dev < K11_MAX_DEVICES) set_bytes[dev] = shm;
    }
  }
  rescore_reorder_kernel<<<B, K11_THREADS, shm, st>>>(
      vals, ids, secondary, matched, qw, rw, window, n, mode, n2, k_out,
      pad_id, out_vals, out_ids, (SortKey*)workspace);
  return (int)cudaGetLastError();
}
