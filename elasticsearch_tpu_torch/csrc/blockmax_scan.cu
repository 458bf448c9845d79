// K4: block-max pruned scan, survivor selection and safety verdict.
//
// Replaces the per_query scan of elasticsearch_tpu/parallel/dist_search.py:
// build_pruned_bm25_step, up to and including the top-R survivors, the
// safety verdict and the doc-ascending sort of the survivors (its exact
// re-score is K5, its top-k K3).
//
// One block per (query b, shard s), one thread per posting of a block of
// the tier (BS = 128 by default). The scan is serial in the schedule:
//
// - Before each step every thread reads the threshold
//   theta = window[kq_idx] - slack (-inf when pruning is inert). A step is
//   live iff its block id is not the pad id NB and its remaining bound mass
//   rho >= theta. The schedule's rho never rises and its pad steps come
//   only at its end (BlockMaxTier.schedule makes it so), and theta never
//   falls, so once a step is not live no later one is: the scan stops
//   there. A real step that stops it sets `pruned` and rho_stop = its rho,
//   which is what the reference's masked fixed-trip scan computes.
// - A live step dequantizes max(fmaf(scale, q, off), 1e-9) (XLA:CPU
//   contracts the reference's scale * q + off into one FMA, so the kernel
//   calls it explicitly), multiplies by the term weight and adds into the
//   row's accumulator acc[n_pad], round-to-nearest each. A block holds each
//   doc once, so its adds never collide, and a barrier orders the steps.
// - The window is the multiset of the W largest partials seen after each
//   step (a doc may sit in it several times, as in the reference), kept
//   sorted descending in shared memory. A step's new partials are ranked
//   among themselves, and the two sorted lists merge by rank into the
//   other half of a double buffer; a step whose partials all fall at or
//   below the window's last value leaves it as it is.
//
// After the scan the block walks the scored blocks again (the schedule's
// first n_sc steps). Each doc's partial
// is taken with atomicExch(acc, 0): the one thread that reads it positive
// owns the doc (counts it in `matched` and offers it to the running top-R,
// keyed (value desc, doc asc) as lax.top_k breaks ties), and the
// accumulator is left zero for the next launch without a memset. Then the
// verdict, in the reference's f32 order:
//   unsafe = (matched > R & cv[R-1] + slack >= theta_end)
//          | (pruned & (cv[R-1] + slack) + max(rho_stop, 0) >= theta_end)
// and the R survivors are sorted doc-ascending (bitonic, in their output
// slice), empty slots as (n_pad, -inf) at the end.
//
// Bound (as chip_smoke.py counts it): each input read once and each output
// written once, of what the launch needs: 5 bytes a real posting of a
// scored block and 8 bytes (scale, off) a scored block, 12 bytes (sched,
// w, rho) a scored step and 8 more for the step that stops a pruned scan,
// the slack, and the survivors and counts. The accumulator is the kernel's
// own workspace, not an input or an output, so its read-modify-write is
// not counted. The scan is serial per (query, shard), with three barriers
// a live step, so with one block per (b, s) this simple form is latency
// bound: 16 blocks at B = 16, S = 1 leave most of the card's 132 SMs idle.

#include "topk_common.cuh"

#include <stdint.h>

// number of leading entries of a descending list that are >= v (or > v)
template <bool kStrict>
__device__ __forceinline__ int count_above(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (kStrict ? a[mid] > v : a[mid] >= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kTopShared>
__global__ void blockmax_scan_kernel(
    const int* __restrict__ t_docs, const int8_t* __restrict__ t_codes,
    const float* __restrict__ t_scale, const float* __restrict__ t_off,
    int NB1, int BS, const int* __restrict__ sched,
    const float* __restrict__ wts, const float* __restrict__ rho,
    const float* __restrict__ slack, int S, int P, int n_pad, int NB, int W,
    int R, int kq_idx, int prune_active, float* __restrict__ acc,
    int* __restrict__ out_ci,
    float* __restrict__ out_cv, int* __restrict__ out_counts) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  float* win = reinterpret_cast<float*>(smem);          // [W]
  float* win2 = win + W;                                // [W]
  float* newv = win2 + W;                               // [BS]
  float* nsort = newv + BS;                             // [BS]
  float* buf_s = nsort + BS;                            // [T]
  int* buf_d = reinterpret_cast<int*>(buf_s + T);       // [T]
  __shared__ int filled, ncand[3], n_match;

  const int row = blockIdx.x;                           // b * S + s
  const int rows = gridDim.x;
  const int s = row % S;
  const int tid = threadIdx.x;
  float* top_s = kTopShared ? reinterpret_cast<float*>(buf_d + T)
                            : out_cv + (size_t)row * R;
  int* top_d = kTopShared ? reinterpret_cast<int*>(top_s + R)
                          : out_ci + (size_t)row * R;
  const int* sch = sched + (size_t)row * P;
  const float* w_r = wts + (size_t)row * P;
  const float* rho_r = rho + (size_t)row * P;
  const float slk = slack[row];
  float* acc_r = acc + (size_t)row * n_pad;
  const size_t tier_s = (size_t)s * NB1;

  for (int i = tid; i < W; i += T) win[i] = -CUDART_INF_F;
  __syncthreads();

  // ---- the scan (every thread holds the same control state) -------------
  bool pruned = false;
  float rho_stop = -CUDART_INF_F;
  int n_sc = 0;
  for (int i = 0; i < P; ++i) {
    const float theta =
        prune_active ? __fsub_rn(win[kq_idx], slk) : -CUDART_INF_F;
    if (sch[i] == NB) break;              // the schedule's padded tail
    if (!(rho_r[i] >= theta)) {           // the first real step to fail
      pruned = true;
      rho_stop = rho_r[i];
      break;
    }
    const int blk = sch[i];
    const float wb = w_r[i];
    ++n_sc;
    float av = -CUDART_INF_F;
    if (tid < BS) {
      const size_t o = (tier_s + blk) * BS + tid;
      const int d = t_docs[o];
      if (d < n_pad) {
        const float vh = fmaxf(
            __fmaf_rn(t_scale[tier_s + blk], (float)t_codes[o],
                      t_off[tier_s + blk]),
            1e-9f);
        av = __fadd_rn(acc_r[d], __fmul_rn(wb, vh));
        acc_r[d] = av;
      }
    }
    // merge the step's partials into the window (values only)
    if (__syncthreads_or(av > win[W - 1])) {
      if (tid < BS) newv[tid] = av;
      __syncthreads();
      if (tid < BS) {
        int rank = 0;
        for (int j = 0; j < BS; ++j) {
          float x = newv[j];
          rank += (x > av) || (x == av && j < tid);
        }
        nsort[rank] = av;
      }
      __syncthreads();
      if (tid < BS) {
        const float v = nsort[tid];
        const int pos = tid + count_above<false>(win, W, v);
        if (pos < W) win2[pos] = v;
      }
      for (int e = tid; e < W; e += T) {
        const float x = win[e];
        const int pos = e + count_above<true>(nsort, BS, x);
        if (pos < W) win2[pos] = x;
      }
      __syncthreads();
      float* t = win;
      win = win2;
      win2 = t;
    }
  }
  const float theta_end =
      prune_active ? __fsub_rn(win[kq_idx], slk) : -CUDART_INF_F;

  // ---- survivors: each seen doc once, accumulator cleared ---------------
  if (tid == 0) {
    filled = 0;
    ncand[0] = 0;
    n_match = 0;
  }
  __syncthreads();
  RunningTopK top{top_s, top_d, &filled, R};
  CandBuffer cand{buf_s, buf_d, ncand};
  const long long total = (long long)n_sc * BS;
  int round = 0;
  for (long long base = 0; base < total; base += T, ++round) {
    cand.reset_next(round);
    const long long t = base + tid;
    if (t < total) {
      const int blk = sch[t / BS];
      const int d = t_docs[(tier_s + blk) * BS + (int)(t % BS)];
      if (d < n_pad) {
        const float old = atomicExch(acc_r + d, 0.0f);
        if (old > 0.0f) {
          atomicAdd(&n_match, 1);
          if (top.beats(old, d)) cand.push(round, old, d);
        }
      }
    }
    cand.flush(round, top);
  }
  __syncthreads();

  // ---- verdict -----------------------------------------------------------
  const int f = filled;
  float* ov = out_cv + (size_t)row * R;
  int* oi = out_ci + (size_t)row * R;
  if (tid == 0) {
    const float cv_last = f >= R ? top_s[R - 1] : -CUDART_INF_F;
    const float rho_eff = fmaxf(rho_stop, 0.0f);
    const float edge = __fadd_rn(cv_last, slk);
    const bool unsafe = (n_match > R && edge >= theta_end) ||
                        (pruned && __fadd_rn(edge, rho_eff) >= theta_end);
    out_counts[row] = n_match;
    out_counts[rows + row] = unsafe ? 1 : 0;
    out_counts[2 * rows + row] = pruned ? 1 : 0;
    out_counts[3 * rows + row] = n_sc;
  }

  // ---- survivors doc-ascending (bitonic over the R output slots) ---------
  for (int j = tid; j < R; j += T) {
    if (j < f) {
      if (kTopShared) {
        ov[j] = top_s[j];
        oi[j] = top_d[j];
      }
    } else {
      ov[j] = -CUDART_INF_F;
      oi[j] = n_pad;
    }
  }
  __syncthreads();
  for (int size = 2; size <= R; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = tid; j < (R >> 1); j += T) {
        const int lo = 2 * stride * (j / stride) + (j % stride);
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const int dl = oi[lo], dh = oi[hi];
        if ((dl > dh) == asc) {
          const float vl = ov[lo];
          oi[lo] = dh;
          oi[hi] = dl;
          ov[lo] = ov[hi];
          ov[hi] = vl;
        }
      }
      __syncthreads();
    }
  }
}

// threads per block: one per posting of a tier block, a multiple of 32
static int k4_threads(int BS) {
  int t = ((BS + 31) / 32) * 32;
  return t < 128 ? 128 : t;
}

extern "C" int es_blockmax_scan(
    const int* t_docs, const int8_t* t_codes, const float* t_scale,
    const float* t_off, int NB1, int BS, const int* sched, const float* wts,
    const float* rho, const float* slack, int B, int S, int P, int n_pad,
    int NB, int W, int R, int kq_idx, int prune_active, float* acc,
    int* out_ci, float* out_cv, int* out_counts,
    void* stream) {
  const int T = k4_threads(BS);
  if (T > 1024) return (int)cudaErrorInvalidValue;
  size_t shm = (size_t)(2 * W + 2 * BS) * 4 + (size_t)T * 8;
  const bool top_shared =
      shm + (size_t)R * 8 <= (size_t)es_max_shared_bytes();
  if (top_shared) shm += (size_t)R * 8;
  auto kernel = top_shared ? blockmax_scan_kernel<true>
                           : blockmax_scan_kernel<false>;
  int e = es_set_shared(kernel, shm);
  if (e != 0) return e;
  const int rows = B * S;
  kernel<<<rows, T, shm, (cudaStream_t)stream>>>(
      t_docs, t_codes, t_scale, t_off, NB1, BS, sched, wts, rho, slack, S, P,
      n_pad, NB, W, R, kq_idx, prune_active, acc, out_ci, out_cv,
      out_counts);
  return (int)cudaGetLastError();
}
