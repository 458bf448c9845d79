// K17: postings-run match counts.
//
// Replaces elasticsearch_tpu/ops/masks.py:_postings_match_kernel (:16,
// get_postings_match_kernel): the same gather of Q postings runs (starts,
// lengths, at most L postings a run) as K16, and for each valid posting
// one added to matched[doc] (i32[seg_pad]); callers derive masks (> 0 any,
// == Q all). A run may hold a doc more than once (a prefix query passes
// one run over several terms' postings): each occurrence counts.
//
// Index rules as K16 (the reference's jnp.take fill and .at[].add drop): a
// postings index or a doc in [-n, 0) wraps, any other index outside
// [0, n) reads the fill doc seg_pad or drops its update.
//
// One cooperative launch (k17_kernel), one device event a call: the blocks
// zero matched by grid stride (16-byte stores), the grid meets one barrier,
// then the valid postings of all runs, numbered as one sequence by a
// prefix of the runs' lengths (each cut at L, on the host), are dealt
// evenly round the grid's threads, K17_UNROLL a thread a step with their
// loads issued together: a thread finds a posting's run by a binary
// search of the prefix and adds one to its doc's count (an integer atomic:
// exact in any order). So every block has the same work, whatever the
// runs' lengths. The runs' starts and prefix ride in the launch's
// parameters up to K17_QMAX runs (es_postings_match_param_runs), so a call
// copies nothing to the card; past that they come from one upload.
//
// Bound: bytes (the count array written once, then 4 bytes of doc id a
// valid posting read and one 4-byte count updated).

#include <climits>
#include <cooperative_groups.h>

#include "topk_common.cuh"

namespace cg = cooperative_groups;

#define K17_THREADS 512
#define K17_UNROLL 4
// Runs whose start and prefix ride in the launch's parameters.
#define K17_QMAX 64

// The runs as 2 Q + 1 words: start[Q], then the prefix off[Q + 1] of their
// valid lengths (off[0] = 0).
struct K17Runs {
  long long w[2 * K17_QMAX + 1];
};

__global__ void __launch_bounds__(K17_THREADS)
k17_kernel(const int* __restrict__ docs, long long P, K17Runs rp,
           const long long* __restrict__ g, int Q, int seg_pad,
           int* __restrict__ matched) {
  __shared__ long long runs_s[2 * K17_QMAX + 1];
  const long long* runs = g;
  if (g == nullptr) {
    for (int i = threadIdx.x; i < 2 * Q + 1; i += K17_THREADS)
      runs_s[i] = rp.w[i];
    runs = runs_s;
  }
  const long long nthr = (long long)gridDim.x * K17_THREADS;
  const long long gt = (long long)blockIdx.x * K17_THREADS + threadIdx.x;
  // zero the counts: 16-byte stores where matched is 16-byte aligned
  const long long n4 = ((uintptr_t)matched % 16 == 0) ? seg_pad / 4 : 0;
  for (long long i = gt; i < n4; i += nthr)
    reinterpret_cast<int4*>(matched)[i] = make_int4(0, 0, 0, 0);
  for (long long i = 4 * n4 + gt; i < seg_pad; i += nthr) matched[i] = 0;
  cg::this_grid().sync();

  const long long* start = runs;
  const long long* off = runs + Q;
  const long long T = off[Q];
  for (long long t0 = gt; t0 < T; t0 += K17_UNROLL * nthr) {
    int doc[K17_UNROLL];
#pragma unroll
    for (int u = 0; u < K17_UNROLL; ++u) {
      const long long t = t0 + u * nthr;
      doc[u] = INT_MIN;  // no posting: dropped, as a doc below -seg_pad
      if (t < T) {
        int lo = 0, hi = Q - 1;  // the last run with off[r] <= t
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (off[mid] <= t)
            lo = mid;
          else
            hi = mid - 1;
        }
        long long idx = start[lo] + (t - off[lo]);
        if (idx < 0) idx += P;
        doc[u] = (idx >= 0 && idx < P) ? __ldg(docs + idx) : seg_pad;
      }
    }
#pragma unroll
    for (int u = 0; u < K17_UNROLL; ++u) {
      const long long sd =
          doc[u] < 0 ? (long long)doc[u] + seg_pad : (long long)doc[u];
      if (sd >= 0 && sd < seg_pad) atomicAdd(&matched[sd], 1);
    }
  }
}

// The runs a launch takes in its parameters: past them the wrapper passes
// dev_runs.
extern "C" int es_postings_match_param_runs(void) { return K17_QMAX; }

// host_runs: the runs' 2 Q + 1 words on the host (K17Runs' layout, the
// lengths already cut at L); dev_runs: the same on the card, needed (and
// read) only past K17_QMAX runs. out_matched: i32[seg_pad].
extern "C" int es_postings_match(const int* docs, long long P,
                                 const long long* host_runs,
                                 const long long* dev_runs, int Q,
                                 int seg_pad, int* out_matched,
                                 void* stream) {
  if (seg_pad <= 0) return 0;
  if (Q < 0 || host_runs == nullptr) return ES_ERR_SIZE;
  K17Runs rp;
  const long long* g = nullptr;
  if (Q <= K17_QMAX) {
    for (int i = 0; i < 2 * Q + 1; ++i) rp.w[i] = host_runs[i];
  } else {
    if (dev_runs == nullptr) return (int)cudaErrorInvalidValue;
    g = dev_runs;
  }
  static int per_sm = -1;
  if (per_sm < 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k17_kernel,
                                                  K17_THREADS, 0);
  if (per_sm < 1) return ES_ERR_SHARED;
  // enough blocks for the zeroing's and the postings' steps, at most the
  // blocks the card holds at once
  const long long T = host_runs[2 * Q];
  const long long step = (long long)K17_THREADS * 4;
  long long want = ((long long)seg_pad + step - 1) / step;
  const long long want_t = (T + step - 1) / step;
  if (want_t > want) want = want_t;
  const long long full = (long long)per_sm * es_sm_count();
  const int grid = (int)(want < 1 ? 1 : (want > full ? full : want));
  void* args[] = {(void*)&docs, (void*)&P,  (void*)&rp,  (void*)&g,
                  (void*)&Q,    (void*)&seg_pad, (void*)&out_matched};
  const cudaError_t ce =
      cudaLaunchCooperativeKernel((const void*)k17_kernel, dim3(grid),
                                  dim3(K17_THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}
