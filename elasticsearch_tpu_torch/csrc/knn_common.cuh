// The per-query running top-k lists of one block of K6 (knn_scan.cu).
//
// Each query keeps a list of its k best (score, id) keys, sorted best first
// under (score desc, id asc), and the list's k-th key as a threshold once
// full. In a tile a thread offers its scores that beat the threshold to the
// query's candidate buffer (at most one per row, so KS_ROWS slots; the
// lanes of a warp that offer to one query take their slots with one
// shared-memory atomic); after a barrier the lists merge with their
// candidates by rank, a warp to a query: a list entry moves down by the
// candidates better than it, a candidate lands after the list entries
// better than it (a binary search) and the other candidates better than
// it. Ids are unique, so the ranks are a permutation and the result
// does not depend on the order the candidates arrived in. The lists live in
// shared memory when they fit, else in the block's slice of its output and
// of a workspace in device memory (the code is the same).
#pragma once

#include "topk_common.cuh"

#define KS_THREADS 256
#define KS_ROWS 128
#define KS_BT 16

// The lists and their merge buffers.
static size_t ks_list_bytes(int bt, int k) { return (size_t)4 * bt * k * 4; }

struct QueryLists {
  float* v;         // query q's list at v + q * qstride, best first
  int* id;
  size_t qstride;
  float* tv;        // merge buffer at tv + q * tstride
  int* tid;
  size_t tstride;
  float* cv;        // [bt][KS_ROWS] candidates of the tile
  int* cid;
  int* filled;      // [bt] entries in the list
  int* ncand;       // [bt] candidates of the tile
  float* thr_v;     // [bt] the k-th key, once the list is full
  int* thr_id;
  int k;
  int bt;

  __device__ __forceinline__ bool beats(int q, float sc, int key) const {
    return filled[q] < k || key_better(sc, key, thr_v[q], thr_id[q]);
  }

  // Offer (sc, key) to query q where `want`, every lane of the warp
  // calling it, each with its own q: the lanes that offer to one query take
  // their slots with one shared-memory atomic.
  __device__ __forceinline__ void push(int q, bool want, float sc,
                                       int key) {
    const unsigned act = __ballot_sync(0xffffffffu, want);
    if (!want) return;
    const unsigned grp = __match_any_sync(act, q);
    const int lane = threadIdx.x & 31, leader = __ffs(grp) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&ncand[q], __popc(grp));
    base = __shfl_sync(grp, base, leader);
    const int i = base + __popc(grp & ((1u << lane) - 1u));
    cv[q * KS_ROWS + i] = sc;
    cid[q * KS_ROWS + i] = key;
  }

  // Merge every list with its candidates, a warp to a query (queries w,
  // w + warps, ...); all threads, after a barrier.
  __device__ void merge() {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int q = threadIdx.x >> 5; q < bt; q += nw) {
      const int nc = ncand[q];
      if (nc == 0) continue;
      const int f = filled[q];
      const float* lv = v + q * qstride;
      const int* li = id + q * qstride;
      const float* c_v = cv + q * KS_ROWS;
      const int* c_i = cid + q * KS_ROWS;
      for (int e = lane; e < f + nc; e += 32) {
        float ev;
        int ei, rank;
        if (e < f) {
          ev = lv[e];
          ei = li[e];
          rank = e;
        } else {
          ev = c_v[e - f];
          ei = c_i[e - f];
          int lo = 0, hi = f;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (key_better(lv[mid], li[mid], ev, ei))
              lo = mid + 1;
            else
              hi = mid;
          }
          rank = lo;
        }
#pragma unroll 4
        for (int c = 0; c < nc; ++c)
          rank += key_better(c_v[c], c_i[c], ev, ei);
        if (rank < k) {
          tv[q * tstride + rank] = ev;
          tid[q * tstride + rank] = ei;
        }
      }
      __syncwarp();
      const int nf = min(k, f + nc);
      for (int e = lane; e < nf; e += 32) {
        v[q * qstride + e] = tv[q * tstride + e];
        id[q * qstride + e] = tid[q * tstride + e];
      }
      __syncwarp();
      if (lane == 0) {
        filled[q] = nf;
        if (nf == k) {
          thr_v[q] = v[q * qstride + k - 1];
          thr_id[q] = id[q * qstride + k - 1];
        }
        ncand[q] = 0;
      }
    }
    __syncthreads();
  }

  // Query q's list into out (k slots), (-inf, fill) past its entries; when
  // the list lives in out already, only the fill is written.
  __device__ void write(int q, float* out_v, int* out_i, int fill,
                        bool in_place) const {
    const int f = filled[q];
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      if (i >= f) {
        out_v[i] = -CUDART_INF_F;
        out_i[i] = fill;
      } else if (!in_place) {
        out_v[i] = v[q * qstride + i];
        out_i[i] = id[q * qstride + i];
      }
    }
  }
};

// The block's lists: in shared memory after `dyn` (kShared), else in the
// output slice of the block (query q at out + q * ostride) with their merge
// buffers in the workspace at the same offsets.
__device__ __forceinline__ QueryLists ks_lists(
    bool shared, unsigned char* dyn, float* out_v, int* out_i, float* ws_v,
    int* ws_i, size_t ostride, float* cv, int* cid, int* filled, int* ncand,
    float* thr_v, int* thr_id, int k, int bt) {
  QueryLists L;
  if (shared) {
    L.v = reinterpret_cast<float*>(dyn);
    L.id = reinterpret_cast<int*>(L.v + (size_t)bt * k);
    L.tv = reinterpret_cast<float*>(L.id + (size_t)bt * k);
    L.tid = reinterpret_cast<int*>(L.tv + (size_t)bt * k);
    L.qstride = L.tstride = k;
  } else {
    L.v = out_v;
    L.id = out_i;
    L.tv = ws_v;
    L.tid = ws_i;
    L.qstride = L.tstride = ostride;
  }
  L.cv = cv;
  L.cid = cid;
  L.filled = filled;
  L.ncand = ncand;
  L.thr_v = thr_v;
  L.thr_id = thr_id;
  L.k = k;
  L.bt = bt;
  return L;
}
