// Shared pieces of the port's kernels: the (score desc, doc asc) key order
// every top-k in the engine uses (Lucene's tie order), and a block-wide
// running top-k kept sorted in shared memory.
//
// The running top-k works in rounds. In a round every thread offers at most
// a few (score, doc) keys; a key that beats the current k-th key is appended
// to a shared candidate buffer through an atomic counter. After a barrier,
// if the buffer is not empty, thread 0 inserts its keys into the sorted list
// and a second barrier publishes the list. Keys are unique (one per doc), so
// the final list does not depend on the order in which they arrived. Three
// rotating counters let a round reset the next round's counter without a
// third barrier: the counter reset at the start of round r was last read in
// round r-2, which every thread has left once thread 0 passed round r-1's
// barrier. The list lives in shared memory when it fits, else in the
// block's own slice of its output in device memory (the code is the same).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

// Returned by a C entry when the sizes it was given need more shared memory
// than the card lets one block have (no cudaError_t takes this value).
#define ES_ERR_SHARED (-1)
// Returned by a C entry given a mode or method code it does not know.
#define ES_ERR_ARG (-2)
// Returned by a C entry given a size outside the range it accepts (its
// comment names the range; the Python wrappers check it first).
#define ES_ERR_SIZE (-3)

// Bytes of shared memory one block may opt in to on the current card.
static int es_max_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

// The SMs of the current card.
static int es_sm_count() {
  static int n = -1;
  if (n < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Bytes of static shared memory a kernel declares.
template <typename Kernel>
static size_t es_static_shared_bytes(Kernel kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  return attr.sharedSizeBytes;
}

// Sets a kernel's dynamic shared memory, or returns ES_ERR_SHARED when it
// and the kernel's static shared memory exceed what a block may have.
template <typename Kernel>
static int es_set_shared(Kernel kernel, size_t bytes) {
  if (bytes + es_static_shared_bytes(kernel) >
      (size_t)es_max_shared_bytes())
    return ES_ERR_SHARED;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The text of a code a C entry returned.
extern "C" const char* es_error_string(int code) {
  if (code == ES_ERR_SHARED)
    return "the sizes need more shared memory than the card gives a block";
  if (code == ES_ERR_ARG) return "unknown mode or method code";
  if (code == ES_ERR_SIZE)
    return "a size argument is outside the range the entry accepts";
  return cudaGetErrorString((cudaError_t)code);
}

__device__ __forceinline__ bool key_better(float s1, int d1, float s2,
                                           int d2) {
  return s1 > s2 || (s1 == s2 && d1 < d2);
}

struct RunningTopK {
  float* s;       // [k] scores, best first
  int* d;         // [k] docs
  int* filled;    // number of valid entries (<= k)
  int k;

  __device__ __forceinline__ bool beats(float sc, int doc) const {
    int f = *filled;
    return f < k || key_better(sc, doc, s[k - 1], d[k - 1]);
  }

  // single-thread insertion of one key (caller is thread 0)
  __device__ void insert(float sc, int doc) {
    int f = *filled;
    int j;
    if (f < k) {
      j = f;
      *filled = f + 1;
    } else {
      if (!key_better(sc, doc, s[k - 1], d[k - 1])) return;
      j = k - 1;
    }
    while (j > 0 && key_better(sc, doc, s[j - 1], d[j - 1])) {
      s[j] = s[j - 1];
      d[j] = d[j - 1];
      --j;
    }
    s[j] = sc;
    d[j] = doc;
  }

  __device__ void write(float* out_s, int* out_d, int fill_doc) const {
    int f = *filled;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      out_s[i] = i < f ? s[i] : -CUDART_INF_F;
      out_d[i] = i < f ? d[i] : fill_doc;
    }
  }
};

// Candidate buffer shared by the rounds of one block.
struct CandBuffer {
  float* s;
  int* d;
  int* count;     // [3] rotating counters

  __device__ __forceinline__ void push(int round, float sc, int doc) {
    int i = atomicAdd(&count[round % 3], 1);
    s[i] = sc;
    d[i] = doc;
  }

  // thread 0, at the start of round r, before anyone pushes in round r+1
  __device__ __forceinline__ void reset_next(int round) {
    if (threadIdx.x == 0) count[(round + 1) % 3] = 0;
  }

  // barrier, then merge this round's keys into ``top``; every thread calls
  __device__ void flush(int round, RunningTopK& top) {
    __syncthreads();
    int n = count[round % 3];
    if (n > 0) {
      if (threadIdx.x == 0)
        for (int i = 0; i < n; ++i) top.insert(s[i], d[i]);
      __syncthreads();
    }
  }
};
