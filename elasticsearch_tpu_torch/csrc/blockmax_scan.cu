// K4: block-max pruned scan, survivor selection and safety verdict.
//
// Replaces the per_query scan of elasticsearch_tpu/parallel/dist_search.py:
// build_pruned_bm25_step, up to and including the top-R survivors, the
// safety verdict and the doc-ascending sort of the survivors (its exact
// re-score is K5, its top-k K3).
//
// The function. Each row (query b, shard s) walks its schedule, serially:
//
// - Before each step it reads the threshold theta = window[kq_idx] - slack
//   (-inf when pruning is inert). A step is live iff its block id is not
//   the pad id NB and its remaining bound mass rho >= theta. The
//   schedule's rho never rises and its pad steps come only at its end
//   (BlockMaxTier.schedule makes it so), and theta never falls, so once a
//   step is not live no later one is: the scan stops there. A real step
//   that stops it sets `pruned` and rho_stop = its rho, which is what the
//   reference's masked fixed-trip scan computes.
// - A live step dequantizes max(fmaf(scale, q, off), 1e-9) (XLA:CPU
//   contracts the reference's scale * q + off into one FMA, so the kernel
//   calls it explicitly), multiplies by the term weight and adds into the
//   row's accumulator acc[n_pad], round-to-nearest each; a block holds
//   each doc once.
// - The window is the multiset of the W largest partials seen after each
//   step (a doc may sit in it several times, as in the reference).
// - After the scan each doc with a positive partial is matched once, the R
//   best (value desc, doc asc, as lax.top_k breaks ties) are the
//   survivors, and the verdict is, in the reference's f32 order:
//     unsafe = (matched > R & cv[R-1] + slack >= theta_end)
//            | (pruned & (cv[R-1] + slack) + max(rho_stop, 0) >= theta_end)
//   The survivors come doc-ascending, empty slots as (n_pad, -inf) at the
//   end; the accumulator is left zero for the next launch.
//
// Design: three kernels, one C entry.
//
// 1. The scan, one block a row, a thread a posting of a tier block (the
//    scan is serial by definition: theta after a step decides whether the
//    next is live). Its memory chain is taken off the critical path:
//    - the tier blocks of the next K4_LEAD steps ride in a shared-memory
//      ring (cp.async: docs, codes, scale, off);
//    - once a block has landed, K4_AHEAD steps before it is scanned, its
//      docs' accumulator lines are prefetched into L1, so the step's
//      read-modify-write hits L1. A prefetch is a hint: the step's load
//      still reads the latest value, whichever earlier step wrote the doc
//      (a first form gathered the values into the ring and looked each
//      doc up in the steps since, which cost more than the loads it hid);
//    - the schedule's next entries load into registers a step ahead.
//    A step's partials that beat the window's last value are compacted
//    (a ballot a warp); a step with none takes two barriers. Else the
//    window merges in place: each such partial's place is its rank among
//    them plus the entries >= it (a binary search), each entry below the
//    largest of them moves down by the partials above it; one more
//    barrier between the reads and the writes.
// 2. The survivors, G blocks a row (the plan: ops/blockmax.py:
//    blockmax_scan_plan), each over a slice of the scored blocks'
//    postings: atomicExch(acc, 0) gives each doc one owner (which counts
//    it in integers and offers it to the block's top-R, merged block-wide
//    as tile_topk.cuh's tt_take does) and leaves the workspace clean.
// 3. The finish, one block a row: the G lists sorted as one (bitonic, in
//    shared memory; their first R are the top-R), the G counts summed, the
//    verdict, and the survivors sorted doc-ascending (bitonic).
//
// Bound (as chip_smoke.py counts it): each input read once and each output
// written once, of what the launch needs: 5 bytes a real posting of a
// scored block and 8 bytes (scale, off) a scored block, 12 bytes (sched,
// w, rho) a scored step and 8 more for the step that stops a pruned scan,
// the slack, and the survivors and counts. The accumulator is the kernel's
// own workspace, not an input or an output, so its read-modify-write is
// not counted. The scan of the longest row is serial, so the launch is
// latency bound: its steps times a step's barriers and shared-memory work.

#include "tile_topk.cuh"

#include <limits.h>
#include <stdint.h>

// Steps ahead whose accumulator lines are prefetched into L1.
#define K4_AHEAD 4
// Steps ahead whose tier blocks are copied: twice K4_AHEAD, so that a
// block has landed when its docs' lines are prefetched.
#define K4_LEAD (2 * K4_AHEAD)
// Window entries a thread moves at most in a merge (W <= K4_ENTRIES * T).
#define K4_ENTRIES 8
// Threads of a survivor block.
#define K4_SV_THREADS 256

__device__ __forceinline__ void k4_cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void k4_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// f32 -> i32 keeping the order (for a shared atomicMax), and back.
__device__ __forceinline__ int k4_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float k4_unkey(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// number of leading entries of a descending list that are >= v
__device__ __forceinline__ int k4_count_ge(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The scan's shared memory: the window, a step's compacted partials, and
// the ring of tier blocks (docs, codes, scale and off a slot).
struct K4Ring {
  float* win;            // [W]
  float* nv;             // [T]
  int* docs;             // [LEAD][BS]
  float* scale;          // [LEAD]
  float* off;            // [LEAD]
  signed char* codes;    // [LEAD][BS4]
  int BS, BS4;

  __device__ K4Ring(unsigned char* smem, int W, int T, int BS_)
      : BS(BS_), BS4((BS_ + 3) & ~3) {
    win = reinterpret_cast<float*>(smem);
    nv = win + W;
    docs = reinterpret_cast<int*>(nv + T);
    scale = reinterpret_cast<float*>(docs + K4_LEAD * BS);
    off = scale + K4_LEAD;
    codes = reinterpret_cast<signed char*>(off + K4_LEAD);
  }

  static size_t bytes(int W, int T, int BS) {
    return (size_t)(W + T) * 4 + (size_t)K4_LEAD * BS * 4 +
           (size_t)K4_LEAD * 8 + (size_t)K4_LEAD * ((BS + 3) & ~3);
  }

  // tier block blk (of shard offset tier_s) into slot: cp.async, except
  // codes when BS is not a multiple of 4 (plain loads then)
  __device__ void fetch(int slot, int blk, size_t tier_s,
                        const int* t_docs, const int8_t* t_codes,
                        const float* t_scale, const float* t_off) {
    const int tid = threadIdx.x;
    const size_t o = (tier_s + blk) * BS;
    if (tid < BS) k4_cp4(docs + slot * BS + tid, t_docs + o + tid);
    if ((BS & 3) == 0) {
      if (tid < (BS >> 2))
        k4_cp4(codes + slot * BS4 + 4 * tid, t_codes + o + 4 * tid);
    } else if (tid < BS) {
      codes[slot * BS4 + tid] = t_codes[o + tid];
    }
    if (tid == 0) {
      k4_cp4(scale + slot, t_scale + tier_s + blk);
      k4_cp4(off + slot, t_off + tier_s + blk);
    }
  }

  // the accumulator lines of a landed slot's real docs, into L1
  __device__ void prefetch(int slot, const float* acc_r, int n_pad) const {
    const int tid = threadIdx.x;
    if (tid < BS) {
      const int d = docs[slot * BS + tid];
      if (d < n_pad)
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(acc_r + d));
    }
  }
};

// Grid B * S, T >= BS threads. Writes each row's scan state (theta_end,
// rho_stop as f32 bits, n_sc, pruned) to state[row * 4 ..].
__global__ void __launch_bounds__(1024)
k4_scan(const int* __restrict__ t_docs, const int8_t* __restrict__ t_codes,
        const float* __restrict__ t_scale, const float* __restrict__ t_off,
        int NB1, int BS, const int* __restrict__ sched,
        const float* __restrict__ wts, const float* __restrict__ rho,
        const float* __restrict__ slack, int S, int P, int n_pad, int NB,
        int W, int kq_idx, int prune_active, float* __restrict__ acc,
        int* __restrict__ state) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  K4Ring ring(smem, W, T, BS);
  __shared__ int n_new[3], max_new[3];

  const int row = blockIdx.x;                           // b * S + s
  const int s = row % S;
  const int tid = threadIdx.x;
  const int* sch = sched + (size_t)row * P;
  const float* w_r = wts + (size_t)row * P;
  const float* rho_r = rho + (size_t)row * P;
  const float slk = slack[row];
  float* acc_r = acc + (size_t)row * n_pad;
  const size_t tier_s = (size_t)s * NB1;

  for (int i = tid; i < W; i += T) ring.win[i] = -CUDART_INF_F;
  if (tid == 0) {
    n_new[0] = 0;
    max_new[0] = INT_MIN;
  }
  // the first K4_LEAD blocks, then the first K4_AHEAD steps' lines
  for (int i = 0; i < K4_LEAD; ++i)
    ring.fetch(i, i < P ? sch[i] : NB, tier_s, t_docs, t_codes, t_scale,
               t_off);
  k4_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < K4_AHEAD; ++i) ring.prefetch(i, acc_r, n_pad);

  bool pruned = false;
  float rho_stop = -CUDART_INF_F;
  int n_sc = 0;
  int cur_blk = P > 0 ? sch[0] : NB;
  float cur_w = P > 0 ? w_r[0] : 0.0f;
  float cur_rho = P > 0 ? rho_r[0] : 0.0f;
  int lead_blk = K4_LEAD < P ? sch[K4_LEAD] : NB;
  int slot = 0, slot_ahead = K4_AHEAD;
  for (int j = 0; j < P; ++j) {
    // the block of step j + K4_AHEAD has landed (its copies were issued
    // K4_AHEAD steps ago), and the last merge is done
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K4_AHEAD - 1)
                 : "memory");
    __syncthreads();
    const float theta =
        prune_active ? __fsub_rn(ring.win[kq_idx], slk) : -CUDART_INF_F;
    if (cur_blk == NB) break;             // the schedule's padded tail
    if (!(cur_rho >= theta)) {            // the first real step to fail
      pruned = true;
      rho_stop = cur_rho;
      break;
    }
    ++n_sc;
    // the next step's schedule entries, in flight during this one
    const int nxt_blk = j + 1 < P ? sch[j + 1] : NB;
    const float nxt_w = j + 1 < P ? w_r[j + 1] : 0.0f;
    const float nxt_rho = j + 1 < P ? rho_r[j + 1] : 0.0f;
    const int nxt_lead = j + 1 + K4_LEAD < P ? sch[j + 1 + K4_LEAD] : NB;
    float av = -CUDART_INF_F;
    if (tid < BS) {
      const int d = ring.docs[slot * BS + tid];
      if (d < n_pad) {
        const float vh = fmaxf(
            __fmaf_rn(ring.scale[slot],
                      (float)ring.codes[slot * ring.BS4 + tid],
                      ring.off[slot]),
            1e-9f);
        // its line prefetched K4_AHEAD steps ago; only this block writes
        // the row, each step's writes before a barrier, so the load reads
        // the latest value
        av = __fadd_rn(acc_r[d], __fmul_rn(cur_w, vh));
        acc_r[d] = av;
      }
    }
    // the partials that beat the window's last value, compacted
    const int c3 = j % 3;
    if (tid == 0) {
      n_new[(j + 1) % 3] = 0;
      max_new[(j + 1) % 3] = INT_MIN;
    }
    const bool is_c = av > ring.win[W - 1];
    const unsigned m = __ballot_sync(0xffffffffu, is_c);
    if (m) {
      const int lane = tid & 31, lead = __ffs(m) - 1;
      int key = is_c ? k4_key(av) : INT_MIN;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
      int base = 0;
      if (lane == lead) {
        base = atomicAdd(&n_new[c3], __popc(m));
        atomicMax(&max_new[c3], key);
      }
      base = __shfl_sync(0xffffffffu, base, lead);
      if (is_c) ring.nv[base + __popc(m & ((1u << lane) - 1))] = av;
    }
    // this step's slot is read: copy step j + K4_LEAD's block into it, and
    // prefetch the lines of step j + K4_AHEAD's docs
    __syncthreads();
    ring.fetch(slot, lead_blk, tier_s, t_docs, t_codes, t_scale, t_off);
    ring.prefetch(slot_ahead, acc_r, n_pad);
    k4_commit();
    const int n = n_new[c3];
    if (n > 0) {
      // merge in place: every read before the barrier, every write after
      const float* win = ring.win;
      const int p0 = k4_count_ge(win, W, k4_unkey(max_new[c3]));
      int cpos = W;
      float cval = 0.0f;
      if (tid < n) {
        cval = ring.nv[tid];
        int rank = 0;
        for (int c = 0; c < n; ++c) {
          const float x = ring.nv[c];
          rank += (x > cval) || (x == cval && c < tid);
        }
        cpos = rank + k4_count_ge(win, W, cval);
      }
      float ev[K4_ENTRIES];
      int epos[K4_ENTRIES];
#pragma unroll
      for (int u = 0; u < K4_ENTRIES; ++u) {
        const int e = p0 + tid + u * T;
        epos[u] = W;
        ev[u] = 0.0f;
        if (e < W) {
          const float x = win[e];
          int above = 0;
          for (int c = 0; c < n; ++c) above += ring.nv[c] > x;
          ev[u] = x;
          epos[u] = e + above;
        }
      }
      __syncthreads();
      if (cpos < W) ring.win[cpos] = cval;
#pragma unroll
      for (int u = 0; u < K4_ENTRIES; ++u)
        if (epos[u] < W) ring.win[epos[u]] = ev[u];
    }
    cur_blk = nxt_blk;
    cur_w = nxt_w;
    cur_rho = nxt_rho;
    lead_blk = nxt_lead;
    slot = slot + 1 == K4_LEAD ? 0 : slot + 1;
    slot_ahead = slot_ahead + 1 == K4_LEAD ? 0 : slot_ahead + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    const float theta_end =
        prune_active ? __fsub_rn(ring.win[kq_idx], slk) : -CUDART_INF_F;
    int* o = state + (size_t)row * 4;
    o[0] = __float_as_int(theta_end);
    o[1] = __float_as_int(rho_stop);
    o[2] = n_sc;
    o[3] = pruned ? 1 : 0;
  }
}

// Grid B * S * G: block (row, g) takes postings [g * c, (g + 1) * c) of
// the row's n_sc * BS scored postings (c = ceil(n_sc * BS / G)), in rounds
// of a posting a thread; writes list row * G + g of part_vals / part_docs
// [.., R] and its count. kTopShared: the top-R and its merge buffer sit in
// shared memory, else in the block's own list (one thread inserts).
template <bool kTopShared>
__global__ void __launch_bounds__(K4_SV_THREADS)
k4_survivors(const int* __restrict__ t_docs, int NB1, int BS,
             const int* __restrict__ sched, int S, int P, int n_pad, int R,
             int G, float* __restrict__ acc, const int* __restrict__ state,
             float* __restrict__ part_vals, int* __restrict__ part_docs,
             int* __restrict__ part_count) {
  extern __shared__ unsigned char smem[];
  float* buf_s = reinterpret_cast<float*>(smem);             // [THREADS]
  int* buf_d = reinterpret_cast<int*>(buf_s + K4_SV_THREADS); // [THREADS]
  float* tail = reinterpret_cast<float*>(buf_d + K4_SV_THREADS);
  __shared__ int filled, ncand[3], n_match;
  const int row = blockIdx.x / G, g = blockIdx.x % G;
  const int s = row % S, tid = threadIdx.x;
  const size_t o = blockIdx.x;
  float* top_s = kTopShared ? tail : part_vals + o * R;
  int* top_d = kTopShared ? reinterpret_cast<int*>(tail + R)
                          : part_docs + o * R;
  const int* sch = sched + (size_t)row * P;
  float* acc_r = acc + (size_t)row * n_pad;
  const size_t tier_s = (size_t)s * NB1;
  const long long total = (long long)state[(size_t)row * 4 + 2] * BS;
  const long long chunk = (total + G - 1) / G;
  const long long t0 = min(total, g * chunk);
  const long long t1 = min(total, t0 + chunk);
  if (tid == 0) {
    filled = 0;
    ncand[0] = 0;
    n_match = 0;
  }
  __syncthreads();
  RunningTopK top{top_s, top_d, &filled, R};
  CandBuffer cand{buf_s, buf_d, ncand};
  int mine = 0;
  int round = 0;
  for (long long base = t0; base < t1; base += K4_SV_THREADS, ++round) {
    cand.reset_next(round);
    const long long t = base + tid;
    if (t < t1) {
      const int blk = sch[t / BS];
      const int d = t_docs[(tier_s + blk) * BS + (int)(t % BS)];
      if (d < n_pad) {
        const float old = atomicExch(acc_r + d, 0.0f);
        if (old > 0.0f) {
          ++mine;
          if (top.beats(old, d)) cand.push(round, old, d);
        }
      }
    }
    __syncthreads();
    tt_take<kTopShared>(ncand[round % 3], top, cand, tail + 2 * R,
                        reinterpret_cast<int*>(tail + 3 * R));
  }
  if (mine) atomicAdd(&n_match, mine);
  __syncthreads();
  top.write(part_vals + o * R, part_docs + o * R, n_pad);
  if (tid == 0) part_count[o] = n_match;
}

// Bitonic sort of n (a power of two) entries (vs, ds) in place; best
// first by key (score desc, doc asc) when by_key, else doc-ascending.
// Every thread of the block calls it.
__device__ void k4_bitonic(float* vs, int* ds, int n, bool by_key) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
        const int lo = 2 * stride * (j / stride) + (j % stride);
        const int hi = lo + stride;
        const bool fwd = (lo & size) == 0;
        const float vl = vs[lo], vh = vs[hi];
        const int dl = ds[lo], dh = ds[hi];
        const bool out = by_key ? key_better(vh, dh, vl, dl) : dl > dh;
        if (out == fwd && (by_key || dl != dh)) {
          vs[lo] = vh;
          vs[hi] = vl;
          ds[lo] = dh;
          ds[hi] = dl;
        }
      }
      __syncthreads();
    }
  }
}

// Grid B * S: a row's G lists (G a power of two) merged into its top-R,
// the counts summed, the verdict, and the survivors sorted doc-ascending.
// With G > 1 the lists sort as one, best first, in shared memory (8 G R
// bytes), and their first R are the top-R. kShared: the top-R is sorted
// by doc in shared memory and then written out (with G = 1, 8 R bytes),
// else in its output slice.
template <bool kShared>
__global__ void __launch_bounds__(K4_SV_THREADS)
k4_finish(const float* __restrict__ part_vals,
          const int* __restrict__ part_docs,
          const int* __restrict__ part_count, const int* __restrict__ state,
          const float* __restrict__ slack, int G, int R, int n_pad,
          int* __restrict__ out_ci, float* __restrict__ out_cv,
          int* __restrict__ out_counts) {
  extern __shared__ unsigned char smem[];
  __shared__ int n_valid, total;
  const int row = blockIdx.x, rows = gridDim.x, tid = threadIdx.x;
  const int n = G * R;
  const size_t base = (size_t)row * n;
  float* ov = out_cv + (size_t)row * R;
  int* oi = out_ci + (size_t)row * R;
  float* rs = kShared ? reinterpret_cast<float*>(smem) : ov;
  int* rd = kShared ? reinterpret_cast<int*>(rs + (G > 1 ? n : R)) : oi;
  if (tid == 0) {
    n_valid = 0;
    total = 0;
  }
  int my_valid = 0, my_count = 0;
  for (int h = tid; h < G; h += K4_SV_THREADS)
    my_count += part_count[(size_t)row * G + h];
  for (int j = tid; j < n; j += K4_SV_THREADS) {
    const int d = part_docs[base + j];
    my_valid += d < n_pad;
    rs[j] = part_vals[base + j];
    rd[j] = d;
  }
  if (my_valid) atomicAdd(&n_valid, my_valid);
  if (my_count) atomicAdd(&total, my_count);
  __syncthreads();
  if (G > 1) k4_bitonic(rs, rd, n, true);
  const int f = min(n_valid, R);
  if (tid == 0) {
    const int* st = state + (size_t)row * 4;
    const float theta_end = __int_as_float(st[0]);
    const float rho_stop = __int_as_float(st[1]);
    const bool pruned = st[3] != 0;
    const float cv_last = f >= R ? rs[R - 1] : -CUDART_INF_F;
    const float rho_eff = fmaxf(rho_stop, 0.0f);
    const float edge = __fadd_rn(cv_last, slack[row]);
    const bool unsafe = (total > R && edge >= theta_end) ||
                        (pruned && __fadd_rn(edge, rho_eff) >= theta_end);
    out_counts[row] = total;
    out_counts[rows + row] = unsafe ? 1 : 0;
    out_counts[2 * rows + row] = pruned ? 1 : 0;
    out_counts[3 * rows + row] = st[2];
  }
  __syncthreads();
  k4_bitonic(rs, rd, R, false);
  if (kShared) {
    for (int i = tid; i < R; i += K4_SV_THREADS) {
      ov[i] = rs[i];
      oi[i] = rd[i];
    }
  }
}

// threads of a scan block: one per posting of a tier block, a multiple of
// 32, at least 128
static int k4_threads(int BS) {
  int t = ((BS + 31) / 32) * 32;
  return t < 128 ? 128 : t;
}

// The survivor kernel's dynamic shared memory, and whether its top-R and
// merge buffer fit there.
static void k4_survivor_launch(int R, size_t* shm, bool* top_shared) {
  *shm = (size_t)K4_SV_THREADS * 8;
  *top_shared = *shm + (size_t)R * 16 <= (size_t)es_max_shared_bytes();
  if (*top_shared) *shm += (size_t)R * 16;
}

// G survivor blocks a row (a power of two; G * R * 8 bytes of the
// finish's shared memory when G > 1); part: i32 words for the G lists of
// every row (values and docs, R each), their counts and the rows' scan
// states, rows * G * (2 R + 1) + 4 rows. One call: the scan, the
// survivors, the finish.
extern "C" int es_blockmax_scan(
    const int* t_docs, const int8_t* t_codes, const float* t_scale,
    const float* t_off, int NB1, int BS, const int* sched, const float* wts,
    const float* rho, const float* slack, int B, int S, int P, int n_pad,
    int NB, int W, int R, int kq_idx, int prune_active, int G, float* acc,
    int* part, int* out_ci, float* out_cv, int* out_counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = k4_threads(BS);
  const int rows = B * S;
  if (rows == 0) return 0;
  if (T > 1024 || W < 1 || W > K4_ENTRIES * T || kq_idx < 0 ||
      kq_idx >= W || G < 1 || (G & (G - 1)) != 0 || R < 1 ||
      (R & (R - 1)) != 0)
    return ES_ERR_SIZE;
  const size_t shm = K4Ring::bytes(W, T, BS);
  int e = es_set_shared(k4_scan, shm);
  if (e != 0) return e;
  size_t sv_shm;
  bool top_shared;
  k4_survivor_launch(R, &sv_shm, &top_shared);
  auto survivors = top_shared ? k4_survivors<true> : k4_survivors<false>;
  e = es_set_shared(survivors, sv_shm);
  if (e != 0) return e;
  const size_t f_shm = (size_t)G * R * 8;
  const bool f_shared = f_shm <= (size_t)es_max_shared_bytes();
  if (G > 1 && !f_shared) return ES_ERR_SHARED;
  auto finish = f_shared ? k4_finish<true> : k4_finish<false>;
  e = es_set_shared(finish, f_shared ? f_shm : 0);
  if (e != 0) return e;
  float* part_vals = reinterpret_cast<float*>(part);
  int* part_docs = part + (size_t)rows * G * R;
  int* part_count = part_docs + (size_t)rows * G * R;
  int* state = part_count + (size_t)rows * G;
  k4_scan<<<rows, T, shm, st>>>(t_docs, t_codes, t_scale, t_off, NB1, BS,
                                sched, wts, rho, slack, S, P, n_pad, NB, W,
                                kq_idx, prune_active, acc, state);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  survivors<<<rows * G, K4_SV_THREADS, sv_shm, st>>>(
      t_docs, NB1, BS, sched, S, P, n_pad, R, G, acc, state, part_vals,
      part_docs, part_count);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  finish<<<rows, K4_SV_THREADS, f_shared ? f_shm : 0, st>>>(
      part_vals, part_docs, part_count, state, slack, G, R, n_pad, out_ci,
      out_cv, out_counts);
  return (int)cudaGetLastError();
}
