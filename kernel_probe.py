#!/usr/bin/env python3
"""Probe of K16 (``bm25_scatter``), K6 (``knn_scan``), K9
(``bool_bm25_topk``), K8 (``ivf_rerank``), K1 (``sparse_candidates_topk``),
K4 (``blockmax_scan``), K3 (``topk_merge``), K21 (``knn_outlier``), K2
(``dense_stream_topk``), K12 (``agg_masked_scan``), K14
(``agg_bucket_reduce``), K22 (``logreg_train``), K19 (``segment_topk``),
K7 (``ivf_scan``), K17 (``postings_match``), K5 (``bisect_exact_scores``),
K10 (``fuse_rank``), K11 (``rescore_reorder``), K20 (``tree_eval``), K18
(``range_mask``) and K13 (``agg_rank_pick``) on one card, at the inputs
``chip_smoke.py`` gives them on its main paths, of ``chip_smoke.py``'s
aggregation, per-segment and IVF phases (``aggs``, ``segment``, ``ivf``),
and of the pruned route and the hybrid path driven (``pruned``,
``hybrid``).

    python3 kernel_probe.py [--tree DIR]
                            [--kernels k16,k6,k9,k8,k1,k4,k3,k21,k2,k12,
                                       k14,k22,k19,k7,k17,k5,k10,k11,
                                       k20,k18,k13,aggs,segment,ivf,
                                       pruned,hybrid]
                            [--variants] [--out FILE]

``--tree`` imports ``elasticsearch_tpu_torch`` from DIR (default: this
checkout), so an unpacked earlier commit (``git archive``) is measured with
the same inputs, in the same call, as this one. Needs the card; prints
JSON lines and writes them to ``--out`` as well.

- K16 at mix (e)'s recorded first request: the headline corpus as one
  2^23-doc segment, four terms drawn as the smoke draws them. CUDA-event
  mean of the wrapper call, and the device time of each kernel or memset
  it issues (``torch.profiler``), per call.
- K6 at the hybrid's shape (2,681,468 x 768 rows, dot product, B = 16,
  k = 100) and the exact route's (1.2M x 100, cosine, B = 16, k = 100):
  the wrapper's CUDA-event mean, the bytes it must read, the achieved
  rate, and the launch's blocks per SM.
- K9 at bool mixes (c) and (d) (the prune plane, ``bool_traffic``'s
  checked batch) and at the hybrid's text side (the call
  ``fused_search_device`` makes for the hybrid's first timed batch,
  recorded with a small kNN plane beside the full text plane): the
  wrapper's CUDA-event mean, the device time of each kernel it launches
  (``torch.profiler``), blocks in the grid and blocks an SM (the
  runtime's occupancy of the launch), valid postings and the bytes the
  bound counts (``k9_work``); at (c) and (d) also the device time of each
  kernel a dispatch over the mix's timed batches through ``serve_bool``.
- K8 at the IVF route's shape (``ivf_plane``, the first query batch):
  the wrapper's CUDA-event mean, its device time and its host time a
  call (calls enqueued back to back, no synchronisation between them),
  and the same three for the smoke's yardstick (the window's rows
  gathered, then ``torch.bmm``), for ``kernels.build.launch`` alone and
  for the C entry called straight through ``ctypes``.
- ``--variants`` with ``k9``: the tree's ``csrc/bool_bm25_topk.cu`` (the
  tile design) edited to leave out the adds (and so the eligibility
  pass), the eligibility pass, the posting loads or the merge, to scan
  every tile's cells, or with chunks of 2,048
  postings, built and called through its C entry on each K9 input; and
  this checkout's entry (with the stamps where built) with the plan at
  tiles of 2,048, 4,096 and 8,192 docs.
- K1 at the pruned route's eager fallback (mix (a)'s checked batch: its
  unsafe queries by the tree's K4, Q = 8, L from ``ladder_L``, no dense
  tier, as ``chip_smoke.py`` builds the call) and at the headline's tiered
  shape (64 x 4 terms, the dense tier of the 2^23-doc plane, the
  workload's L): the wrapper's CUDA-event mean, its device time by kernel
  (``torch.profiler``), the grid and blocks an SM, the valid postings and
  the bytes the bound counts (``chip_smoke.k1_work``).
- K4 at mixes (a) and (b) of the prune plane: ``P_sched``, the blocks
  scored of the blocks in the schedules, the wrapper's CUDA-event mean and
  device time on the checked batch, and the device time of each kernel a
  dispatch over the mix's timed batches through ``serve``. ``--variants``
  adds a build of the tree's ``csrc/blockmax_scan.cu`` with ``clock64()``
  stamps (a block's cycles; in the scan the tier loads, the accumulator's
  read-modify-write and the window merge a scored step; the survivor pass
  with the keys pushed and inserted; the verdict with its sort).
- K3 on the calls one dispatch makes on the headline's ``search``, the
  pruned step (mix (a)'s checked batch), the exact kNN step and the
  hybrid step (recorded with the smoke's planes and inputs): each call's shape, plan (where the tree's K3 has one),
  CUDA-event mean, device time (``torch.profiler``) and host time a
  call; each path's calls together beside ``torch.topk`` over the same
  rows; on the kNN paths the chunk reduce as one call and as the
  two-stage split ``reduce_chunks`` made before.
- K21 at outlier detection (l)'s input (recorded from
  ``start_analytics`` on the smoke's flights frame): CUDA-event mean,
  device time, blocks an SM, the bound; a build with ``clock64()``
  stamps of either design (the one-thread-a-row kernel's tile copy, FMAs
  and epilogue; the tiled kernel's wait, copies, FMAs, epilogue and
  inserts) and, for the tiled design, builds with a part left out, a
  size or the epilogue's rounding changed, beside the unedited source
  built the same way (``K21_VARIANTS``), timed in order and in reverse.
- K2 at the headline's call (``chip_smoke.check_kernels``' inputs: the
  2^23-doc tiered plane, search's first timed batch, 64 x 4 terms drawn
  ∝ df, k = 10): the wrapper's CUDA-event mean, its host time a call, the
  device time of each kernel (``torch.profiler``), blocks in the grid and
  blocks an SM, the registers (``ptxas``), the rows used and the bytes the
  bound counts, and a digest of K2 → K3's (vals, docs, n_matched), equal
  between two trees that compute the same top-k. ``--variants`` adds a
  build with ``clock64()`` stamps of either design (the rounds design: row
  loads, FMAs, the flush's barrier, thread 0's inserts; the ring: the
  waits for a slot, scoring, selection, pushes and merges) and, for the
  ring, builds with a part left out or a size changed
  (``K2_RING_VARIANTS``).
- K12 on config #3's route (``masked_rank_prefix`` at 165,346,692 pairs,
  n_pad 2^28, a 25 % mask) and on the caches' three calls at 2^28 padded
  pairs (counts and sums over the stand-in segment's ordinal CSR, the
  prefix under the HLL register max): CUDA-event mean, host time, the
  device time of each pass and a digest of the outputs. ``--variants``
  adds builds with no L2 cache hints, with c written by streaming stores,
  and with the bits' lines left in L2 (``K12_VARIANTS``), each timed in
  turn with the tree's build on each call.
- K14's counts and sums over config #3's histogram cache (``k14_inputs``:
  2^28 padded pairs, 165,346,692 real, 1,024 buckets, a fresh 25 %
  mask): CUDA-event mean, host time, device time by kernel, the sums
  pass's blocks, the bounds (each added value's 4 bytes, or the 32-byte
  sectors they touch), a digest of the outputs and whether a second call
  gives the same bits; a build with ``clock64()`` stamps of the one-wave
  design (a step's loads, its conflict step, the steps that end early,
  the rows flush). ``--variants`` adds builds with the conflict step
  sorted in registers or left out, 2 vectors a lane (also with every
  slot's values staged at once), 264 blocks
  (``K14_VARIANTS``), each timed in turn with the tree's build.
- K22 at classification (m)'s call (recorded from ``start_analytics``:
  131,072 x 8 columns, 2 classes, 500 steps): the run's and a step's
  CUDA-event mean, host time a step, device time by kernel, launches a
  run, the grid and blocks an SM, the bound, a digest of W and, for the
  persistent design, a build with ``clock64()`` stamps a phase (the
  residuals, the partials, the grid barrier, the sum and update);
  ``--variants`` adds builds with parts of the residuals changed or left
  out, or 1,024 threads a block
  (``K22_VARIANTS``), each timed in turn with the tree's build.
- K19 at the per-segment path's calls on the 2^23-doc segment (mix (e)'s
  first request at k = 10, (i)'s from 990 and 9,990 at k = 1,000 and
  10,000, and (e)'s scores with five docs matched): CUDA-event mean, host
  time a call, device time by kernel and device events a call
  (``torch.profiler``), the bound, a digest of (values, indices) and
  whether they are the plain version's bits; ``--variants`` adds the
  one-launch design's ``%globaltimer`` stamps (``K19_STAMPS``) and the
  builds of ``K19_VARIANTS``, each timed in turn with the tree's build.
- K7 at the IVF shape (``ivf_plane``, the first batch) at the windows of
  k = 10, serve(k = 1,000) and serve(k = 10,000): CUDA-event mean, host
  time, device time by kernel, launches a call, the grid, the plain
  version's mean and a digest of the window; a parent's chunk lists
  alone where it has them; ``--variants`` adds the deep path's block
  stamps (``K7_STAMPS``).
- K17 at mix (g)'s terms filter and a prefix query's one run on the
  2^23-doc segment: CUDA-event mean, host time, device time by kernel,
  device events a call, the bound and whether the counts are the plain
  version's.
- K5 on the calls one dispatch makes at pruned mixes (a) and (b)'s
  checked batch, a bool rescore (mix (d), total) and a hybrid rescore
  (total: a parent's two calls, this tree's one), and K10 at the hybrid's
  rrf and sum (windows 100), with the rescore payload, and at windows of
  10,000 (synthetic lists): each dispatch's calls replayed together, the
  CUDA-event mean, host time a call (enqueued back to back), device time
  by kernel and device events a call (``torch.profiler``), whether the
  outputs are the plain version's bits and a digest; ``--variants`` adds
  K5 built at other sizes (``K5_VARIANTS``: T, a block's candidates).
- K11 at the bool rescore's shape (16 rankings of 100, window 50, k =
  100), the hybrid rescore's (n = 256, window 50, k = 10) and the hybrid's
  at windows of 300 (n = 1,024, the sorting path), synthetic rankings of
  the routes' form (``k11_inputs``): CUDA-event mean, host time a call,
  device time and device events a call, the bound, a digest, and whether
  the five modes' outputs are the plain version's bits.
- K20 at the smoke's 500-tree model (511 nodes, 32 features) at (j)'s
  call (1,024 docs) and (k)'s (one doc): the same figures and whether
  the leaf ids are the numpy walk's; then (j) ``_infer`` and (k) the
  ingest processor driven (docs/s, p50, launches a call). ``--variants``
  adds builds with the batch block's warps along docs or the walks a
  thread changed at (j) (``K20_VARIANTS``) and with every n sent to the
  batch shape at (k) (``K20_FEW_VARIANTS``), each with its card time and
  whether its leaf ids are the tree's, and (k) driven with the latter in
  turns with the tree's build.
- K18 at mix (g)'s price range and (h)'s tag range on the 2^23-doc
  segment: the same figures, the bound and the ``scatter_reduce_``
  yardstick.
- K13 at its two real inputs, each under the route's 25 % mask and a
  0.1 % mask (where its fallbacks run): (p) the route's pick (config #3's
  columns, the top 10 ordinals' Hazen ranks at [50, 95, 99]) and (r) the
  register pass over the HLL caches' K12 prefix (p = 14, 32,767 runs):
  the same figures, the bound, the library call (``torch.searchsorted``
  + gather) and the entries or runs that left the first look; the card
  ms also with L2 emptied before each call (a 256 MiB write: c cold, as
  after K12 writes a fresh one); ``--variants`` adds builds with 1, 8 or
  32 pivots a lane a round in the pick's searches, or a register pass
  with no window (``K13_VARIANTS``), each by queued events, warm and
  cold, in turn with the tree's.
- ``pruned``, ``hybrid``: the pruned route (mixes (a), (b)) and the hybrid
  path (rrf, and rescore at total) driven over the smoke's batches: q/s,
  p50, the stages, launches a dispatch, and device events and device ms
  by kernel a dispatch (``torch.profiler``).
- ``aggs``: ``chip_smoke.run_aggs`` against ``--tree``'s package: config
  #3's route (aggs/s, p50, p99, its stages, on stdout) and the K12–K15
  rows through the caches (about 3 minutes; not in the default list).
- ``segment``, ``ivf``: ``chip_smoke.run_segment`` (mixes (e)–(i) on the
  2^23-doc segment: q/s, p50, p99 on stdout, and the K16–K19 rows; about
  1.5 minutes) and ``chip_smoke.run_knn_ivf`` (the IVF route: q/s, p50,
  ``dispatch_ms``, recall on stdout, and the K7 and K8 rows; about 15 s)
  against ``--tree``'s package, so two commits' end-to-end figures come
  from one call (not in the default list).
- ``serving``: ``chip_smoke.run_serving`` (config #1's serving route from
  32 client threads: requests/s, p50, p99, batches, stages and busy share
  a mix, and the delta; about 4 minutes with its set-up) against
  ``--tree``'s package (not in the default list).
- ``--variants``: the tree's ``csrc/knn_scan.cu`` copied to
  ``elasticsearch_tpu_torch/_build/probe/``, edited to leave out one part
  (the row loads, the dot products, or the list pushes and merges) or to
  change a size, built with the package's nvcc flags and called through
  its C entry on the same inputs; full − variant is that part's share of
  the time. The edits are text replacements for two designs of the
  source: the ``cp.async`` ring and the chunked scan before it (commit
  4014364's). A variant whose target text is not in the source is
  reported as not measured.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: text edits of csrc/knn_scan.cu that leave one part out or change a
#: size, by the source's design (``k6_design``); each keeps the other
#: parts' work alive
K6_VARIANTS = {
    "ring": {
        "no_loads": [("          if (r < rows)\n            k6_cp16(",
                      "          if (r < 0)\n            k6_cp16(")],
        "no_dot": [(
            "    if (dlen == kDC)\n"
            "      k6_stage_dot<kDC, true>(rows, q_s, qoff, d0, dlen, r0, acc);"
            "\n    else\n"
            "      k6_stage_dot<kDC, false>(rows, q_s, qoff, d0, dlen, r0, acc);",
            "    acc[0][0] += rows[r0] + d0;")],
        "no_lists": [
            ("L.push(q, live && q < nb && L.beats(q, sc, row), sc, row);",
             "if (sc == -1.2345e-30f && live) part_vals[q] = sc;"),
            ("    __syncthreads();\n    L.merge();\n    cc = 0;",
             "    cc = 0;")],
        # stages of 32 or of 64 d values, whatever the plan picks
        "dc32": [("  for (int dc = 32; dc <= 64; dc += 32) {",
                  "  for (int dc = 32; dc <= 32; dc += 32) {")],
        "dc64": [("  for (int dc = 32; dc <= 64; dc += 32) {",
                  "  for (int dc = 64; dc <= 64; dc += 32) {")],
        # a ring of 3 stages whatever the plan picks
        "ring3": [("    if (score > best) {", "    if (nst == 3) {")],
    },
    "chunked": {
        "no_loads": [("if (ex_s[r] && d < D) {", "if (ex_s[r] && d < 0) {")],
        "no_dot": [("ks_tile_dot(rows_s, q_s, rr, qg, dc, rs, acc);",
                    "acc[0][0] += rows_s[rr] * q_s[qg];")],
        "no_lists": [
            ("L.push_warp(q, live && q < nb && L.beats(q, sc, row), sc,"
             " row);",
             "if (sc == -1.2345e-30f && live) part_vals[q] = sc;"),
            ("    L.merge();\n  }", "  }")],
    },
}


def k6_design(src: str) -> str:
    """Which design a knn_scan.cu source is: "ring" or "chunked"."""
    return "ring" if "k6_cp16" in src else "chunked"


#: appended to an unedited copy of a chunked-design knn_scan.cu, which
#: has no es_knn_scan_blocks_per_sm: the same plan as its es_knn_scan,
#: then the runtime's occupancy of that launch
K6_OCCUPANCY = """
extern "C" int es_knn_scan_blocks_per_sm(int B, int D, int k) {
  const int bt = B < KS_BT ? B : KS_BT;
  size_t shm = ks_base_bytes(bt, D);
  const bool shared = shm + ks_list_bytes(bt, k) <= knn_scan_shared_room();
  if (shared) shm += ks_list_bytes(bt, k);
  auto kernel = shared ? knn_scan_kernel<true> : knn_scan_kernel<false>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, KS_THREADS, shm);
  return n;
}
"""


def emit(rows, **kw):
    print(json.dumps(kw), flush=True)
    rows.append(kw)


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its helpers import
    the package lazily, so they run against ``--tree``'s)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k16_inputs(dev):
    """(args, kwargs) of mix (e)'s first bm25_score call, as the smoke
    records it."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops import bm25 as bm25_mod
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    tag, price = cs.segment_columns(cs.N_DOCS)
    seg, mapper = cs.segment_index(corpus, tag, price, dev)
    searcher = ShardSearcher([seg], mapper)
    rng = np.random.RandomState(4321)
    bags = [[f"w{t[1:]}" for t in q] for q in
            cs.sample_queries(rng, corpus, 1, batch=cs.SEG_TIMED + 1)[0]]
    rec = []
    with cs.recording(rec, ("bm25_score",), (bm25_mod,)):
        searcher.search({"query": {"match": {"body": " ".join(bags[0])}},
                         "size": 10})
    (_n, a, kw, out), = rec
    return a, kw, out, seg


def run_k16(rows, reps):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import bm25 as bm25_mod
    dev = torch.device("cuda")
    a, kw, res, seg = k16_inputs(dev)
    lens = np.minimum(np.asarray(a[4]), kw["L"])
    V = int(lens.sum())
    D = int(torch.count_nonzero(res[1]))
    n_pad = kw["segment_pad"]

    def call():
        return bm25_mod.bm25_score(*a, **kw)
    ms = cs.timed(call, reps)
    nbytes = 8 * V + 4 * D + 8 * n_pad
    emit(rows, kernel="bm25_scatter", what="(e) first request",
         Q=len(lens), L=kw["L"], lengths=lens.tolist(), valid_postings=V,
         docs=D, n_pad=n_pad, ms=ms, bound_ms=cs.bound(nbytes, 10 * V)[0],
         by_name=cs.device_ms_by_name(call, 20))
    del seg
    torch.cuda.empty_cache()


def k6_cases(dev):
    """The hybrid's and the exact route's K6 inputs: (label, args, kk,
    l2)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, _packed_queries)
    vecs = cs.hybrid_vectors(cs.HY_DOCS, cs.HY_DIM)
    plane = DistributedKnnPlane([dict(vectors=vecs)],
                                similarity="dot_product", device=dev)
    del vecs
    v, vn, ex = plane._device_arrays()
    q = torch.from_numpy(np.random.RandomState(5).randn(
        cs.HY_BATCH, cs.HY_DIM).astype(np.float32)).to(dev)
    yield "hybrid D=768", (v, vn, ex, q, torch.sum(q * q, 1)), \
        cs.HY_WINDOW, False
    del plane, v, vn, ex
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1234)
    corpus = rng.randn(cs.KNN_ROWS, cs.KNN_DIM).astype(np.float32)
    plane = DistributedKnnPlane([dict(vectors=corpus)], similarity="cosine",
                                device=dev)
    del corpus
    v, vn, ex = plane._device_arrays()
    q = torch.from_numpy(rng.randn(cs.KNN_BATCH, cs.KNN_DIM)
                         .astype(np.float32)).to(dev)
    args = (v, vn, ex, _packed_queries(q, "cosine"), torch.sum(q * q, 1))
    yield "exact D=100", args, cs.KNN_K, False
    # the lists' share: the same scan keeping ten rows a query
    yield "exact D=100, k=10", args, 10, False
    del plane, v, vn, ex
    torch.cuda.empty_cache()


def build_variant(tree, name, edits, scratch, source="knn_scan"):
    """The tree's ``csrc/<source>.cu`` with ``edits`` (target, new; an empty
    target appends), built as a library; None when a target is missing."""
    from elasticsearch_tpu_torch.kernels import build as kb
    csrc = os.path.join(tree, "elasticsearch_tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{source}.cu")) as f:
        src = f.read()
    if not all(old in src for old, _ in edits if old and old != "^"):
        return None
    for old, new in edits:
        if old == "^":
            src = new + src
        else:
            src = src.replace(old, new) if old else src + new
    path = os.path.join(scratch, f"{source}_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(scratch, f"{source}_{name}.so")
    subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", csrc, "-o", lib, path],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


def run_k6(rows, reps, variants, tree):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import knn as knn_mod
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = scratch_dir()
    with open(os.path.join(tree, "elasticsearch_tpu_torch", "csrc",
                           "knn_scan.cu")) as f:
        design = k6_design(f.read())
    libs = {name: build_variant(tree, name, edits, scratch)
            for name, edits in K6_VARIANTS[design].items()} \
        if variants else {}
    occ = kb.library("knn_scan")
    if design == "chunked":
        occ = build_variant(tree, "occupancy", [("", K6_OCCUPANCY)], scratch)
        occ.es_knn_scan_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        occ.es_knn_scan_blocks_per_sm.restype = ctypes.c_int
    for label, args, kk, l2 in k6_cases(dev):
        v, vn, ex, qq, qn = args
        S, n_pad, D = v.shape
        B = qq.shape[0]
        ms = cs.timed(lambda: knn_mod.knn_scan_partials(*args, l2=l2, kk=kk),
                      reps)
        part_v, _ = knn_mod.knn_scan_partials(*args, l2=l2, kk=kk)
        C = part_v.shape[2]
        live = int(ex.sum())
        nbytes = live * D * 4 + S * n_pad + B * D * 4 + B * 4 + B * kk * 8
        per_sm = occ.es_knn_scan_blocks_per_sm(B, D, kk)
        ring = kb.query("knn_scan", "es_knn_scan_ring", B, D, kk) \
            if design == "ring" else None
        row = dict(kernel="knn_scan", what=label, design=design, B=B, D=D,
                   k=kk, n_pad=n_pad,
                   live_rows=live, chunks=C, sms=n_sm, blocks_per_sm=per_sm,
                   ring=ring,
                   ms=ms, bound_ms=cs.bound(nbytes, 2 * B * live * D)[0],
                   achieved_GBps=nbytes / ms / 1e6)
        for name, vlib in libs.items():
            if vlib is None:
                row[name + "_ms"] = "not measured (edit target missing)"
                continue
            fn = vlib.es_knn_scan
            fn.argtypes = kb._SIGNATURES["knn_scan"][1]
            fn.restype = ctypes.c_int
            ws_b = kb.query("knn_scan", "es_knn_scan_workspace_bytes", B, S,
                            C, kk, D)
            ws = torch.empty(max(ws_b // 4, 1), device=dev)
            pv = torch.empty((B, S, C, kk), device=dev)
            pi = torch.empty((B, S, C, kk), dtype=torch.int32, device=dev)

            def call():
                err = fn(v.data_ptr(), vn.data_ptr(), ex.data_ptr(),
                         qq.data_ptr(), qn.data_ptr(), B, S, n_pad, D, kk,
                         int(l2), C, pv.data_ptr(), pi.data_ptr(),
                         ws.data_ptr() if ws_b else None,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: error {err}")
            row[name + "_ms"] = cs.timed(call, reps)
        emit(rows, **row)


#: appended to an unedited copy of a sparse_candidates_topk.cu that still
#: holds K9 as K1's kBool variant: the occupancy of es_bool_bm25_topk's
#: launch (the same shared-memory plan)
K9_KBOOL_OCCUPANCY = """
extern "C" int es_probe_k9_blocks_per_sm(int Q, int k) {
  size_t shm = (size_t)K1_THREADS * 8 + (size_t)Q * 28 + 4;
  const bool top_shared =
      shm + (size_t)k * 8 <= (size_t)es_max_shared_bytes();
  if (top_shared) shm += (size_t)k * 8;
  auto kernel = top_shared ? sparse_candidates_topk_kernel<true, true>
                           : sparse_candidates_topk_kernel<false, true>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, K1_THREADS, shm);
  return n;
}
"""


def scratch_dir():
    path = os.path.join(HERE, "elasticsearch_tpu_torch", "_build", "probe")
    os.makedirs(path, exist_ok=True)
    return path


def k9_launch(tree, args, kw):
    """(design, blocks in the grid, blocks an SM) of K9's launch on these
    inputs: the tile design's plan and occupancy query, or the kBool
    variant's one block per (query, shard) and its occupancy."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    B, S, Q = args[2].shape
    k = kw["k"]
    if os.path.exists(os.path.join(tree, "elasticsearch_tpu_torch", "csrc",
                                   "bool_bm25_topk.cu")):
        from elasticsearch_tpu_torch.ops.fused_query import \
            bool_bm25_topk_plan
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = bool_bm25_topk_plan(kw["n_pad"], B, S, Q, kw["L"], k, n_sm)
        per_sm = kb.query("bool_bm25_topk",
                          "es_bool_bm25_topk_blocks_per_sm", Q, k,
                          plan["tile_shift"], plan["edge_tiles"])
        return "tiles", B * S * plan["G"], per_sm, plan
    lib = build_variant(tree, "occupancy", [("", K9_KBOOL_OCCUPANCY)],
                        scratch_dir(), source="sparse_candidates_topk")
    fn = lib.es_probe_k9_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return "kBool", B * S, fn(Q, k), None


#: text edits of the tile design's csrc/bool_bm25_topk.cu that leave one
#: part out or change a size; a part left out keeps the others' work and
#: every cell index inside its tile
K9_VARIANTS = {
    # the postings' adds into the tile cells
    "no_adds": [("if (j < s1) {\n              d = sd[j - c0] - t0;",
                 "if (j < 0) {\n              d = sd[j - c0] - t0;")],
    # the eligibility tests and the top-k offers (the flags are cleared)
    "no_elig": [("        for (int x = tid; x < n_doc; x += K9_THREADS) {\n"
                 "          const int i = listed ? t_list[x] : x;\n",
                 "        for (int x = tid; x < 0; x += K9_THREADS) {\n"
                 "          const int i = listed ? t_list[x] : x;\n")],
    # the postings' loads from device memory (the chunks are filled with
    # in-range docs in shared memory instead)
    "no_loads": [("    k9_cp4(sd + j, docs_s + p);\n    k9_cp4(sm + j, imps_s "
                  "+ p);", "    sd[j] = p;\n    sm[j] = 1.0f;"),
                 ("d = sd[j - c0] - t0;",
                  "d = (sd[j - c0] - t0) & ((1 << tshift) - 1);")],
    # the merge of the G lists
    "no_merge": [("  k9_merge<<<", "  if (G < 0) k9_merge<<<")],
    # every tile's cells scanned, none listed as they arrive
    "scan_only": [("        const bool listed = tot < (T >> 2);",
                   "        const bool listed = false;")],
    # chunks of 2,048 postings
    "stage2048": [("#define K9_STAGE 1024", "#define K9_STAGE 2048")],
    # the doc-tile header's cell-free pass for sparse tiles off, or bounded
    # at 32 / 128 / 512 postings a tile (csrc/tile_topk.cuh)
    "sparse_off": [("^", "#define TT_SPARSE_MAX 0\n")],
    "sparse32": [("^", "#define TT_SPARSE_MAX 32\n")],
    "sparse128": [("^", "#define TT_SPARSE_MAX 128\n")],
    "sparse512": [("^", "#define TT_SPARSE_MAX 512\n")],
    # the full kernel with clock64() stamps: a block's cycles, those of its
    # edge searches and list offsets, and of its waits for staged chunks
    "phases": [
        ("  int my_match = 0;\n",
         "  int my_match = 0;\n"
         "  long long dbg_t0 = clock64(), dbg_e = 0, dbg_wt = 0;\n"),
        ("    const int wtile = tile0 + w0;\n",
         "    const int wtile = tile0 + w0;\n"
         "    const long long dbg_w = clock64();\n"),
        ("    const int total = toff[nw];\n",
         "    dbg_e += clock64() - dbg_w;\n    const int total = toff[nw];\n"),
        ("      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
         "      __syncthreads();\n",
         "      const long long dbg_x = clock64();\n"
         "      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
         "      __syncthreads();\n      dbg_wt += clock64() - dbg_x;\n"),
        ("  if (tid == 0) out_count[o] = n_match;\n",
         "  if (tid == 0) out_count[o] = n_match;\n"
         "  if (tid == 0 && blockIdx.x < (1 << 14)) {\n"
         "    k9_dbg[blockIdx.x * 3] = clock64() - dbg_t0;\n"
         "    k9_dbg[blockIdx.x * 3 + 1] = dbg_e;\n"
         "    k9_dbg[blockIdx.x * 3 + 2] = dbg_wt;\n  }\n"),
        ("#define K9_THREADS 256\n",
         "#define K9_THREADS 256\n__device__ long long k9_dbg[3 << 14];\n"
         "extern \"C\" int es_probe_k9_phases(long long* out, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, k9_dbg, n * 24);\n}\n")],
}


#: K9 at other tile sizes: the same source, the plan at 2^shift docs a tile
K9_TILE_VARIANTS = {"tile2048": 11, "tile4096": 12, "tile8192": 13}


def k9_entry_args(args, kw, n_sm, tile_shift=None):
    """es_bool_bm25_topk's arguments (no stream) for the wrapper's call on
    these inputs, with outputs and scratch allocated as the wrapper does
    them (``tile_shift``: the plan at that tile size)."""
    import torch
    from elasticsearch_tpu_torch.ops import fused_query as fq
    dev = args[0].device
    S, P = args[0].shape
    B, _, Q = args[2].shape
    k, n_pad = kw["k"], kw["n_pad"]
    saved = fq.BOOL_TILE_SHIFT, fq.BOOL_SPARSE_TILE_SHIFT
    if tile_shift is not None:
        fq.BOOL_TILE_SHIFT = fq.BOOL_SPARSE_TILE_SHIFT = tile_shift
    try:
        plan = fq.bool_bm25_topk_plan(n_pad, B, S, Q, kw["L"], k, n_sm)
    finally:
        fq.BOOL_TILE_SHIFT, fq.BOOL_SPARSE_TILE_SHIFT = saved
    MAX_BOOL_CLAUSES = fq.MAX_BOOL_CLAUSES
    G = plan["G"]
    part = torch.empty(B * S * G * (2 * k + 1), dtype=torch.int32,
                       device=dev)
    out = torch.empty(B * S * (2 * k + 1), dtype=torch.int32, device=dev)
    n_part, n_out = B * S * G * k, B * S * k
    return [*(a.data_ptr() for a in args[:2]), P,
            *(a.data_ptr() for a in args[2:]), B, S, Q, kw["L"], n_pad, k,
            kw.get("nc", MAX_BOOL_CLAUSES), plan["tile_shift"],
            plan["tiles_per_block"], plan["edge_tiles"], G, part.data_ptr(),
            part.data_ptr() + 4 * n_part, part.data_ptr() + 8 * n_part,
            out.data_ptr(), out.data_ptr() + 4 * n_out,
            out.data_ptr() + 8 * n_out], (part, out)


def k9_variant_ms(tree, args, kw, reps, libs):
    """Each K9 variant's CUDA-event mean on these inputs ("not measured"
    where its edit target is missing)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    runs = [(name, lib, None) for name, lib in libs.items()]
    # the tile sizes through the "phases" build where there is one, so
    # that their blocks' cycles are read too
    tiles_lib = libs.get("phases") or kb.library("bool_bm25_topk")
    runs += [(name, tiles_lib, shift)
             for name, shift in K9_TILE_VARIANTS.items()]
    out = {}
    for name, lib, shift in runs:
        if lib is None:
            out[name + "_ms"] = "not measured (edit target missing)"
            continue
        cargs, keep = k9_entry_args(args, kw, n_sm, shift)
        fn = lib.es_bool_bm25_topk
        fn.argtypes = kb._SIGNATURES["bool_bm25_topk"][1]
        fn.restype = ctypes.c_int

        def call():
            err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K9 variant {name}: error {err}")
        out[name + "_ms"] = cs.timed(call, reps)
        if lib is libs.get("phases"):
            out[name + "_phases"] = k9_phases(lib, cargs)
        del keep
    return out


def k9_phases(lib, cargs):
    """The "phases" variant's clock64() stamps of its last call: the mean
    and largest block's cycles, and the mean cycles of a block's edges and
    list offsets and of its waits for staged chunks, by the card's clock
    rate (torch reports no SM clock: nvidia-smi's, read here)."""
    import torch
    B, S, G = cargs[11], cargs[12], cargs[21]
    nb = min(B * S * G, 1 << 14)
    buf = (ctypes.c_longlong * (3 * nb))()
    torch.cuda.synchronize()
    if lib.es_probe_k9_phases(buf, nb):
        return "not measured (copy failed)"
    a = np.frombuffer(buf, dtype=np.int64).reshape(nb, 3).astype(np.float64)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return dict(blocks=nb, cycles_mean=a[:, 0].mean(),
                cycles_max=a[:, 0].max(), edges_mean=a[:, 1].mean(),
                waits_mean=a[:, 2].mean(),
                sm_clock_mhz=clk[0] if clk else "not read")


def k9_row(rows, tree, label, plane, args, kw, reps, libs):
    """One K9 reading: the wrapper's mean, its device time by kernel, the
    launch's grid and occupancy, the work the bound counts, and the
    variants' means."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops.fused_query import bool_bm25_topk

    def call():
        return bool_bm25_topk(*args, **kw)
    ms = cs.timed(call, reps)
    variants = k9_variant_ms(tree, args, kw, reps, libs) if libs else {}
    by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
    design, grid, per_sm, plan = k9_launch(tree, args, kw)
    nbytes, nops, n_post, n_owner = cs.k9_work(plane, args, kw["k"])
    B, S, Q = args[2].shape
    emit(rows, kernel="bool_bm25_topk", what=label, design=design, B=B, S=S,
         Q=Q, L=kw["L"], k=kw["k"], n_pad=kw["n_pad"], grid=grid,
         blocks_per_sm=per_sm, plan=plan, valid_postings=n_post,
         candidates=n_owner, bound_bytes=nbytes, ms=ms,
         device_ms=sum(by_name.values()), by_name=by_name,
         bound_ms=cs.bound(nbytes, nops)[0], **variants)


def run_k9(rows, reps, tree, variants):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, DistributedSearchPlane, fused_search_device)
    dev = torch.device("cuda")
    libs = {}
    if variants and os.path.exists(os.path.join(
            tree, "elasticsearch_tpu_torch", "csrc", "bool_bm25_topk.cu")):
        libs = {name: build_variant(tree, name, edits, scratch_dir(),
                                    source="bool_bm25_topk")
                for name, edits in K9_VARIANTS.items()}
    _rng, corpus, plane, _cs, _ps = cs.prune_plane(dev)
    mixes, _extra, _draw = cs.bool_traffic(corpus)
    k9_reps = max(reps // 4, 1)
    for m, batches in mixes.items():
        prep = plane.prepare_bool(batches[1])
        args = cs.bool_args(prep["args"])
        kw = dict(n_pad=plane.n_pad, L=prep["L"], k=min(cs.K, plane.n_pad))
        k9_row(rows, tree, f"bool mix ({m}), checked batch", plane, args,
               kw, k9_reps, libs)
        # the device time a dispatch over the mix's timed batches
        calls = []
        with cs.recording(calls, ("bool_bm25_topk",)):
            plane.serve_bool(batches[0], k=cs.K)

            def serve_all():
                for b in batches[1:]:
                    plane.serve_bool(b, k=cs.K)
            by_name = cs.device_ms_by_name(serve_all, 1)
        n_disp = len(batches) - 1
        Ls = [kw2["L"] for _n, _a, kw2, _o in calls[1:]]
        emit(rows, kernel="bool_bm25_topk",
             what=f"bool mix ({m}), serve_bool over the timed batches",
             dispatches=n_disp, L_by_dispatch=Ls,
             by_name_per_dispatch={n: v / n_disp for n, v in by_name.items()})
    del plane, corpus
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1234)
    corpus = cs.hybrid_corpus(rng, cs.HY_DOCS)
    tplane = DistributedSearchPlane([corpus], "body", device=dev)
    batches, _el, _p, _dense = cs.hybrid_traffic(rng, corpus, tplane,
                                                 cs.HY_DIM)
    # the text side's inputs do not depend on the kNN plane's rows
    kplane = DistributedKnnPlane(
        [dict(vectors=np.ones((4 * cs.HY_WINDOW, cs.HY_DIM), np.float32))],
        similarity="dot_product", device=dev)
    calls = []
    with cs.recording(calls, ("bool_bm25_topk",)):
        fused_search_device(tplane, kplane, batches[1], fusion="rrf")
    (_n, args, kw, _o), = calls
    k9_row(rows, tree, "hybrid text side, first timed batch", tplane,
           list(args), kw, reps, libs)
    del tplane, kplane, corpus
    torch.cuda.empty_cache()


def host_ms(fn, reps):
    """Host ms a call of ``fn``, enqueued back to back (no synchronisation
    between calls; one after a warm-up and at the end)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def run_k8(rows, reps):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.knn import (ivf_rerank, ivf_scan,
                                                 window_rows)
    dev = torch.device("cuda")
    _corpus, plane, _g, _p, q_batch = cs.ivf_plane(dev)
    a, R, _pw, qq, qn, scan_in, scan_kw = cs.ivf_step_inputs(plane,
                                                             q_batch())
    wv, wp = ivf_scan(*scan_in, **scan_kw, nlist=plane.ivf.nlist, r_cand=R)
    rr_in = (wv, wp, a["u_blocks"], a["rowid"], a["vecs"], a["vnorm2"], qq,
             qn)
    n_pad = plane.n_pad
    safe = window_rows(wp, a["u_blocks"], a["rowid"]).clamp(
        0, n_pad - 1).long()[:, 0]
    vec0 = a["vecs"][0]
    # the wrapper's launch alone (outputs allocated, no checks) and its C
    # entry called straight through ctypes: the host's share of each layer
    B, S = wv.shape[:2]
    out = torch.empty((2, B, S, R), dtype=torch.int32, device=dev)
    cargs = (wv.data_ptr(), wp.data_ptr(), a["u_blocks"].data_ptr(),
             a["rowid"].data_ptr(), a["vecs"].data_ptr(),
             a["vnorm2"].data_ptr(), qq.data_ptr(), qn.data_ptr(), B, S, R,
             a["u_blocks"].shape[1], a["rowid"].shape[1],
             a["rowid"].shape[2], n_pad, a["vecs"].shape[2], 0,
             out[0].data_ptr(), out[1].data_ptr())
    entry = kb.library("ivf_rerank").es_ivf_rerank
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "ivf_rerank": lambda: ivf_rerank(*rr_in, l2=False, n_pad=n_pad),
        "yardstick (gather + torch.bmm)":
            lambda: torch.bmm(vec0[safe], qq[:, :, None]),
        "ivf_rerank: kernels.build.launch alone":
            lambda: kb.launch("ivf_rerank", dev, *cargs),
        "ivf_rerank: the C entry alone (ctypes)":
            lambda: entry(*cargs, stream)}
    live = int(torch.isfinite(wv).sum())
    # the times first: a profiler session may slow the launches after it
    got = {name: dict(ms=cs.timed(fn, 5 * reps),
                      host_ms=host_ms(fn, 5 * reps))
           for name, fn in calls.items()}
    for name, fn in calls.items():
        by_name = cs.device_ms_by_name(fn, reps)
        emit(rows, kernel="ivf_rerank", what=name, B=B, S=S, R=R,
             D=a["vecs"].shape[2], live_entries=live, **got[name],
             device_ms=sum(by_name.values()), by_name=by_name)
    del plane
    torch.cuda.empty_cache()


#: appended to an unedited copy of a one-block-a-(query, shard)
#: sparse_candidates_topk.cu: the occupancy of its launch (the same
#: shared-memory plan as its entry)
K1_BLOCK_OCCUPANCY = """
extern "C" int es_probe_k1_blocks_per_sm(int Q, int k) {
  size_t shm = (size_t)K1_THREADS * 8 + (size_t)Q * 24 + 4;
  const bool top_shared =
      shm + (size_t)k * 8 <= (size_t)es_max_shared_bytes();
  if (top_shared) shm += (size_t)k * 8;
  auto kernel = top_shared ? sparse_candidates_topk_kernel<true>
                           : sparse_candidates_topk_kernel<false>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, K1_THREADS, shm);
  return n;
}
"""


def k1_launch(tree, args, kw):
    """(design, blocks in the grid, blocks an SM, plan) of K1's launch on
    these inputs: the tile design's plan and occupancy query, or one block
    a (query, shard) and its occupancy."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import sorted_merge as sm
    B, S, Q = args[2].shape
    k = kw["k"]
    if hasattr(sm, "sparse_candidates_topk_plan"):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = sm.sparse_candidates_topk_plan(kw["n_pad"], B, S, Q, kw["L"],
                                              k, n_sm)
        per_sm = kb.query("sparse_candidates_topk",
                          "es_sparse_candidates_topk_blocks_per_sm", Q, k,
                          plan["tile_shift"], plan["edge_tiles"])
        return "tiles", B * S * plan["G"], per_sm, plan
    lib = build_variant(tree, "occupancy", [("", K1_BLOCK_OCCUPANCY)],
                        scratch_dir(), source="sparse_candidates_topk")
    fn = lib.es_probe_k1_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return "block a (query, shard)", B * S, fn(Q, k), None


#: K1 builds with the doc-tile header's cell-free pass for sparse tiles
#: off, or bounded at 32 / 128 / 512 postings a tile
K1_VARIANTS = {name: K9_VARIANTS[name] for name in
               ("sparse_off", "sparse32", "sparse128", "sparse512")}


@contextlib.contextmanager
def swapped_library(name, lib):
    """Kernel ``name``'s wrappers launch ``lib`` (a variant build) while
    the context lasts."""
    from elasticsearch_tpu_torch.kernels import build as kb
    sym, argtypes = kb._SIGNATURES[name]
    getattr(lib, sym).argtypes = argtypes
    getattr(lib, sym).restype = ctypes.c_int
    lib.es_error_string.argtypes = [ctypes.c_int]
    lib.es_error_string.restype = ctypes.c_char_p
    saved = kb.library(name)
    kb._libs[name] = lib
    try:
        yield
    finally:
        kb._libs[name] = saved


def k1_row(rows, tree, label, plane, args, kw, reps, libs=None):
    """One K1 reading: the wrapper's mean, its device time by kernel, the
    launch's grid and occupancy, and the work the bound counts."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops.sorted_merge import \
        sparse_candidates_topk

    def call():
        return sparse_candidates_topk(*args, **kw)
    ms = cs.timed(call, reps)
    by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
    design, grid, per_sm, plan = k1_launch(tree, args, kw)
    a = dict(lengths=args[3], starts=args[2], dense=kw.get("dense"),
             dense_w=kw.get("dense_w"))
    nbytes, nops, n_post, n_owner = cs.k1_work(plane, a, kw["k"])
    B, S, Q = args[2].shape
    variants = {}
    for name, lib in (libs or {}).items():
        if lib is None:
            variants[name + "_ms"] = "not measured (edit target missing)"
            continue
        with swapped_library("sparse_candidates_topk", lib):
            variants[name + "_ms"] = cs.timed(call, reps)
    emit(rows, kernel="sparse_candidates_topk", what=label, design=design,
         B=B, S=S, Q=Q, L=kw["L"], k=kw["k"], n_pad=kw["n_pad"],
         dense=kw.get("dense") is not None, grid=grid, blocks_per_sm=per_sm,
         plan=plan, valid_postings=n_post, candidates=n_owner,
         bound_bytes=nbytes, ms=ms, device_ms=sum(by_name.values()),
         by_name=by_name, bound_ms=cs.bound(nbytes, nops)[0], **variants)


def prune_mixes(dev):
    """The prune plane and its two traffic mixes, drawn as ``chip_smoke``'s
    pruned phase draws them: (corpus, plane, {mix: batches}); batch 0 is
    the warm-up, batch 1 the checked batch."""
    cs = smoke()
    rng, corpus, plane, _cs, _ps = cs.prune_plane(dev)
    mixes = {m: cs.sample_queries(rng, corpus, 1 + cs.PRUNE_BATCHES,
                                  cs.PRUNE_BATCH, weighted=m == "a")
             for m in ("a", "b")}
    return corpus, plane, mixes


def k4_call(plane, batch):
    """(args, kwargs, prep) of the K4 call of ``batch``'s pruned
    dispatch."""
    cs = smoke()
    prep = plane.prepare_pruned(batch, cs.K)
    a = prep["args"]
    kq = cs.K * prep["Q"]
    kw = dict(n_pad=plane.n_pad, NB=plane.blockmax.n_blocks, W=prep["W"],
              R=prep["R"], kq_idx=min(kq, prep["W"]) - 1,
              prune_active=kq <= prep["W"])
    args = [a[n] for n in ("t_docs", "t_codes", "t_scale", "t_off", "sched",
                           "w", "rho", "slack")]
    return args, kw, prep


def run_k1(rows, reps, tree, variants):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    dev = torch.device("cuda")
    libs = {}
    if variants and os.path.exists(os.path.join(
            tree, "elasticsearch_tpu_torch", "csrc", "tile_topk.cuh")):
        libs = {name: build_variant(tree, name, edits, scratch_dir(),
                                    source="sparse_candidates_topk")
                for name, edits in K1_VARIANTS.items()}
    _corpus, plane, mixes = prune_mixes(dev)
    batch = mixes["a"][1]
    args, kw, prep = k4_call(plane, batch)
    acc = plane.blockmax.scan_workspace(prep["B"] * plane.n_shards, dev)
    unsafe = blockmax_scan(*args, **kw, acc=acc)[3][:, 0].cpu().numpy()
    bad = [q for q, u in zip(batch, unsafe) if u]
    if bad:
        Qf = prep["Q"]
        Lf = plane.ladder_L(plane.max_run_len(bad))
        fa = plane.prepare(bad, cs.K, Q=Qf, L=Lf, tiered=None)["args"]
        k1_args = [fa[n] for n in ("postings_docs", "postings_impact",
                                   "starts", "lengths", "idfw")]
        k1_row(rows, tree, "pruned mix (a) fallback, checked batch", plane,
               k1_args, dict(n_pad=plane.n_pad, L=Lf, k=cs.K),
               max(reps // 4, 1), libs)
    else:
        emit(rows, kernel="sparse_candidates_topk",
             what="pruned mix (a) fallback: no unsafe query")
    del plane, acc
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(cs.VOCAB)}
    cs.sample_queries(rng, corpus, 1, batch=12)
    plane = DistributedSearchPlane([corpus], "body", device=dev)
    warm = cs.sample_queries(rng, corpus, 1)[0]
    batches = cs.sample_queries(rng, corpus, cs.TIMED_BATCHES)
    L1 = cs.workload_L(plane, [warm] + batches)
    prep = plane.prepare(batches[0], cs.K, Q=cs.N_TERMS, L=L1, tiered=True)
    a = prep["args"]
    k1_args = [a[n] for n in ("postings_docs", "postings_impact", "starts",
                              "lengths", "idfw")]
    k1_kw = dict(n_pad=plane.n_pad, L=prep["L"], k=cs.K, dense=a["dense"],
                 dense_rid=a["dense_rid"], dense_w=a["dense_w"],
                 u_ids=a["u_ids"])
    k1_row(rows, tree, "headline, search's first timed batch", plane,
           k1_args, k1_kw, reps, libs)
    del plane, corpus
    torch.cuda.empty_cache()


#: text edits of the one-block-a-row csrc/blockmax_scan.cu (commit
#: 8a8b36c's) that stamp its phases with clock64() in thread 0 of each
#: block: the tier loads, the accumulator's read-modify-write and the
#: window merge summed over the scored steps, the survivor pass (with the
#: keys pushed into the candidate buffer and those inserted into the
#: running top-R), the verdict with the sort, and the block's whole time
K4_PHASES_BLOCK = [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n"
     "__device__ long long k4_dbg[10 << 10];\n"
     "extern \"C\" int es_probe_k4_phases(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k4_dbg, n * 80);\n}\n"
     "__device__ __forceinline__ long long k4_clk() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
     "  return t;\n}\n"),
    ("  for (int i = tid; i < W; i += T) win[i] = -CUDART_INF_F;\n",
     "  long long dbg_t0 = k4_clk(), dbg_ld = 0, dbg_rmw = 0, dbg_mg = 0,\n"
     "            dbg_sv = 0, dbg_push = 0, dbg_ins = 0, dbg_sink = 0;\n"
     "  for (int i = tid; i < W; i += T) win[i] = -CUDART_INF_F;\n"),
    ("    float av = -CUDART_INF_F;\n    if (tid < BS) {\n",
     "    float av = -CUDART_INF_F;\n    long long dbg_a = k4_clk();\n"
     "    long long dbg_b = dbg_a, dbg_c = dbg_a;\n    if (tid < BS) {\n"),
    ("            1e-9f);\n        av = __fadd_rn(acc_r[d], __fmul_rn(wb, vh));\n"
     "        acc_r[d] = av;\n",
     "            1e-9f);\n        dbg_sink += d + __float_as_int(vh);\n"
     "        dbg_b = k4_clk();\n"
     "        av = __fadd_rn(acc_r[d], __fmul_rn(wb, vh));\n"
     "        acc_r[d] = av;\n        dbg_sink += __float_as_int(av);\n"
     "        dbg_c = k4_clk();\n"),
    ("      float* t = win;\n      win = win2;\n      win2 = t;\n    }\n",
     "      float* t = win;\n      win = win2;\n      win2 = t;\n    }\n"
     "    if (dbg_b != dbg_a) {\n      dbg_ld += dbg_b - dbg_a;\n"
     "      dbg_rmw += dbg_c - dbg_b;\n      dbg_mg += k4_clk() - dbg_c;\n"
     "    }\n"),
    ("  // ---- survivors: each seen doc once, accumulator cleared ---------------\n",
     "  const long long dbg_s0 = k4_clk();\n"
     "  // ---- survivors: each seen doc once, accumulator cleared ---------------\n"),
    ("    cand.flush(round, top);\n  }\n  __syncthreads();\n\n  // ---- verdict",
     "    __syncthreads();\n    {\n      const int dbg_n = ncand[round % 3];\n"
     "      if (dbg_n > 0) {\n        if (tid == 0) {\n"
     "          dbg_push += dbg_n;\n"
     "          for (int i = 0; i < dbg_n; ++i) {\n"
     "            dbg_ins += top.beats(buf_s[i], buf_d[i]);\n"
     "            top.insert(buf_s[i], buf_d[i]);\n          }\n        }\n"
     "        __syncthreads();\n      }\n    }\n  }\n  __syncthreads();\n"
     "  dbg_sv = k4_clk() - dbg_s0;\n  const long long dbg_v0 = k4_clk();\n"
     "\n  // ---- verdict"),
    ("      __syncthreads();\n    }\n  }\n}\n",
     "      __syncthreads();\n    }\n  }\n"
     "  if (tid == 0 && row < (1 << 10)) {\n"
     "    long long* o = k4_dbg + row * 10;\n"
     "    o[0] = k4_clk() - dbg_t0;\n    o[1] = n_sc;\n    o[2] = dbg_ld;\n"
     "    o[3] = dbg_rmw;\n    o[4] = dbg_mg;\n    o[5] = dbg_sv;\n"
     "    o[6] = dbg_push;\n    o[7] = dbg_ins;\n"
     "    o[8] = k4_clk() - dbg_v0;\n    o[9] = dbg_sink & 1;\n  }\n}\n"),
]

K4_PHASE_KEYS = ("block_cycles", "steps_scored", "loads", "acc_rmw",
                 "window_merge", "survivor_pass", "pushed", "inserted",
                 "verdict_sort")

#: the same stamps for the three-kernel csrc/blockmax_scan.cu (its scan
#: kernel, thread 0 of each row): the scan's cycles; at the top of a step
#: the waits for the ring's copies and the barrier; the add (up to its
#: value in a register); the compaction; the second barrier; the copies
#: and prefetches issued; the merges, and the steps that merged
K4_PHASES_SCAN = [
    K4_PHASES_BLOCK[0],
    ("  int slot = 0, slot_ahead = K4_AHEAD;\n",
     "  int slot = 0, slot_ahead = K4_AHEAD;\n"
     "  long long dbg_t0 = k4_clk(), dbg_wait = 0, dbg_lk = 0, dbg_cp = 0,\n"
     "            dbg_bb = 0, dbg_is = 0, dbg_mg = 0, dbg_nm = 0, dbg_x = 0,\n"
     "            dbg_sink = 0;\n"),
    ("    asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(K4_AHEAD - 1)\n",
     "    dbg_x = k4_clk();\n"
     "    asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(K4_AHEAD - 1)\n"),
    ("    __syncthreads();\n    const float theta =\n",
     "    __syncthreads();\n    dbg_wait += k4_clk() - dbg_x;\n"
     "    dbg_x = k4_clk();\n    const float theta =\n"),
    ("    // the partials that beat the window's last value, compacted\n",
     "    dbg_sink += __float_as_int(av);\n"
     "    dbg_lk += k4_clk() - dbg_x;\n    dbg_x = k4_clk();\n"
     "    // the partials that beat the window's last value, compacted\n"),
    ("    // this step's slot is read: copy step j + K4_LEAD's block into it, and\n",
     "    dbg_cp += k4_clk() - dbg_x;\n    dbg_x = k4_clk();\n"
     "    // this step's slot is read: copy step j + K4_LEAD's block into it, and\n"),
    ("    __syncthreads();\n    ring.fetch(slot, lead_blk,",
     "    __syncthreads();\n    dbg_bb += k4_clk() - dbg_x;\n"
     "    dbg_x = k4_clk();\n    ring.fetch(slot, lead_blk,"),
    ("    const int n = n_new[c3];\n    if (n > 0) {\n",
     "    dbg_is += k4_clk() - dbg_x;\n    dbg_x = k4_clk();\n"
     "    const int n = n_new[c3];\n    if (n > 0) {\n"),
    ("    }\n    cur_blk = nxt_blk;\n",
     "      ++dbg_nm;\n    }\n    dbg_mg += k4_clk() - dbg_x;\n"
     "    cur_blk = nxt_blk;\n"),
    ("    o[3] = pruned ? 1 : 0;\n",
     "    o[3] = pruned ? 1 : 0;\n    if (row < (1 << 10)) {\n"
     "      long long* q = k4_dbg + row * 10;\n"
     "      q[0] = k4_clk() - dbg_t0;\n      q[1] = n_sc;\n"
     "      q[2] = dbg_wait;\n      q[3] = dbg_lk;\n      q[4] = dbg_cp;\n"
     "      q[5] = dbg_bb;\n      q[6] = dbg_is;\n      q[7] = dbg_mg;\n"
     "      q[8] = dbg_nm;\n      q[9] = dbg_sink & 1;\n    }\n"),
]

K4_SCAN_KEYS = ("scan_cycles", "steps_scored", "waits", "add",
                "compact", "barrier_b", "issue", "window_merge",
                "merge_steps")

#: text edits of the three-kernel csrc/blockmax_scan.cu that change one
#: part of its scan (each keeps every output): no prefetch of the
#: accumulator lines, or their prefetch 1, 2 or 8 steps ahead
K4_SCAN_VARIANTS = {
    "no_prefetch": [("        asm volatile(\"prefetch.global.L1 [%0];\\n\" ::\"l\"(acc_r + d));\n",
                     "        (void)d;\n")],
    "ahead1": [("#define K4_AHEAD 4\n", "#define K4_AHEAD 1\n")],
    "ahead2": [("#define K4_AHEAD 4\n", "#define K4_AHEAD 2\n")],
    "ahead8": [("#define K4_AHEAD 4\n", "#define K4_AHEAD 8\n")],
}


def sm_clock_mhz():
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return clk[0] if clk else "not read"


def k4_entry_call(lib, args, kw, acc):
    """A call of a K4 build's C entry as the wrapper calls it, and its
    counts (matched, unsafe, pruned, n_sc), for either design of the
    source (the three-kernel one takes G and a workspace)."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    fn = lib.es_blockmax_scan
    fn.argtypes = kb._SIGNATURES["blockmax_scan"][1]
    fn.restype = ctypes.c_int
    S, NB1, BS = args[0].shape
    B, _, P = args[4].shape
    R = kw["R"]
    dev = args[0].device
    ci = torch.empty((B, S, R), dtype=torch.int32, device=dev)
    cv = torch.empty((B, S, R), device=dev)
    counts = torch.empty((4, B, S), dtype=torch.int32, device=dev)
    extra, tail, keep = (), (), None
    if len(fn.argtypes) > 24:
        from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan_plan
        G = blockmax_scan_plan(B, S, R, torch.cuda.get_device_properties(
            0).multi_processor_count)["G"]
        keep = torch.empty(B * S * G * (2 * R + 1) + 4 * B * S,
                           dtype=torch.int32, device=dev)
        extra, tail = (G,), (keep.data_ptr(),)

    def call():
        err = fn(*(a.data_ptr() for a in args[:4]), NB1, BS,
                 *(a.data_ptr() for a in args[4:]), B, S, P, kw["n_pad"],
                 kw["NB"], kw["W"], R, kw["kq_idx"], int(kw["prune_active"]),
                 *extra, acc.data_ptr(), *tail, ci.data_ptr(), cv.data_ptr(),
                 counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K4 build: error {err}")
        return keep
    return call, counts


def k4_phases(tree, args, kw, acc, reps):
    """The phases build's reading on these inputs (its C entry called as
    the wrapper calls it): per row the mean of each stamp, the cycles a
    scored step of each scan phase, the slowest row's stamps and the
    build's mean; "not measured" where the tree's source is another
    design."""
    cs = smoke()
    import torch
    keys, lib = K4_PHASE_KEYS, build_variant(
        tree, "phases", K4_PHASES_BLOCK, scratch_dir(),
        source="blockmax_scan")
    if lib is None:
        keys, lib = K4_SCAN_KEYS, build_variant(
            tree, "phases", K4_PHASES_SCAN, scratch_dir(),
            source="blockmax_scan")
    if lib is None:
        return "not measured (edit target missing: another design)"
    call, _counts = k4_entry_call(lib, args, kw, acc)
    ms = cs.timed(call, reps)
    B, S = args[4].shape[:2]
    n = min(B * S, 1 << 10)
    buf = (ctypes.c_longlong * (10 * n))()
    torch.cuda.synchronize()
    if lib.es_probe_k4_phases(buf, n):
        return "not measured (copy failed)"
    a = np.frombuffer(buf, dtype=np.int64).reshape(n, 10)[:, :len(keys)]
    mean = a.astype(np.float64).mean(0)
    out = {key: float(v) for key, v in zip(keys, mean)}
    out.update(ms=ms, rows=n, cycles_max=float(a[:, 0].max()),
               steps_max=int(a[:, 1].max()), sm_clock_mhz=sm_clock_mhz())
    steps = max(mean[1], 1.0)
    if keys is K4_SCAN_KEYS:
        out["cycles_a_step"] = {key: float(mean[i] / steps)
                                for i, key in enumerate(keys)
                                if key not in ("steps_scored",
                                               "merge_steps")}
        slow = int(np.argmax(a[:, 0]))
        out["slowest_row"] = {key: int(v) for key, v in zip(keys, a[slow])}
        return out
    out.update(cycles_a_step={key: float(mean[i] / steps) for i, key in
                              ((2, "loads"), (3, "acc_rmw"),
                               (4, "window_merge"))},
               scan_cycles_a_step=float(
                   (mean[0] - mean[5] - mean[8]) / steps))
    return out


def k4_variants(tree, args, kw, acc, reps):
    """Each scan variant's CUDA-event mean on these inputs and the steps
    it scored ("not measured" where its edit target is missing)."""
    cs = smoke()
    out = {}
    for name, edits in K4_SCAN_VARIANTS.items():
        lib = build_variant(tree, name, edits, scratch_dir(),
                            source="blockmax_scan")
        if lib is None:
            out[name] = "not measured (edit target missing)"
            continue
        call, counts = k4_entry_call(lib, args, kw, acc)
        ms = cs.timed(call, reps)
        out[name] = dict(ms=ms, blocks_scored=int(counts[3].sum()))
    return out


def run_k4(rows, reps, tree, variants):
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan
    dev = torch.device("cuda")
    _corpus, plane, mixes = prune_mixes(dev)
    for m, batches in mixes.items():
        args, kw, prep = k4_call(plane, batches[1])
        acc = plane.blockmax.scan_workspace(prep["B"] * plane.n_shards, dev)

        def call():
            return blockmax_scan(*args, **kw, acc=acc)
        out = call()
        n_sc = out[5].cpu().numpy()
        ms = cs.timed(call, reps)
        by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
        row = dict(kernel="blockmax_scan", what=f"pruned mix ({m}), checked "
                   f"batch", B=prep["B"], Q=prep["Q"], P_sched=prep["P_sched"],
                   W=prep["W"], R=prep["R"], blocks_scored=int(n_sc.sum()),
                   blocks_in_schedules=int(prep["sched_lens"].sum()),
                   unsafe=int(out[3].sum()), pruned=int(out[4].sum()),
                   matched=out[2][:, 0].cpu().numpy().tolist(), ms=ms,
                   host_ms=host_ms(call, reps),
                   device_ms=sum(by_name.values()), by_name=by_name)
        if variants:
            row["phases"] = k4_phases(tree, args, kw, acc, reps)
        emit(rows, **row)
        if variants:
            emit(rows, kernel="blockmax_scan", what=f"pruned mix ({m}), scan "
                 f"variants", **k4_variants(tree, args, kw, acc, reps))
        # the device time a dispatch over the mix's timed batches
        plane.serve(batches[0], k=cs.K)

        def serve_all():
            for b in batches[1:]:
                plane.serve(b, k=cs.K)
        by_name = cs.device_ms_by_name(serve_all, 1)
        n_disp = len(batches) - 1
        emit(rows, kernel="blockmax_scan",
             what=f"pruned mix ({m}), serve over the timed batches",
             dispatches=n_disp,
             by_name_per_dispatch={n: v / n_disp for n, v in by_name.items()})
    del plane
    torch.cuda.empty_cache()


def k3_paths(dev):
    """(path, recorded K3 calls) of one dispatch of the headline's
    ``search``, the pruned step, the exact kNN step and the hybrid step,
    at ``chip_smoke.py``'s shapes and inputs."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import knn, tiered_bm25
    from elasticsearch_tpu_torch.parallel import dist_search
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, DistributedSearchPlane, fused_search_device,
        knn_step)
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    mods = (dist_search, knn, tiered_bm25)
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(cs.VOCAB)}
    cs.sample_queries(rng, corpus, 1, batch=12)
    plane = DistributedSearchPlane([corpus], "body", device=dev)
    warm = cs.sample_queries(rng, corpus, 1)[0]
    batches = cs.sample_queries(rng, corpus, cs.TIMED_BATCHES)
    L1 = cs.workload_L(plane, [warm] + batches)
    calls = []
    with cs.recording(calls, ("topk_merge",), mods):
        plane.search(batches[0], k=cs.K, Q=cs.N_TERMS, L=L1, tiered=True)
    yield "headline search", calls
    del plane, corpus, calls
    torch.cuda.empty_cache()
    yield "pruned step (a)", pruned_k3_calls(dev)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1234)
    vecs = rng.randn(cs.KNN_ROWS, cs.KNN_DIM).astype(np.float32)
    qs = [rng.randn(cs.KNN_BATCH, cs.KNN_DIM).astype(np.float32)
          for _ in range(2)]
    plane = DistributedKnnPlane([dict(vectors=vecs)], similarity="cosine",
                                device=dev)
    del vecs
    v, vn, ex = plane._device_arrays()
    calls = []
    with cs.recording(calls, ("topk_merge",), mods):
        knn_step(v, vn, ex, torch.from_numpy(qs[1]).to(dev),
                 n_pad=plane.n_pad, k=cs.KNN_K, similarity="cosine",
                 block=plane.block)
    yield "exact kNN step", calls
    del plane, v, vn, ex, calls
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1234)
    corpus = cs.hybrid_corpus(rng, cs.HY_DOCS)
    tplane = DistributedSearchPlane([corpus], "body", device=dev)
    vecs = cs.hybrid_vectors(cs.HY_DOCS, cs.HY_DIM)
    kplane = DistributedKnnPlane([dict(vectors=vecs)],
                                 similarity="dot_product", device=dev)
    del vecs
    kplane._device_arrays()
    batches, _el, _p, _dense = cs.hybrid_traffic(rng, corpus, tplane,
                                                 cs.HY_DIM)
    calls = []
    with cs.recording(calls, ("topk_merge",), mods):
        fused_search_device(tplane, kplane, batches[1], fusion="rrf")
    yield "hybrid step", calls
    del tplane, kplane, corpus, calls
    torch.cuda.empty_cache()


def pruned_k3_calls(dev):
    """The two K3 calls of pruned mix (a)'s checked batch, as the pruned
    step makes them (and ``chip_smoke.check_pruned_kernels`` checks them):
    the B·S rows of K4's R survivors, rescored by K5, to k, then the
    shard reduce; as recorded calls."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan
    from elasticsearch_tpu_torch.ops.fused_query import bisect_exact_scores
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    _corpus, plane, mixes = prune_mixes(dev)
    args, kw, prep = k4_call(plane, mixes["a"][1])
    acc = plane.blockmax.scan_workspace(prep["B"] * plane.n_shards, dev)
    ci = blockmax_scan(*args, **kw, acc=acc)[0]
    a = prep["args"]
    score = bisect_exact_scores(a["postings_docs"], a["postings_impact"],
                                a["starts"], a["lengths"], a["idfw"], ci,
                                n_pad=plane.n_pad)[0]
    B, S, R = prep["B"], plane.n_shards, prep["R"]
    kk = min(cs.K, plane.n_pad)
    a1 = (score.reshape(B * S, R), ci.reshape(B * S, R))
    kw1 = dict(k=kk, fill_id=plane.n_pad)
    v1, d1 = topk_merge(*a1, **kw1)
    a2 = (v1.view(B, S * kk), d1.view(B, S * kk))
    kw2 = dict(k=min(cs.K, S * kk), fill_id=S * plane.n_pad, seg_len=kk,
               seg_stride=plane.n_pad)
    return [("topk_merge", a1, kw1, None), ("topk_merge", a2, kw2, None)]


def k3_shape(args, kw):
    """A K3 call's (R, ma, mb, k, dedup, seg_len, seg_stride, with_sel)."""
    R, ma = args[0].shape
    b = args[2] if len(args) > 2 else kw.get("b_vals")
    return dict(R=R, ma=ma, mb=0 if b is None else b.shape[1], k=kw["k"],
                dedup=bool(kw.get("dedup", False)),
                seg_len=kw.get("seg_len"), seg_stride=kw.get("seg_stride", 0),
                with_sel=bool(kw.get("with_sel", False)))


def k3_rows(args):
    """The rows a K3 call reduces ([a | b]), for the library yardstick."""
    import torch
    b = args[2] if len(args) > 2 else None
    return args[0] if b is None else torch.cat([args[0], b], 1)


def run_k3(rows, reps):
    """K3 on each path's recorded calls: each call's shape, plan (where
    the tree's K3 has one), CUDA-event mean, device time (``torch.profiler``)
    and host time a call; then the path's calls together beside the
    yardstick, ``torch.topk`` over the same rows, timed in the same
    call."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import topk as topk_mod
    dev = torch.device("cuda")
    plan_of = getattr(topk_mod, "topk_merge_plan", None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for path, calls in k3_paths(dev):
        k3 = [(a, kw) for _n, a, kw, _o in cs.of(calls, "topk_merge")]
        for a, kw in k3:
            shape = k3_shape(a, kw)
            plan = plan_of(shape["R"], shape["ma"] + shape["mb"], kw["k"],
                           shape["dedup"], n_sm) if plan_of else \
                "one block of 256 threads a row, k serial passes"

            def call(a=a, kw=kw):
                return topk_mod.topk_merge(*a, **kw)
            by_name = cs.device_ms_by_name(call, reps)
            emit(rows, kernel="topk_merge", what=f"{path}, one call",
                 **shape, plan=plan, ms=cs.timed(call, reps),
                 host_ms=host_ms(call, reps),
                 device_ms=sum(by_name.values()), by_name=by_name)

        def all_calls():
            return [topk_mod.topk_merge(*a, **kw) for a, kw in k3]

        def library():
            for a, kw in k3:
                x = k3_rows(a)
                torch.topk(x, min(kw["k"], x.shape[1]), dim=1)
        got = {name: dict(ms=cs.timed(fn, reps), host_ms=host_ms(fn, reps))
               for name, fn in (("k3", all_calls), ("library", library))}
        for name, fn in (("k3", all_calls), ("library", library)):
            by_name = cs.device_ms_by_name(fn, reps)
            got[name].update(device_ms=sum(by_name.values()),
                             by_name=by_name)
        emit(rows, kernel="topk_merge", what=f"{path}, all {len(k3)} calls",
             calls=len(k3), **{f"{n}_{key}": v for n, d in got.items()
                               for key, v in d.items()})
        if path.startswith(("exact", "hybrid")):
            k3_split_row(rows, reps, k3)


def k3_split_row(rows, reps, k3):
    """The kNN chunk reduce (the path's longest K3 row) as one call and
    as the two-stage split ``reduce_chunks`` made before K3 spread a row
    over blocks (groups of chunks halved while longer than 4,096
    entries), with this tree's K3: CUDA-event and device times."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    a, kw = max(k3, key=lambda c: c[0][0].shape[0] * c[0][0].shape[1])
    k, fill = kw["k"], kw["fill_id"]
    v, i = a[0], a[1]
    R, m = v.shape
    C = m // k
    if C * k != m or kw.get("seg_stride"):
        return
    if R * m == 0 or C < 2:
        return
    g = C
    while g * k > 1 << 12 and g % 2 == 0:
        g //= 2

    def one():
        return topk_merge(v, i, k=k, fill_id=fill)

    def two():
        pv, pi = topk_merge(v.reshape(R * (C // g), g * k),
                            i.reshape(R * (C // g), g * k), k=k,
                            fill_id=fill) if g < C else (v, i)
        return topk_merge(pv.reshape(R, -1), pi.reshape(R, -1), k=k,
                          fill_id=fill)
    out = {}
    for name, fn in (("one_call", one), ("two_stage", two)):
        by_name = cs.device_ms_by_name(fn, reps)
        out[name] = dict(ms=cs.timed(fn, reps),
                         device_ms=sum(by_name.values()))
    emit(rows, kernel="topk_merge", what="kNN chunk reduce: one call or two",
         R=R, chunks=C, k=k, group=g, **out)


#: text edits of the one-thread-a-row csrc/knn_outlier.cu (commit
#: fd32fbc's) that stamp its phases with clock64() in every thread: the
#: tile copy with its two barriers, the FMAs (up to a value of the last
#: accumulator), the epilogue with its inserts, and the block's whole time;
#: a block's record holds thread 0's stamps and the largest epilogue of its
#: threads
K21_PHASES = [
    ("#define K21_FC 16\n",
     "#define K21_FC 16\n"
     "__device__ long long k21_dbg[8 << 11];\n"
     "extern \"C\" int es_probe_k21_phases(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k21_dbg, n * 64);\n}\n"
     "__device__ __forceinline__ long long k21_clk() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
     "  return t;\n}\n"),
    ("  float thr = CUDART_INF_F;\n",
     "  float thr = CUDART_INF_F;\n"
     "  long long dbg_t0 = k21_clk(), dbg_cp = 0, dbg_fma = 0, dbg_epi = 0,\n"
     "            dbg_x = 0, dbg_ins = 0, dbg_sink = 0;\n"),
    ("      __syncthreads();                  // the previous chunk's reads "
     "are done\n",
     "      dbg_x = k21_clk();\n"
     "      __syncthreads();                  // the previous chunk's reads "
     "are done\n"),
    ("      __syncthreads();\n#pragma unroll\n      for (int dd = 0; dd < "
     "K21_FC; ++dd) {\n",
     "      __syncthreads();\n      dbg_cp += k21_clk() - dbg_x;\n"
     "      dbg_x = k21_clk();\n"
     "#pragma unroll\n      for (int dd = 0; dd < K21_FC; ++dd) {\n"),
    ("            acc[jj + 3] = __fmaf_rn(x, c4.w, acc[jj + 3]);\n"
     "          }\n        }\n      }\n    }\n    if (live) {\n",
     "            acc[jj + 3] = __fmaf_rn(x, c4.w, acc[jj + 3]);\n"
     "          }\n        }\n      }\n"
     "      dbg_sink += __float_as_int(acc[K21_COLS - 1]);\n"
     "      dbg_fma += k21_clk() - dbg_x;\n    }\n"
     "    dbg_x = k21_clk();\n    if (live) {\n"),
    ("          if (d2 < thr) thr = k21_insert(lst, tid, kk, d2);\n"
     "        }\n      }\n    }\n  }\n",
     "          if (d2 < thr) {\n            thr = k21_insert(lst, tid, kk, "
     "d2);\n            ++dbg_ins;\n          }\n"
     "        }\n      }\n      dbg_sink += __float_as_int(thr);\n    }\n"
     "    dbg_epi += k21_clk() - dbg_x;\n  }\n"),
    ("    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));\n  }\n}\n",
     "    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));\n  }\n"
     "  if (blockIdx.x < (1 << 11)) {\n"
     "    long long* o = k21_dbg + blockIdx.x * 8;\n"
     "    if (tid == 0) o[4] = o[7] = 0;\n"
     "    __syncthreads();\n"
     "    atomicMax((unsigned long long*)(o + 4), (unsigned long long)"
     "dbg_epi);\n    atomicAdd((unsigned long long*)(o + 7), "
     "(unsigned long long)dbg_ins);\n"
     "    if (tid == 0) {\n"
     "      o[0] = k21_clk() - dbg_t0;\n      o[1] = dbg_cp;\n"
     "      o[2] = dbg_fma;\n      o[3] = dbg_epi;\n      o[5] = dbg_ins;\n"
     "      o[6] = dbg_sink & 1;\n    }\n  }\n}\n"),
    ("",
     "\nextern \"C\" int es_knn_outlier_blocks_per_sm(int kk) {\n"
     "  const size_t lst_bytes = (size_t)kk * K21_ROWS * sizeof(float);\n"
     "  if (es_set_shared(k21_kdist, lst_bytes) != 0) return 0;\n"
     "  int nb = 0;\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k21_kdist, "
     "K21_ROWS, lst_bytes);\n  return nb;\n}\n"),
]

#: text edits of the register-tiled csrc/knn_outlier.cu that leave one
#: part out or change a size; each keeps the other parts' work alive (the
#: results are wrong, the times are the point)
K21_VARIANTS = {
    # the source as it is, built as the variants are: their yardstick
    "as_is": [],
    # the epilogue's two roundings on every row, never fma(-2, acc, s)
    "two_roundings": [("    k21_body<true>(", "    k21_body<false>(")],
    # no row's pairs ever go to the insert
    "no_inserts": [("        cand[a] = thr[a] > 0.0f &&\n",
                    "        cand[a] = thr[a] < 0.0f &&\n")],
    # no epilogue: d2, the mins and the inserts run on no tile
    "no_epilogue": [("    if (ch != nch - 1) continue;",
                     "    if (ch != nch - 1 || __float_as_int(acc[0][0]) "
                     "!= 0x7fc01234) continue;")],
    # one column tile copied, then computed on again and again
    "no_copies": [("    if (s + 1 < n_stages)\n      k21_stage(",
                   "    if (s + 1 < (n < 0 ? n_stages : 1))\n      "
                   "k21_stage(")],
    # no wait and no barrier at the top of a stage
    "no_sync": [("    asm volatile(\"cp.async.wait_group 0;\\n\" ::: "
                 "\"memory\");\n    __syncthreads();\n    int t0",
                 "    int t0")],
    # two tiles a stage, not four
    "sub2": [("#define K21_SUB 4\n", "#define K21_SUB 2\n")],
    # one block an SM: up to 255 registers a thread
    "one_block_an_sm": [("__global__ void __launch_bounds__(K21_THREADS, 2)",
                         "__global__ void __launch_bounds__(K21_THREADS, 1)")],
}

#: the same stamps for the register-tiled csrc/knn_outlier.cu (thread 0
#: of each block): the block's whole time, the wait and barrier at the top
#: of a stage, the stage's copies issued, the FMAs of a tile (up to a
#: value of the last accumulator), the d2 epilogue, the inserts' section
#: (the mins, the vote, the turns); the largest inserts' section of the
#: block's threads and the turns they took
K21_PHASES_TILES = [
    ("#define K21_THREADS 256\n",
     "#define K21_THREADS 256\n" + K21_PHASES[0][1].split("\n", 1)[1]),
    ("  const int diag = r0 / K21_BN;\n",
     "  const int diag = r0 / K21_BN;\n"
     "  long long dbg_t0 = k21_clk(), dbg_w = 0, dbg_is = 0, dbg_fm = 0,\n"
     "            dbg_ep = 0, dbg_in = 0, dbg_x = 0, dbg_turns = 0,\n"
     "            dbg_sink = 0;\n"),
    ("    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n",
     "    dbg_x = k21_clk();\n"
     "    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "    __syncthreads();\n    dbg_w += k21_clk() - dbg_x;\n"
     "    dbg_x = k21_clk();\n"),
    ("    asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");\n"
     "    const float* sqc = sqc_s[sqb];\n",
     "    asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");\n"
     "    dbg_is += k21_clk() - dbg_x;\n"
     "    const float* sqc = sqc_s[sqb];\n"),
    ("      const float* cs = cols_s[s & 1] + u * (K21_BN * K21_FC);\n",
     "      const float* cs = cols_s[s & 1] + u * (K21_BN * K21_FC);\n"
     "      dbg_x = k21_clk();\n"),
    ("      if (ch != nch - 1) continue;\n",
     "      dbg_sink += __float_as_int(acc[K21_TM - 1][K21_TN - 1]);\n"
     "      dbg_fm += k21_clk() - dbg_x;\n      dbg_x = k21_clk();\n"
     "      if (ch != nch - 1) continue;\n"),
    ("      // ---- inserts: a row whose min beats its threshold (the list's\n",
     "      dbg_sink += __float_as_int(acc[0][0]);\n"
     "      dbg_ep += k21_clk() - dbg_x;\n      dbg_x = k21_clk();\n"
     "      // ---- inserts: a row whose min beats its threshold (the list's\n"),
    ("      if (!__any_sync(0xffffffffu, any)) continue;\n",
     "      if (!__any_sync(0xffffffffu, any)) {\n"
     "        dbg_in += k21_clk() - dbg_x;\n        continue;\n      }\n"),
    ("          if (turn & (1u << lane)) {\n",
     "          if (turn & (1u << lane)) {\n            ++dbg_turns;\n"),
    ("        if (row[a] < n) thr[a] = ls[kk - 1];\n      }\n    }\n  }\n",
     "        if (row[a] < n) thr[a] = ls[kk - 1];\n      }\n"
     "      dbg_in += k21_clk() - dbg_x;\n    }\n  }\n"),
    ("    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));\n  }\n}\n",
     "    dk[i] = __fsqrt_rn(__fdiv_rn(s, (float)kk));\n  }\n"
     "  if (blockIdx.x < (1 << 11)) {\n"
     "    long long* o = k21_dbg + blockIdx.x * 8;\n"
     "    if (tid == 0) o[6] = o[7] = 0;\n    __syncthreads();\n"
     "    atomicMax((unsigned long long*)(o + 6), (unsigned long long)"
     "dbg_in);\n    atomicAdd((unsigned long long*)(o + 7), "
     "(unsigned long long)dbg_turns);\n"
     "    if (tid == 0) {\n      o[0] = k21_clk() - dbg_t0;\n"
     "      o[1] = dbg_w;\n      o[2] = dbg_is;\n      o[3] = dbg_fm;\n"
     "      o[4] = dbg_ep;\n      o[5] = dbg_in + (dbg_sink & 1);\n    }\n"
     "  }\n}\n"),
]

K21_TILE_PHASE_KEYS = ("block_cycles", "wait_and_barrier", "copies_issued",
                       "fmas", "d2_epilogue", "inserts_section",
                       "inserts_section_max_thread", "turns_block")

K21_PHASE_KEYS = ("block_cycles", "tile_copy", "fmas", "epilogue",
                  "epilogue_max_thread", "inserts_thread0", "sink",
                  "inserts_block")


def k21_input(dev):
    """(X, kk) of outlier detection (l): the standardised flights frame as
    ``chip_smoke.py``'s ML phase hands it to K21 (recorded from
    ``start_analytics``)."""
    cs = smoke()
    from elasticsearch_tpu_torch.xpack import ml
    rng = np.random.RandomState(1234)
    frame = cs.flights_frame(rng, cs.ML_FRAME_DOCS)
    svc = ml.MlService(cs.frame_search(frame), lambda index, lines: None,
                       device=dev)
    cs.ml_model(rng)
    got = []
    orig = ml.knn_kdist

    def rec(X, kk):
        got.append((X, kk))
        return orig(X, kk)
    svc.put_analytics("probe-outliers", {
        "source": {"index": "kibana_sample_data_flights"},
        "dest": {"index": "probe-outliers"},
        "analysis": {"outlier_detection": {}}})
    ml.knn_kdist = rec
    try:
        svc.start_analytics("probe-outliers")
    finally:
        ml.knn_kdist = orig
    (X, kk), = got
    return X, kk


def k21_phases(tree, X, kk, reps):
    """The phases build's reading (its C entry called as the wrapper calls
    it): the mean of each stamp over the blocks, the SM clock, and the
    build's CUDA-event mean; "not measured" where the tree's source is
    another design."""
    cs = smoke()
    import torch
    keys, lib = K21_PHASE_KEYS, build_variant(
        tree, "phases", K21_PHASES, scratch_dir(), source="knn_outlier")
    if lib is None:
        keys, lib = K21_TILE_PHASE_KEYS, build_variant(
            tree, "phases", K21_PHASES_TILES, scratch_dir(),
            source="knn_outlier")
    if lib is None:
        return "not measured (edit target missing: another design)"
    call = k21_entry_call(lib, X, kk)
    n = X.shape[0]
    ms = cs.timed(call, reps)
    nb = min(-(-n // (128 if keys is K21_PHASE_KEYS else 64)), 1 << 11)
    buf = (ctypes.c_longlong * (8 * nb))()
    call()
    torch.cuda.synchronize()
    if lib.es_probe_k21_phases(buf, nb):
        return "not measured (copy failed)"
    a = np.frombuffer(buf, dtype=np.int64).reshape(nb, 8)
    mean = a.astype(np.float64).mean(0)
    out = {key: float(v) for key, v in zip(keys, mean) if key != "sink"}
    out.update(ms=ms, blocks_read=nb, sm_clock_mhz=sm_clock_mhz(),
               cycles_max=float(a[:, 0].max()))
    occ = getattr(lib, "es_knn_outlier_blocks_per_sm", None)
    if occ is not None:
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        out["blocks_per_sm"] = occ(kk)
    return out


def k21_entry_call(lib, X, kk):
    """A call of a K21 build's C entry as the wrapper makes it."""
    import torch
    fn = lib.es_knn_outlier
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    n, f = X.shape
    sq = torch.empty(n + 1, device=X.device)
    dk = torch.empty(n, device=X.device)

    def call():
        if fn(X.data_ptr(), n, f, kk, sq.data_ptr(), dk.data_ptr(),
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("a K21 build refused the launch")
    return call


def k21_variants(tree, X, kk, reps):
    """Each of ``K21_VARIANTS``' builds' CUDA-event means on (l)'s input,
    timed in order and again in reverse order ("not measured" where the
    tree's source is another design)."""
    cs = smoke()
    out, calls = {}, {}
    for name, edits in K21_VARIANTS.items():
        lib = build_variant(tree, name, edits, scratch_dir(),
                            source="knn_outlier")
        if lib is None:
            out[name] = "not measured (edit target missing: another design)"
        else:
            calls[name] = k21_entry_call(lib, X, kk)
    for name in list(calls) + list(calls)[::-1]:
        out.setdefault(name, []).append(cs.timed(calls[name], reps))
    return out


def run_k21(rows, reps, tree):
    """K21 at (l)'s input: CUDA-event mean, device time, the launch's
    blocks an SM and registers, the bound, the library yardstick, and the
    phases build's stamps (the parent's one-thread-a-row design)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.xpack import ml
    dev = torch.device("cuda")
    X, kk = k21_input(dev)
    n, f = X.shape

    def call():
        return ml.knn_kdist(X, kk)
    ms = cs.timed(call, reps)
    by_name = cs.device_ms_by_name(call, 2)
    lib = kb.library("knn_outlier")
    occ = getattr(lib, "es_knn_outlier_blocks_per_sm", None)
    per_sm = "not measured"
    if occ is not None:
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        per_sm = occ(kk)
    regs = [ln.strip() for ln in kb.ptxas_report.get("knn_outlier",
                                                     "").splitlines()
            if "registers" in ln or "spill" in ln]
    emit(rows, kernel="knn_outlier", what="(l) outlier detection", n=n, f=f,
         kk=kk, ms=ms, device_ms=sum(by_name.values()), by_name=by_name,
         blocks_per_sm=per_sm, ptxas=regs,
         bound_ms=cs.bound(4 * n * f + 4 * n, 2 * n * n * f)[0],
         phases=k21_phases(tree, X, kk, max(reps // 2, 1)),
         variants=k21_variants(tree, X, kk, max(reps // 2, 1)))
    del X
    torch.cuda.empty_cache()


#: text edits of the one-warp-set-a-query-tile csrc/dense_stream_topk.cu
#: (the rounds design, one block a query tile and doc tile) that stamp
#: thread 0 of each block with clock64(): the
#: row loads (each load waited for), the FMAs after them, the flush's
#: first barrier, and the rest of the flush (thread 0 inserting the
#: round's candidates, then the second barrier), summed over the block's
#: rounds
K2_PHASES_ROUNDS = [
    ('#include "topk_common.cuh"\n',
     '#include "topk_common.cuh"\n'
     "__device__ long long k2_dbg[8 << 12];\n"
     "extern \"C\" int es_probe_k2_phases(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k2_dbg, n * 64);\n}\n"
     "__device__ __forceinline__ long long k2_clk() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
     "  return t;\n}\n"),
    ("  int round = 0;\n",
     "  int round = 0;\n"
     "  long long dbg_t0 = k2_clk(), dbg_ld = 0, dbg_fma = 0, dbg_bar = 0,\n"
     "            dbg_ins = 0, dbg_sink = 0;\n"),
    ("          const uint2 raw = *reinterpret_cast<const uint2*>(\n"
     "              dense + ((rows_s + (size_t)blk * T + row) * C + off));\n",
     "          const long long dbg_a = k2_clk();\n"
     "          const uint2 raw = *reinterpret_cast<const uint2*>(\n"
     "              dense + ((rows_s + (size_t)blk * T + row) * C + off));\n"
     "          dbg_sink += raw.x;\n"
     "          const long long dbg_b = k2_clk();\n"
     "          dbg_ld += dbg_b - dbg_a;\n"),
    ("            cnt[j] += (w > 0.0f) & (r[j] > 0.0f);\n          }\n",
     "            cnt[j] += (w > 0.0f) & (r[j] > 0.0f);\n          }\n"
     "          dbg_sink += __float_as_int(acc[0]);\n"
     "          dbg_fma += k2_clk() - dbg_b;\n"),
    ("      cand.flush(round, top);\n",
     "      {\n        const long long dbg_c = k2_clk();\n"
     "        __syncthreads();\n"
     "        const long long dbg_d = k2_clk();\n"
     "        dbg_bar += dbg_d - dbg_c;\n"
     "        const int dbg_n = cand.count[round % 3];\n"
     "        if (dbg_n > 0) {\n"
     "          if (tid == 0)\n"
     "            for (int i = 0; i < dbg_n; ++i) top.insert(cand.s[i], "
     "cand.d[i]);\n"
     "          __syncthreads();\n        }\n"
     "        dbg_ins += k2_clk() - dbg_d;\n      }\n"),
    ("  __syncthreads();\n  for (int bi = 0; bi < nb; ++bi) {\n",
     "  if (tid == 0) {\n"
     "    const int dbg_id = (blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x;\n"
     "    if (dbg_id < (1 << 12)) {\n"
     "      long long* o = k2_dbg + dbg_id * 8;\n"
     "      o[0] = k2_clk() - dbg_t0;\n      o[1] = dbg_ld;\n"
     "      o[2] = dbg_fma;\n      o[3] = dbg_bar;\n      o[4] = dbg_ins;\n"
     "      o[5] = round;\n      o[6] = dbg_sink & 1;\n    }\n  }\n"
     "  __syncthreads();\n  for (int bi = 0; bi < nb; ++bi) {\n"),
]

K2_ROUND_KEYS = ("block_cycles", "row_loads", "fmas", "flush_barriers",
                 "inserts_thread0", "rounds")

#: the occupancy of the rounds design at one launch (its plan: the largest
#: query tile whose tables fit, the lists in shared memory if they fit)
K2_OCC_ROUNDS = """
extern "C" int es_probe_k2_blocks_per_sm(int QB, int U, int k, int ts,
                                         int rows_max) {
  (void)QB; (void)ts; (void)rows_max;
  const size_t max_shm = (size_t)es_max_shared_bytes();
  const size_t base = (size_t)K2_CHUNK * 8;
  int bt = K2_BT_MAX;
  while (bt > 1 && base + (size_t)bt * U * 8 > max_shm) bt >>= 1;
  size_t shm = base + (size_t)bt * U * 8;
  const bool top = shm + (size_t)bt * k * 8 <= max_shm;
  if (top) shm += (size_t)bt * k * 8;
  auto kernel = top ? dense_stream_topk_kernel<true>
                    : dense_stream_topk_kernel<false>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, K2_THREADS, shm);
  return n;
}
"""

#: the same for the ring design (msm 1, 16-byte copies)
K2_OCC_RING = """
extern "C" int es_probe_k2_blocks_per_sm(int QB, int U, int k, int ts,
                                         int rows_max) {
  const size_t shm = k2_shared_bytes(QB, U, k, ts, rows_max);
  auto kernel = ts ? k2_tile_kernel<false, true, 16>
                   : k2_tile_kernel<false, false, 16>;
  if (es_set_shared(kernel, shm) != 0) return 0;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, K2_THREADS, shm);
  return n;
}
"""

#: text edits of the ring design that stamp thread 0 of each block (warp
#: 0's first lane) with clock64(): the wait for a step's copies, the
#: scoring (weights and staged rows read, FMAs), the selection's tests and
#: counts, the pushes with their merges (and the pushing passes), and the
#: tile's end (last merges, lists written, counts); "issue" stays 0 (a
#: copying warp of its own issues the copies)
K2_PHASES_RING = [
    K2_PHASES_ROUNDS[0],
    ("  int qn[K2_QW], nm[K2_QW], tdq[K2_QW];\n",
     "  long long dbg_t0 = k2_clk(), dbg_wait = 0, dbg_issue = 0,\n"
     "            dbg_score = 0, dbg_step = 0, dbg_merge = 0, dbg_nm = 0,\n"
     "            dbg_x = 0, dbg_step_at = 0;\n"
     "  int qn[K2_QW], nm[K2_QW], tdq[K2_QW];\n"),
    ("  for (int t = 0; t < nsteps; ++t) {\n"
     "    k2_bar_wait(full0 + 8 * (t % K2_STAGES), (t / K2_STAGES) & 1);\n",
     "  for (int t = 0; t < nsteps; ++t) {\n"
     "    if (t) dbg_step += k2_clk() - dbg_step_at;\n"
     "    dbg_x = k2_clk();\n"
     "    k2_bar_wait(full0 + 8 * (t % K2_STAGES), (t / K2_STAGES) & 1);\n"
     "    dbg_wait += k2_clk() - dbg_x;\n"
     "    dbg_step_at = k2_clk();\n"),
    ("        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n",
     "        const long long dbg_e = k2_clk();\n"
     "        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"),
    ("        if (!last) {\n",
     "        dbg_score += k2_clk() - dbg_e + (__float_as_int(a[0]) == 7);\n"
     "        if (!last) {\n"),
    ("        if (mb > tb || (mb == tb && tdq[qi] > cdoc)) {\n",
     "        const long long dbg_m = k2_clk();\n"
     "        if ((mb > tb || (mb == tb && tdq[qi] > cdoc)) && ++dbg_nm) {\n"),
    ("            if (lane == 0) st.ncand[q] = nc + total;\n"
     "            __syncwarp();\n          }\n        }\n",
     "            if (lane == 0) st.ncand[q] = nc + total;\n"
     "            __syncwarp();\n          }\n        }\n"
     "        dbg_merge += k2_clk() - dbg_m;\n"),
    ("  // the tile's end: the last candidates, the lists, the counts\n",
     "  const long long dbg_end = k2_clk();\n"
     "  if (nsteps) dbg_step += dbg_end - dbg_step_at;\n"
     "  // the tile's end: the last candidates, the lists, the counts\n"),
    ("      atomicAdd(&n_matched[(size_t)(b0 + q) * S + s], tot);\n  }\n}\n",
     "      atomicAdd(&n_matched[(size_t)(b0 + q) * S + s], tot);\n  }\n"
     "  if (tid == 0) {\n"
     "    const int dbg_id = (blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x;\n"
     "    if (dbg_id < (1 << 12)) {\n"
     "      long long* o = k2_dbg + dbg_id * 8;\n"
     "      o[0] = k2_clk() - dbg_t0;\n      o[1] = dbg_wait;\n"
     "      o[2] = dbg_issue;\n      o[3] = dbg_score;\n"
     "      o[4] = dbg_step - dbg_score - dbg_merge;\n"
     "      o[5] = dbg_merge;\n      o[6] = dbg_nm;\n"
     "      o[7] = k2_clk() - dbg_end;\n    }\n  }\n}\n"),
]

#: text edits of the ring design that leave one part out (the results
#: are wrong; the times say what the part costs): no copies (the ring's
#: slots keep what they hold), no scoring (no weight is read: every score
#: is 0 and no doc is pushed), no pushes (docs are counted and the warp's
#: best tested, none pushed); or with candidate buffers of 32, a ring of
#: two slots, or 12 or 8 scoring warps (6 or 8 queries each)
K2_RING_VARIANTS = {
    "no_copies": [
        ("        if (lane == 0) k2_bar_expect(full, (unsigned)(nrows * len * 2));"
         "\n", "        if (lane == 0) k2_bar_arrive(full);\n"),
        ("            k2_bulk(slot", "            if (n < 0) k2_bulk(slot")],
    "no_scoring": [("        for (; e < e1; ++e) {\n",
                    "        for (; e < 0; ++e) {\n")],
    "cand32": [("#define K2_CAND 64\n", "#define K2_CAND 32\n")],
    "warps12": [("#define K2_THREADS 512\n", "#define K2_THREADS 384\n"),
                ("#define K2_QW 4\n", "#define K2_QW 6\n")],
    "warps8": [("#define K2_THREADS 512\n", "#define K2_THREADS 256\n"),
               ("#define K2_QW 4\n", "#define K2_QW 8\n")],
    "stages2": [("#define K2_STAGES 4\n", "#define K2_STAGES 2\n")],
    "no_pushes": [("        if (mb > tb || (mb == tb && tdq[qi] > cdoc)) {\n",
                   "        if (mb == 1234567) {\n")],
}

K2_RING_KEYS = ("block_cycles", "wait_and_barrier", "issue", "scoring",
                "selection", "pushes_and_merges", "push_calls", "tile_end")


def k2_design(src: str) -> str:
    """Which design a dense_stream_topk.cu source is: "ring" or
    "rounds"."""
    return "ring" if "k2_tile_kernel" in src else "rounds"


def k2_headline(dev):
    """The headline's K2 call, as ``chip_smoke.check_kernels`` makes it:
    the 2^23-doc tiered plane, search's first timed batch (64 queries of
    four terms drawn ∝ df) at the workload's L. Returns (W, dense, u_ids,
    plane)."""
    cs = smoke()
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(cs.VOCAB)}
    cs.sample_queries(rng, corpus, 1, batch=12)
    plane = DistributedSearchPlane([corpus], "body", device=dev)
    warm = cs.sample_queries(rng, corpus, 1)[0]
    batches = cs.sample_queries(rng, corpus, cs.TIMED_BATCHES)
    L1 = cs.workload_L(plane, [warm] + batches)
    a = plane.prepare(batches[0], cs.K, Q=cs.N_TERMS, L=L1,
                      tiered=True)["args"]
    return a["W"], a["dense"], a["u_ids"], plane


def k2_launch_shape(tb, B, S, U, n_pad, k):
    """(QB, top_shared, rows_max, blocks) of a tree's K2 launch: the ring
    design's plan, or the rounds design's (query tiles of up to 16, tiles of
    ``k2_tiling``)."""
    if hasattr(tb, "dense_stream_topk_plan"):
        p = tb.dense_stream_topk_plan(B, S, U, n_pad, k,
                                      *tb.card_limits(0))
        return p["QB"], int(p["top_shared"]), p["rows_max"], p["blocks"]
    _per, n_tiles = tb.k2_tiling(n_pad, k)
    return 16, 1, 0, -(-B // 16) * n_tiles * S


def k2_phases(tree, design, call_entry, shape, reps):
    """The phases build's reading: the mean over the blocks of each stamp,
    the SM clock, the build's CUDA-event mean, blocks an SM."""
    cs = smoke()
    import torch
    if design == "ring":
        keys, edits, occ = K2_RING_KEYS, K2_PHASES_RING, K2_OCC_RING
    else:
        keys, edits, occ = K2_ROUND_KEYS, K2_PHASES_ROUNDS, K2_OCC_ROUNDS
    lib = build_variant(tree, "phases", edits + [("", occ)], scratch_dir(),
                        source="dense_stream_topk")
    if lib is None:
        return "not measured (edit target missing)"
    call = call_entry(lib)
    ms = cs.timed(call, reps)
    call()
    torch.cuda.synchronize()
    nb = min(shape[3], 1 << 12)
    buf = (ctypes.c_longlong * (8 * nb))()
    if lib.es_probe_k2_phases(buf, nb):
        return "not measured (copy failed)"
    a = np.frombuffer(buf, dtype=np.int64).reshape(nb, 8)[:, :len(keys)]
    out = {key: float(v) for key, v in zip(keys, a.astype(np.float64)
                                           .mean(0))}
    out.update(ms=ms, blocks_read=nb, sm_clock_mhz=sm_clock_mhz(),
               cycles_max=float(a[:, 0].max()))
    return out


def k2_blocks_per_sm(tree, design, shape, U, k):
    lib = build_variant(tree, "occupancy", [
        ("", K2_OCC_RING if design == "ring" else K2_OCC_ROUNDS)],
        scratch_dir(), source="dense_stream_topk")
    fn = lib.es_probe_k2_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(shape[0], U, k, shape[1], shape[2])


def run_k2(rows, reps, tree, variants):
    """K2 at the headline: CUDA-event mean and device time of the tree's
    wrapper (K2's own launch, before K3), the grid and blocks an SM, the
    registers, the rows used and the bytes the bound counts, and a digest
    of K2 → K3's (vals, docs, n_matched); with ``variants`` the stamps of
    the tree's design."""
    cs = smoke()
    import hashlib
    import importlib
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    tb = importlib.import_module("elasticsearch_tpu_torch.ops.tiered_bm25")
    dev = torch.device("cuda")
    W, dense, u_ids, plane = k2_headline(dev)
    B, S, U = W.shape
    n_pad = plane.n_pad
    k = cs.K

    def call():
        return tb.dense_stream_partials(W, dense, k=k, u_ids=u_ids)
    ms = cs.timed(call, reps)
    by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
    vals, docs, nm = tb.dense_stream_topk(W, dense, k=k, u_ids=u_ids)
    h = hashlib.sha1()
    for t in (vals, docs, nm):
        h.update(t.contiguous().cpu().numpy().tobytes())
    Wn = W.cpu().numpy()
    rows_used = int(sum(np.count_nonzero(np.any(Wn[:, s] != 0, axis=0))
                        for s in range(S)))
    nnz_w = int(np.count_nonzero(Wn))
    part_v = call()[0]
    n_lists = part_v.shape[2]
    nbytes = 2 * rows_used * n_pad + Wn.nbytes + 8 * B * S * n_lists * k \
        + 4 * B * S
    shape = k2_launch_shape(tb, B, S, U, n_pad, k)
    src = open(os.path.join(tree, "elasticsearch_tpu_torch", "csrc",
                            "dense_stream_topk.cu")).read()
    design = k2_design(src)
    regs = [ln.strip() for ln in kb.ptxas_report.get(
        "dense_stream_topk", "").splitlines()
        if "registers" in ln or "spill" in ln]
    row = dict(kernel="dense_stream_topk", what="headline, search's first "
               "timed batch", design=design, B=B, S=S, U=U, n_pad=n_pad, k=k,
               u_ids=u_ids is not None, rows_used=rows_used, nnz_w=nnz_w,
               tiles=n_lists, bound_bytes=nbytes,
               bound_ms=cs.bound(nbytes, 2 * nnz_w * n_pad)[0], ms=ms,
               host_ms=host_ms(call, reps),
               device_ms=sum(by_name.values()), by_name=by_name,
               blocks=shape[3], blocks_per_sm=k2_blocks_per_sm(
                   tree, design, shape, U, k),
               ptxas=regs, digest=h.hexdigest(),
               matched=int(nm.sum()))
    if variants:
        def entry(lib):
            fn = lib.es_dense_stream_topk
            fn.argtypes = kb._SIGNATURES["dense_stream_topk"][1]
            fn.restype = ctypes.c_int
            pv = torch.empty_like(part_v)
            pd = torch.empty(part_v.shape, dtype=torch.int32, device=dev)
            cnt = torch.zeros((B, S), dtype=torch.int32, device=dev)
            C = dense.shape[3]
            uptr = None if u_ids is None else u_ids.data_ptr()
            if design == "ring":
                p = tb.dense_stream_topk_plan(B, S, U, n_pad, k,
                                              *tb.card_limits(0))
                ws = torch.empty(p["workspace_bytes"], dtype=torch.uint8,
                                 device=dev)
                args = (W.data_ptr(), dense.data_ptr(), uptr, B, S, U,
                        dense.shape[1], dense.shape[2], C, n_pad, k, 1,
                        p["tile"], p["n_tiles"], p["QB"],
                        int(p["top_shared"]), p["rows_max"], pv.data_ptr(),
                        pd.data_ptr(), cnt.data_ptr(), ws.data_ptr(),
                        p["workspace_bytes"])
            else:
                per, n_tiles = tb.k2_tiling(n_pad, k)
                args = (W.data_ptr(), dense.data_ptr(), uptr, B, S, U,
                        dense.shape[1], dense.shape[2], C, n_pad, k, 1, per,
                        n_tiles, pv.data_ptr(), pd.data_ptr(),
                        cnt.data_ptr())

            def run():
                if fn(*args, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("a K2 build refused the launch")
            return run
        row["phases"] = k2_phases(tree, design, entry, shape,
                                  max(reps // 2, 1))
        if design == "ring":
            calls = {"as_is": entry(build_variant(
                tree, "as_is", [], scratch_dir(),
                source="dense_stream_topk"))}
            for name, edits in K2_RING_VARIANTS.items():
                lib = build_variant(tree, name, edits, scratch_dir(),
                                    source="dense_stream_topk")
                calls[name] = entry(lib) if lib is not None else None
            row["variants"] = {
                name: cs.timed(fn, reps) if fn is not None else
                "not measured (edit target missing)"
                for name, fn in calls.items()}
    emit(rows, **row)
    del plane, W, dense
    torch.cuda.empty_cache()


def digest(ts):
    """A sha1 of the tensors' bytes, equal between two trees that compute
    the same bits."""
    import hashlib
    h = hashlib.sha1()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k12_route_inputs(dev):
    """Config #3's route, as ``chip_smoke.run_aggs`` builds it: 165,346,692
    pairs in (ordinal, value) order, n_pad 2^28, the first 25 % mask."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.utils.shapes import round_up_pow2
    rng = np.random.default_rng(1234)
    off, docs_s, vals_s = cs.agg_columns(rng, cs.AGG_DOCS, cs.AGG_V)
    n_pad = round_up_pow2(cs.AGG_DOCS)
    mask_h = np.zeros(n_pad, bool)
    mask_h[:cs.AGG_DOCS] = rng.random(cs.AGG_DOCS, dtype=np.float32) < \
        cs.AGG_DENSITY
    return (torch.from_numpy(off).to(dev), torch.from_numpy(docs_s).to(dev),
            torch.from_numpy(vals_s).to(dev), torch.from_numpy(mask_h).to(dev),
            off, docs_s, vals_s)


#: K12 builds: "no_hints", the bit mask written and gathered and the pair
#: streams read with plain stores and loads; "c_evict_first", c written
#: with streaming stores; "no_discard", the bits' L2 lines left in L2
K12_PLAIN_GATHER = """
__device__ __forceinline__ bool k12_plain_gather(const unsigned* bits,
                                                 int n_pad, int doc,
                                                 unsigned long long) {
  long long d = doc < 0 ? (long long)doc + n_pad : (long long)doc;
  return d >= 0 && d < n_pad && ((bits[d >> 5] >> (d & 31)) & 1u);
}
"""
K12_VARIANTS = {"no_hints": [
    ("^", K12_PLAIN_GATHER),
    ("es_gather_bits(", "k12_plain_gather("),
    ("__ldcs(", "*("),
    ("""  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(mbits + w),
               "r"(word), "l"(es_l2_evict_last())
               : "memory");""", "  mbits[w] = word;")],
    "c_evict_first": [("c[i + 1] = p + __popc(word & upto);",
                       "__stcs(c + i + 1, p + __popc(word & upto));")],
    "no_discard": [("k12_discard_bits(mbits, n_mwords, st);", "(void)0;")]}


def run_k12(rows, reps, tree, variants):
    """K12 on config #3's route (``masked_rank_prefix``) and on the
    caches' three calls at 2^28 padded pairs (counts and sums over the
    ordinal CSR of the stand-in segment's keyword, the prefix under the
    HLL register max): CUDA-event mean and device time of each pass
    (``torch.profiler``), and a digest of the outputs; with ``variants``
    each call's mean through the builds of ``K12_VARIANTS`` and the tree's
    again, in turn (tree, variant, tree, variant), and the variant's
    digest."""
    cs = smoke()
    import types
    import torch
    from elasticsearch_tpu_torch.ops import aggs
    dev = torch.device("cuda")
    off_d, docs_d, vals_d, mask_d, off, docs_s, vals_s = \
        k12_route_inputs(dev)
    n = cs.AGG_DOCS

    libs = {name: build_variant(tree, name, edits, scratch_dir(),
                                source="agg_masked_scan")
            for name, edits in K12_VARIANTS.items()} if variants else {}

    def row(what, call, nbytes):
        ms = cs.timed(call, reps)
        by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
        out = call()
        extra = {}
        for name, lib in libs.items():
            if lib is None:
                extra[name] = "not measured (edit target missing)"
                continue
            times = []
            for turn in range(2):
                with swapped_library("agg_masked_scan", lib):
                    times.append(cs.timed(call, reps))
                    if turn == 0:
                        vout = call()
                times.append(cs.timed(call, reps))
            extra[name] = dict(
                ms=times[0::2], tree_ms=times[1::2],
                digest=digest(vout if isinstance(vout, tuple) else (vout,)))
        emit(rows, kernel="agg_masked_scan", what=what, ms=ms,
             host_ms=host_ms(call, reps),
             device_ms=sum(by_name.values()), by_name=by_name,
             bound_ms=cs.bound(nbytes, 0)[0],
             digest=digest(out if isinstance(out, tuple) else (out,)),
             **({"variants": extra} if extra else {}))
    row(f"route: masked_rank_prefix, {n} pairs",
        lambda: aggs.masked_rank_prefix(off_d, docs_d, mask_d),
        (cs.AGG_V + 1) * 4 + n * 4 + n + cs.AGG_V * 4 + (n + 1) * 4)
    # the caches of a stand-in segment of the same columns
    ords_s = np.repeat(np.arange(cs.AGG_V, dtype=np.int32), np.diff(off))
    ords_doc = np.empty(n, np.int32)
    ords_doc[docs_s] = ords_s
    vals_doc = np.empty(n, np.float32)
    vals_doc[docs_s] = vals_s
    del ords_s, off_d, docs_d, vals_d
    seg = types.SimpleNamespace(
        n_docs=n, n_pad=mask_d.shape[0],
        keyword_fields={"vendor": types.SimpleNamespace(
            dv_docs_host=np.arange(n, dtype=np.int32),
            dv_ords_host=ords_doc,
            ord_terms=[f"v{o:03d}" for o in range(cs.AGG_V)])},
        numeric_fields={"fare": types.SimpleNamespace(
            docs_host=np.arange(n, dtype=np.int32),
            vals_host=vals_doc.astype(np.float64))})
    k_off, k_docs, _V = aggs.ordinal_csr(seg, "vendor")
    hll = aggs.hll_sketch_pairs(seg, "fare")
    Mp = k_docs.shape[0]
    k_vals = np.zeros(Mp, np.float32)
    k_docs_h = k_docs.cpu().numpy()
    k_vals[:n] = vals_doc[k_docs_h[:n]]
    k_vals_d = torch.from_numpy(k_vals).to(dev)
    row(f"caches: counts (ordinal CSR, {Mp} pairs)",
        lambda: aggs.masked_ordinal_counts(k_off, k_docs, mask_d),
        Mp * 4 + n + 4 * len(k_off))
    row(f"caches: sums (ordinal CSR, {Mp} pairs)",
        lambda: aggs.masked_ordinal_sums(k_off, k_docs, k_vals_d, mask_d),
        Mp * 8 + n + 4 * len(k_off))
    row(f"caches: the register max's prefix ({hll['docs_dev'].shape[0]} "
        f"pairs)",
        lambda: aggs.masked_rank_prefix(hll["off_dev"], hll["docs_dev"],
                                        mask_d),
        hll["docs_dev"].shape[0] * 8 + n)
    del seg, hll, k_off, k_docs, k_vals_d, mask_d
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# K14's sums and counts over config #3's caches, K22 at (m)
# ---------------------------------------------------------------------------

def typed_variant(name, lib):
    """A variant build's C functions typed as ``kernels.build`` types the
    package's own library of kernel ``name``."""
    from elasticsearch_tpu_torch.kernels import build as kb
    sym, argtypes = kb._SIGNATURES[name]
    funcs = {sym: (argtypes, ctypes.c_int),
             "es_error_string": ([ctypes.c_int], ctypes.c_char_p),
             **kb._QUERIES.get(name, {})}
    for fname, (args, res) in funcs.items():
        fn = getattr(lib, fname, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib



def k14_inputs(dev):
    """Config #3's histogram cache at the caches' shape: 165,346,692 docs'
    fares (lognormal(3, 1), ``default_rng(1234)``, the smoke's
    distribution, not its draws) as ``aggs.histogram_bucket_ids`` packs
    them at interval 10 (2^28 padded pairs, 573 buckets, 1,024 padded),
    the pairs' values, and a fresh 25 % mask."""
    cs = smoke()
    import types
    import torch
    from elasticsearch_tpu_torch.ops import aggs
    from elasticsearch_tpu_torch.utils.shapes import round_up_pow2
    rng = np.random.default_rng(1234)
    n = cs.AGG_DOCS
    fares = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    n_pad = round_up_pow2(n)
    seg = types.SimpleNamespace(
        n_docs=n, n_pad=n_pad, keyword_fields={},
        numeric_fields={"fare": types.SimpleNamespace(
            docs_host=np.arange(n, dtype=np.int32),
            vals_host=fares.astype(np.float64))})
    ids, docs, n_buckets, _ = aggs.histogram_bucket_ids(
        seg, "fare", cs.AGG_HIST_INTERVAL, 0.0, device=dev)
    Mp = ids.shape[0]
    vals = np.zeros(Mp, np.float32)
    vals[:n] = fares
    mask = np.zeros(n_pad, bool)
    mask[:n] = rng.random(n, dtype=np.float32) < cs.AGG_DENSITY
    return (ids, docs, torch.from_numpy(vals).to(dev),
            torch.from_numpy(mask).to(dev), round_up_pow2(n_buckets))


#: clock64() stamps of the one-wave sums kernel (lane 0 of each warp,
#: summed over its steps, then over the block's warps): the loads of a
#: step up to its values staged (ids, docs, the gathers, the values), the
#: conflict step (the slots' matches and adds), steps that end early
#: (padding, no id in range, no match), the steps taken, and the block's
#: rows flush (thread 0)
K14_PHASE_KEYS = ("warp_cycles", "loads", "conflict_step", "early_steps",
                  "steps", "row_flush")
K14_PHASES = [
    ('#include "topk_common.cuh"\n',
     '#include "topk_common.cuh"\n'
     "__device__ unsigned long long k14_dbg[8 * 512];\n"
     "extern \"C\" int es_probe_k14_phases(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k14_dbg, n * 64);\n}\n"
     "extern \"C\" int es_probe_k14_reset() {\n"
     "  static unsigned long long z[8 * 512];\n"
     "  return (int)cudaMemcpyToSymbol(k14_dbg, z, sizeof(z));\n}\n"
     "__device__ __forceinline__ long long k14_clk() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
     "  return t;\n}\n"),
    ("  double* mine = wh + (size_t)warp * nb;\n",
     "  double* mine = wh + (size_t)warp * nb;\n"
     "  long long dbg_t0 = k14_clk(), dbg_ld = 0, dbg_cf = 0, dbg_early = 0,"
     "\n            dbg_steps = 0, dbg_s0 = 0;\n  int dbg_sink = 0;\n"),
    ("    int key[K14_SLOTS], doc[K14_SLOTS];\n",
     "    int key[K14_SLOTS], doc[K14_SLOTS];\n"
     "    dbg_s0 = k14_clk();\n    ++dbg_steps;\n"),
    ("    if (!__any_sync(0xffffffffu, any)) continue;   // padding, ids past "
     "nb\n",
     "    if (!__any_sync(0xffffffffu, any)) {\n"
     "      dbg_early += k14_clk() - dbg_s0;\n      continue;\n    }\n"),
    ("    if (!__any_sync(0xffffffffu, any)) continue;\n#pragma unroll\n"
     "    for (int s = 0; s < K14_SLOTS; ++s) {\n",
     "    if (!__any_sync(0xffffffffu, any)) {\n"
     "      dbg_early += k14_clk() - dbg_s0;\n      continue;\n    }\n"
     "#pragma unroll\n"
     "    for (int s = 0; s < K14_SLOTS; ++s) dbg_sink ^= __float_as_int(v[s]);"
     "\n    const long long dbg_s1 = k14_clk();\n    dbg_ld += dbg_s1 - dbg_s0;"
     "\n#pragma unroll\n    for (int s = 0; s < K14_SLOTS; ++s) {\n"),
    ("      __syncwarp();\n    }\n  }\n  __syncthreads();\n",
     "      __syncwarp();\n    }\n    dbg_cf += k14_clk() - dbg_s1;\n  }\n"
     "  const long long dbg_w = k14_clk() - dbg_t0;\n"
     "  __syncthreads();\n  const long long dbg_f0 = k14_clk();\n"),
    ("    row[b] = s;\n  }\n}\n",
     "    row[b] = s;\n  }\n"
     "  if (blockIdx.x < 512) {\n"
     "    unsigned long long* o = k14_dbg + blockIdx.x * 8;\n"
     "    if (lane == 0) {\n"
     "      atomicAdd(o + 0, (unsigned long long)dbg_w);\n"
     "      atomicAdd(o + 1, (unsigned long long)dbg_ld);\n"
     "      atomicAdd(o + 2, (unsigned long long)dbg_cf);\n"
     "      atomicAdd(o + 3, (unsigned long long)dbg_early);\n"
     "      atomicAdd(o + 4, (unsigned long long)dbg_steps);\n"
     "      atomicAdd(o + 6, (unsigned long long)(dbg_sink & 1));\n"
     "    }\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(o + 5, (unsigned long long)(k14_clk() - dbg_f0));\n"
     "  }\n}\n"),
]

#: the conflict step as a warp's keys sorted in registers (a bitonic sort
#: of (bucket, lane) across the lanes) and a segmented add in f64 (a scan
#: of each bucket's run), the run's last lane adding it to the row
K14_SORTED = """
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s) {
      unsigned kk = key[s] < 0 ? 0xffffffffu
                               : ((unsigned)key[s] << 5) | (unsigned)lane;
      float x = v[s];
      for (int size = 2; size <= 32; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned ok = __shfl_xor_sync(0xffffffffu, kk, stride);
          const float ox = __shfl_xor_sync(0xffffffffu, x, stride);
          const bool asc = (lane & size) == 0, low = (lane & stride) == 0;
          if (low == asc ? ok < kk : ok > kk) {
            kk = ok;
            x = ox;
          }
        }
      const int b = kk == 0xffffffffu ? -1 : (int)(kk >> 5);
      double t = (double)x;
      for (int d = 1; d < 32; d <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, t, d);
        const int ob = __shfl_up_sync(0xffffffffu, b, d);
        if (lane >= d && ob == b) t = o + t;
      }
      const int nx = __shfl_down_sync(0xffffffffu, b, 1);
      if (b >= 0 && (lane == 31 || nx != b)) mine[b] += t;
      __syncwarp();
    }
"""
K14_MATCH = """
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s) {
      stage[lane] = v[s];
      __syncwarp();
      const unsigned grp = __match_any_sync(0xffffffffu, key[s]);
      if (key[s] >= 0 && lane == __ffs(grp) - 1) {
        double acc = mine[key[s]];
        for (unsigned g = grp; g != 0; g &= g - 1)
          acc += (double)stage[__ffs(g) - 1];
        mine[key[s]] = acc;
      }
      __syncwarp();
    }
"""
#: the slots' values staged all at once (a warp's stage K14_SLOTS x 128
#: bytes, one __syncwarp a step before the slots)
K14_FULL_STAGE = """
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s) stage[s * 32 + lane] = v[s];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < K14_SLOTS; ++s) {
      const unsigned grp = __match_any_sync(0xffffffffu, key[s]);
      if (key[s] >= 0 && lane == __ffs(grp) - 1) {
        double acc = mine[key[s]];
        for (unsigned g = grp; g != 0; g &= g - 1)
          acc += (double)stage[s * 32 + __ffs(g) - 1];
        mine[key[s]] = acc;
      }
      __syncwarp();
    }
"""
#: builds of csrc/agg_bucket_reduce.cu (the one-wave design) with the
#: conflict step sorted or left out (a sink keeps the loads alive), with
#: 2 vectors a lane (also with every slot staged at once), or 264 blocks;
#: "as_is" is the source built the same way
K14_VARIANTS = {
    "as_is": [],
    "sorted": [(K14_MATCH, K14_SORTED)],
    "no_conflict_step": [(K14_MATCH, "\n    if (v[0] == -1.2345e-30f && "
                          "key[0] >= 0) mine[key[0]] = v[1];\n")],
    "vecs2": [("#define K14_VECS 4\n", "#define K14_VECS 2\n")],
    "vecs2_full_stage": [
        ("#define K14_VECS 4\n", "#define K14_VECS 2\n"),
        ("+ warp * 32;", "+ warp * K14_SLOTS * 32;"),
        ("sizeof(float) * (size_t)warps * 32;",
         "sizeof(float) * (size_t)warps * K14_SLOTS * 32;"),
        (K14_MATCH, K14_FULL_STAGE)],
    "blocks_264": [("#define K14_SUM_BLOCKS 396\n",
                    "#define K14_SUM_BLOCKS 264\n")],
}


def k14_phases(tree, call, reps):
    """The phases build's stamps on a sums call (its mean a block and a
    warp step) and its CUDA-event mean; "not measured" where the tree's
    source is another design."""
    cs = smoke()
    import torch
    lib = build_variant(tree, "phases", K14_PHASES, scratch_dir(),
                        source="agg_bucket_reduce")
    if lib is None:
        return "not measured (edit target missing: another design)"
    typed_variant("agg_bucket_reduce", lib)
    with swapped_library("agg_bucket_reduce", lib):
        ms = cs.timed(call, reps)
        lib.es_probe_k14_reset()
        call()
        torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (8 * 512))()
    if lib.es_probe_k14_phases(buf, 512):
        return "not measured (copy failed)"
    a = np.frombuffer(buf, dtype=np.int64).reshape(512, 8)
    a = a[a[:, 0] > 0].astype(np.float64)
    out = {k: float(v) for k, v in zip(K14_PHASE_KEYS, a.mean(0))}
    steps = a[:, 4].sum()
    out.update(ms=ms, blocks_read=int(a.shape[0]),
               sm_clock_mhz=sm_clock_mhz(),
               loads_a_step=float(a[:, 1].sum() / steps),
               conflict_step_a_step=float(a[:, 2].sum() / steps),
               warp_cycles_max_block=float(a[:, 0].max()))
    return out


def run_k14(rows, reps, tree, variants):
    """K14's counts and sums at config #3's caches shape (2^28 padded
    pairs, 165,346,692 real, nb = 1,024, a fresh 25 % mask): CUDA-event
    mean, host time a call, device time by kernel, the sums pass's grid,
    the bounds and a digest of the outputs; the phases build's stamps;
    with ``variants`` each build of ``K14_VARIANTS`` timed in turn with
    the tree's library (variant, tree, variant, tree) and its digest."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import aggs
    dev = torch.device("cuda")
    ids, docs, vals, mask, nb = k14_inputs(dev)
    Mp, n = ids.shape[0], cs.AGG_DOCS
    ok = (ids >= 0) & (ids < nb)
    hit = aggs.gather_mask(mask, docs) & ok
    n_in, n_hit = int(ok.sum()), int(hit.sum())
    sectors = torch.zeros((Mp + 7) // 8, dtype=torch.bool, device=dev)
    sectors[hit.nonzero().squeeze(1) // 8] = True
    n_sect = int(sectors.sum())
    del ok, hit, sectors
    counts_bytes = Mp * 4 + n_in * 4 + n + nb * 4
    calls = {
        "counts": (lambda: aggs.masked_bucket_counts(
            ids, docs, mask, n_buckets=nb), counts_bytes, counts_bytes),
        "sums": (lambda: aggs.masked_bucket_sums(
            ids, docs, vals, mask, n_buckets=nb), counts_bytes + 4 * n_hit,
            counts_bytes + 32 * n_sect)}
    ws = kb.query("agg_bucket_reduce", "es_agg_bucket_reduce_workspace_bytes",
                  Mp, nb, 1)
    libs = {}
    if variants:
        for name, edits in K14_VARIANTS.items():
            lib = build_variant(tree, name, edits, scratch_dir(),
                                source="agg_bucket_reduce")
            libs[name] = typed_variant("agg_bucket_reduce", lib) \
                if lib is not None else None
    for mode, (call, nbytes, sector_bytes) in calls.items():
        ms = cs.timed(call, reps)
        by_name = cs.device_ms_by_name(call, max(reps // 2, 1))
        out, again = call(), call()
        row = dict(kernel="agg_bucket_reduce", what=f"caches: {mode}, {Mp} "
                   f"padded pairs, {n} real, nb = {nb}", ms=ms,
                   host_ms=host_ms(call, reps),
                   device_ms=sum(by_name.values()), by_name=by_name,
                   bound_ms=cs.bound(nbytes, 0)[0],
                   bound_ms_sectors=cs.bound(sector_bytes, 0)[0],
                   pairs_in_range=n_in, pairs_added=n_hit,
                   digest=digest((out,)),
                   same_bits_twice=bool(torch.equal(
                       out.view(torch.int32), again.view(torch.int32))))
        if mode == "sums":
            row.update(sum_blocks=ws // (8 * nb),
                       phases=k14_phases(tree, call, reps))
            extra = {}
            for name, lib in libs.items():
                if lib is None:
                    extra[name] = "not measured (edit target missing)"
                    continue
                times, vout = [], None
                for _ in range(2):
                    with swapped_library("agg_bucket_reduce", lib):
                        times.append(cs.timed(call, reps))
                        vout = call()
                    times.append(cs.timed(call, reps))
                extra[name] = dict(ms=times[0::2], tree_ms=times[1::2],
                                   digest=digest((vout,)))
            if extra:
                row["variants"] = extra
        emit(rows, **row)
    del ids, docs, vals, mask
    torch.cuda.empty_cache()


def k22_input(dev):
    """(Xb, y, C, steps, lr) of classification (m): the flights frame as
    ``chip_smoke.py``'s ML phase hands it to K22 (recorded from
    ``start_analytics``)."""
    cs = smoke()
    from elasticsearch_tpu_torch.xpack import ml
    rng = np.random.RandomState(1234)
    frame = cs.flights_frame(rng, cs.ML_FRAME_DOCS)
    svc = ml.MlService(cs.frame_search(frame), lambda index, lines: None,
                       device=dev)
    got = []
    orig = ml.logreg_train

    def rec(Xb, y, n_classes, steps=500, lr=0.5):
        got.append((Xb, y, n_classes, steps, lr))
        return orig(Xb, y, n_classes, steps, lr)
    svc.put_analytics("probe-classes", {
        "source": {"index": "kibana_sample_data_flights"},
        "dest": {"index": "probe-classes"},
        "analysis": {"classification": {"dependent_variable": "FlightDelay"}},
        "analyzed_fields": {"excludes": ["FlightDelayMin"]}})
    ml.logreg_train = rec
    try:
        svc.start_analytics("probe-classes")
    finally:
        ml.logreg_train = orig
    (args,) = got
    return args


#: clock64() stamps of the persistent K22 (thread 0 of each block, summed
#: over the steps): the residuals, the tiles' partials (FMA chains and
#: stores), the grid barrier's wait, the partials' sum and the update, and
#: the block's whole time; within them thread 0's own residual rows
#: (before the block's barrier), the partials' staging (up to the barrier
#: after it) and the add chain
K22_PHASE_KEYS = ("block_cycles", "residuals", "partials", "barrier",
                  "sum_and_update", "residuals_thread0", "staging",
                  "add_chain")
K22_PHASES = [
    ('#include "topk_common.cuh"\n',
     '#include "topk_common.cuh"\n'
     "__device__ long long k22_dbg[8 * 256];\n"
     "extern \"C\" int es_probe_k22_phases(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k22_dbg, n * 64);\n}\n"
     "__device__ __forceinline__ long long k22_clk() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
     "  return t;\n}\n"),
    ("  if (resident) k22_load_rows(Xb, n, F1, 0, mine, X_s);\n"
     "  __syncthreads();\n",
     "  if (resident) k22_load_rows(Xb, n, F1, 0, mine, X_s);\n"
     "  __syncthreads();\n"
     "  long long dbg_t0 = k22_clk(), dbg_a = 0, dbg_b = 0, dbg_c = 0,\n"
     "            dbg_d = 0, dbg_x = 0, dbg_a0 = 0, dbg_st = 0, dbg_ch = 0,"
     "\n            dbg_y = 0;\n"),
    ("      }\n      __syncthreads();\n      // (b) the tiles' partials",
     "      }\n      dbg_a0 += k22_clk() - dbg_x;\n      __syncthreads();\n"
     "      // (b) the tiles' partials"),
    ("        __syncthreads();\n        if (tid < E) {\n",
     "        __syncthreads();\n        dbg_st += k22_clk() - dbg_x;\n"
     "        dbg_y = k22_clk();\n        if (tid < E) {\n"),
    ("      if (tid < E) {\n        const float w = W_s[e0 + tid];\n",
     "      dbg_ch += k22_clk() - dbg_y;\n"
     "      if (tid < E) {\n        const float w = W_s[e0 + tid];\n"),
    ("    float* P = partials + (size_t)(s & 1) * tiles * FC;\n",
     "    float* P = partials + (size_t)(s & 1) * tiles * FC;\n"
     "    dbg_x = k22_clk();\n"),
    ("      __syncthreads();\n      // (b) the tiles' partials",
     "      __syncthreads();\n      dbg_a += k22_clk() - dbg_x;\n"
     "      dbg_x = k22_clk();\n      // (b) the tiles' partials"),
    ("      __syncthreads();\n    }\n    // (c) every tile's partial",
     "      __syncthreads();\n      dbg_b += k22_clk() - dbg_x;\n"
     "      dbg_x = k22_clk();\n    }\n    // (c) every tile's partial"),
    ("    k22_grid_sync(count, (unsigned long long)(s + 1) * G);\n",
     "    k22_grid_sync(count, (unsigned long long)(s + 1) * G);\n"
     "    dbg_c += k22_clk() - dbg_x;\n    dbg_x = k22_clk();\n"),
    ("    __syncthreads();\n  }\n  if (blockIdx.x == 0)\n",
     "    __syncthreads();\n    dbg_d += k22_clk() - dbg_x;\n  }\n"
     "  if (tid == 0 && blockIdx.x < 256) {\n"
     "    long long* o = k22_dbg + blockIdx.x * 8;\n"
     "    o[0] = k22_clk() - dbg_t0;\n    o[1] = dbg_a;\n    o[2] = dbg_b;\n"
     "    o[3] = dbg_c;\n    o[4] = dbg_d;\n    o[5] = dbg_a0;\n"
     "    o[6] = dbg_st;\n    o[7] = dbg_ch;\n  }\n"
     "  if (blockIdx.x == 0)\n"),
]

#: builds of the persistent csrc/logreg_train.cu, timed beside "as_is",
#: the source built the same way: the residuals with the fast exp and
#: division (other bits), with no label load, or left out; 1,024 threads
#: a block (512 in the source)
K22_VARIANTS = {
    "as_is": [],
    "fast_exp_div": [
        ("    zr[c] = expf(__fsub_rn(zr[c], m));",
         "    zr[c] = __expf(__fsub_rn(zr[c], m));"),
        ("    z[c] = __fsub_rn(__fdiv_rn(zr[c], sum), label == c ? 1.0f : "
         "0.0f);", "    z[c] = __fsub_rn(__fdividef(zr[c], sum), label == c ? "
         "1.0f : 0.0f);")],
    "no_label_load": [("        const int label = y[r0 + r];",
                       "        const int label = r & 1;")],
    "no_residuals": [("          k22_residual_regs(x, W_s, F1, C, label, z);",
                      "          z[0] = x[0] + (float)label;")],
    "threads_1024": [("#define K22_THREADS 512\n",
                      "#define K22_THREADS 1024\n")],
}

#: appended to either design of csrc/logreg_train.cu: the blocks an SM of
#: its (first) kernel at the shared memory its entry gives it for (n, F1,
#: C)
K22_OCCUPANCY = {
    "persistent": """
extern "C" int es_probe_k22_blocks_per_sm(int n, int F1, int C) {
  int G, K, stage;
  size_t smem;
  if (k22_plan(n, F1, C, &G, &K, &stage, &smem) != 0 ||
      es_set_shared(k22_train, smem) != 0)
    return 0;
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k22_train, K22_THREADS,
                                                smem);
  return b;
}
""",
    "steps": """
extern "C" int es_probe_k22_blocks_per_sm(int n, int F1, int C) {
  (void)n;
  const size_t smem = k22_shared_bytes(F1, C);
  if (es_set_shared(k22_partials, smem) != 0) return 0;
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k22_partials, K22_ROWS,
                                                smem);
  return b;
}
"""}


def run_k22(rows, reps, tree, variants):
    """K22 at (m)'s call (131,072 x 8 columns, 2 classes, 500 steps): the
    run's and a step's CUDA-event mean, host time a step, device time by
    kernel, the grid and blocks an SM, the bound, a digest of W and the
    phases build's stamps (the persistent design); with ``variants`` each
    build of ``K22_VARIANTS`` timed in turn with the tree's library and its
    digest of W."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.xpack import ml
    dev = torch.device("cuda")
    Xb, y, C, steps, lr = k22_input(dev)
    n, F1 = Xb.shape

    def call():
        return ml.logreg_train(Xb, y, C, steps, lr)
    ms = cs.timed(call, reps)
    by_name = cs.device_ms_by_name(call, 2)
    n0 = kb.launches["logreg_train"]
    W, again = call(), call()
    launches = (kb.launches["logreg_train"] - n0) // 2
    src = open(os.path.join(tree, "elasticsearch_tpu_torch", "csrc",
                            "logreg_train.cu")).read()
    design = "persistent" if "k22_train" in src else "steps"
    occ = build_variant(tree, "occupancy", [("", K22_OCCUPANCY[design])],
                        scratch_dir(), source="logreg_train")
    per_sm = "not measured"
    if occ is not None:
        occ.es_probe_k22_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        occ.es_probe_k22_blocks_per_sm.restype = ctypes.c_int
        per_sm = occ.es_probe_k22_blocks_per_sm(n, F1, C)
    tiles = -(-n // 256)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    grid = min(tiles, n_sm) if design == "persistent" else \
        f"{tiles} tiles, then 1 block, a step"
    phases = "not measured (another design)"
    if design == "persistent":
        lib = build_variant(tree, "phases", K22_PHASES, scratch_dir(),
                            source="logreg_train")
        if lib is None:
            phases = "not measured (edit target missing)"
        else:
            typed_variant("logreg_train", lib)
            with swapped_library("logreg_train", lib):
                p_ms = cs.timed(call, max(reps // 2, 1))
                call()
                torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (8 * 256))()
            lib.es_probe_k22_phases(buf, 256)
            a = np.frombuffer(buf, dtype=np.int64).reshape(256, 8)[:grid]
            a = a.astype(np.float64)
            phases = {k: float(v) for k, v in zip(K22_PHASE_KEYS, a.mean(0))}
            phases.update(
                ms=p_ms, sm_clock_mhz=sm_clock_mhz(),
                block_cycles_max=float(a[:, 0].max()),
                a_step={k: float(v) / steps for k, v in
                        zip(K22_PHASE_KEYS, a.mean(0))})
    extra = {}
    if variants and design == "persistent":
        for name, edits in K22_VARIANTS.items():
            lib = build_variant(tree, name, edits, scratch_dir(),
                                source="logreg_train")
            if lib is None:
                extra[name] = "not measured (edit target missing)"
                continue
            typed_variant("logreg_train", lib)
            times, vout = [], None
            for _ in range(2):
                with swapped_library("logreg_train", lib):
                    times.append(cs.timed(call, reps))
                    vout = call()
                times.append(cs.timed(call, reps))
            extra[name] = dict(ms=times[0::2], tree_ms=times[1::2],
                               digest=digest((vout,)))
    emit(rows, kernel="logreg_train", what="(m) classification", n=n, F1=F1,
         C=C, steps=steps, design=design, ms=ms, ms_step=ms / steps,
         host_ms_step=host_ms(call, max(reps // 4, 1)) / steps,
         device_ms=sum(by_name.values()), by_name=by_name,
         launches_a_run=launches, grid=grid, blocks_per_sm=per_sm,
         bound_ms=cs.bound(4 * n * F1 + 4 * n + 4 * F1 * C,
                           steps * (4 * n * F1 * C + 6 * n * C))[0],
         bound_ms_rereading=steps * cs.bound(
             4 * n * F1 + 4 * n + 8 * F1 * C, 0)[0],
         digest=digest((W,)), same_bits_twice=bool(torch.equal(
             W.view(torch.int32), again.view(torch.int32))),
         phases=phases, **({"variants": extra} if extra else {}))
    del Xb, y
    torch.cuda.empty_cache()


def k19_inputs(dev):
    """masked_topk's calls on the per-segment path at 2^23 docs, recorded
    as the smoke records them: mix (e)'s first request (k = 10) and (i)'s
    first pair, the same match from 990 and from 9,990 (k = 1,000 and
    10,000); and (e)'s scores with all but five docs masked out at k = 10
    (fewer docs matched than k: the k-th key is the masked -inf).
    Returns ([(label, args)], the segment)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import topk as topk_mod
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    tag, price = cs.segment_columns(cs.N_DOCS)
    seg, mapper = cs.segment_index(corpus, tag, price, dev)
    searcher = ShardSearcher([seg], mapper)
    rng = np.random.RandomState(4321)
    bags = [[f"w{t[1:]}" for t in q] for q in
            cs.sample_queries(rng, corpus, 1, batch=cs.SEG_TIMED + 1)[0]]
    match = {"match": {"body": " ".join(bags[0])}}
    rec = []
    with cs.recording(rec, ("masked_topk",), (topk_mod,)):
        searcher.search({"query": match, "size": 10})
        for start in cs.SEG_PAGES:
            searcher.search({"query": match, "from": start, "size": 10})
    cases = [(f"{'(e)' if a[2] == 10 else '(i)'} k={a[2]}", a)
             for _n, a, _kw, _o in rec]
    scores, mask, _k = cases[0][1]
    few = torch.zeros_like(mask)
    few[torch.nonzero(mask)[:5, 0]] = True
    cases.append(("(e) scores, 5 docs matched, k=10", (scores, few, 10)))
    return cases, seg


#: a build of csrc/segment_topk.cu (the one-launch design) whose block 0
#: stamps %globaltimer at its phases' ends: start, each level's pass, its
#: barrier and its bucket, the collect, its barrier, the sort, the merge's
#: barrier, the end
K19_STAMPS = [
    ('#include "sort_common.cuh"\n',
     '#include "sort_common.cuh"\n'
     "__device__ long long k19_dbg[24];\n"
     "__device__ int k19_dbg_n;\n"
     "extern \"C\" int es_probe_k19_stamps(long long* out) {\n"
     "  int n = 0;\n"
     "  cudaMemcpyFromSymbol(&n, k19_dbg_n, sizeof(int));\n"
     "  cudaMemcpyFromSymbol(out, k19_dbg, 24 * sizeof(long long));\n"
     "  return n;\n}\n"
     "__device__ __forceinline__ long long k19_now() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)::\"memory\");"
     "\n  return t;\n}\n"
     "#define K19_STAMP() if (blockIdx.x == 0 && threadIdx.x == 0 && "
     "dbg_n < 24) k19_dbg[dbg_n++] = k19_now()\n"),
    ("  unsigned key[K19_VEC];\n\n  // ---- levels",
     "  unsigned key[K19_VEC];\n  int dbg_n = 0;\n  K19_STAMP();\n\n"
     "  // ---- levels"),
    ("    k19_grid_sync(ctl);\n\n    // every block",
     "    K19_STAMP();\n    k19_grid_sync(ctl);\n    K19_STAMP();\n\n"
     "    // every block"),
    ("    cur = sel_s;\n", "    cur = sel_s;\n    K19_STAMP();\n"),
    ("  k19_grid_sync(ctl);\n\n  // ---- sort the M survivors",
     "  K19_STAMP();\n  k19_grid_sync(ctl);\n  K19_STAMP();\n\n"
     "  // ---- sort the M survivors"),
    ("  if (C > 1) {\n    k19_grid_sync(ctl);\n",
     "  K19_STAMP();\n  if (C > 1) {\n    k19_grid_sync(ctl);\n"
     "    K19_STAMP();\n"),
    ("  }\n}\n\n// -------------------------------------------------------------"
     "--------------\n// Entries",
     "  }\n  K19_STAMP();\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
     "k19_dbg_n = dbg_n;\n}\n\n// ---------------------------------------------"
     "------------------------------\n// Entries")]


def k19_phases(tree, call, levels_hint=None):
    """The stamps build's phase times (µs) of one call, by name."""
    lib = build_variant(tree, "stamps", K19_STAMPS, scratch_dir(),
                        source="segment_topk")
    if lib is None:
        return "not measured (another design)"
    import torch
    typed_variant("segment_topk", lib)
    lib.es_probe_k19_stamps.argtypes = [ctypes.c_void_p]
    lib.es_probe_k19_stamps.restype = ctypes.c_int
    with swapped_library("segment_topk", lib):
        call()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 24)()
    n = lib.es_probe_k19_stamps(ctypes.addressof(buf))
    t = np.frombuffer(buf, dtype=np.int64)[:n].astype(np.float64)
    # start, then (pass, barrier, bucket) a level, then collect, barrier,
    # sort, [merge barrier], end
    names = []
    levels = (n - 5 - (1 if n % 3 == 0 else 0)) // 3
    for lv in range(levels):
        names += [f"level{lv}_pass", f"level{lv}_barrier",
                  f"level{lv}_bucket"]
    names += ["collect", "collect_barrier", "sort"]
    if len(names) + 2 < n:
        names.append("merge_barrier")
    names.append("merge_or_end")
    d = np.diff(t) / 1e3
    return dict(zip(names, [float(x) for x in d]), total_us=float(
        (t[-1] - t[0]) / 1e3), stamps=int(n))


#: builds of csrc/segment_topk.cu (the one-launch design): "match", the
#: histograms' equal digits grouped by __match_any_sync before one shared
#: atomic (the tree adds a key an atomic); "ft512", blocks of 512 threads
#: (128 registers a thread)
K19_VARIANTS = {
    "match": [("        if (dig >= 0) atomicAdd(&sh[dig], 1u);",
               "        if (__any_sync(0xffffffffu, dig >= 0)) {\n"
               "          const unsigned grp = __match_any_sync(0xffffffffu,"
               " dig);\n"
               "          if (dig >= 0 && lane == __ffs(grp) - 1)\n"
               "            atomicAdd(&sh[dig], (unsigned)__popc(grp));\n"
               "        }")],
    "ft512": [("#define K19_FT 1024 ", "#define K19_FT 512 ")]}


def k19_variants(tree, calls, reps):
    """Each build of ``K19_VARIANTS`` timed in turn with the tree's library
    on each call (variant, tree, variant, tree), with its digest."""
    import torch
    out = {}
    for name, edits in K19_VARIANTS.items():
        lib = build_variant(tree, name, edits, scratch_dir(),
                            source="segment_topk")
        if lib is None:
            out[name] = "not measured (edit target missing)"
            continue
        typed_variant("segment_topk", lib)
        got = {}
        for label, call in calls.items():
            times, vout = [], None
            for _ in range(2):
                with swapped_library("segment_topk", lib):
                    times.append(cs_timed(call, reps))
                    vout = call()
                    torch.cuda.synchronize()
                times.append(cs_timed(call, reps))
            got[label] = dict(ms=times[0::2], tree_ms=times[1::2],
                              digest=digest(vout))
        out[name] = got
    return out


def cs_timed(call, reps):
    return smoke().timed(call, reps)


def run_k19(rows, reps, tree, variants):
    """K19 at the per-segment path's calls (``k19_inputs``): CUDA-event
    mean, host ms a call, device ms by kernel and device events a call
    (``torch.profiler``), the bound, a digest of (values, indices) and
    whether they equal the plain version's bits; the one-launch design's
    phase stamps."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops.topk import (masked_topk,
                                                  masked_topk_plain)
    dev = torch.device("cuda")
    cases, seg = k19_inputs(dev)
    for label, args in cases:
        scores, mask, k = args
        n = scores.shape[0]

        def call(a=args):
            return masked_topk(*a)
        out = call()
        want = masked_topk_plain(*args)
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(out, want))
        ms = cs.timed(call, reps)
        by_name = cs.device_ms_by_name(call, reps)
        events = cs.device_events_a_call(call, reps) \
            if hasattr(cs, "device_events_a_call") else "not measured"
        row = dict(kernel="segment_topk", what=label, n=n, k=k,
                   matched=int(mask.sum()), ms=ms,
                   host_ms=host_ms(call, reps),
                   device_ms=sum(by_name.values()), by_name=by_name,
                   device_events_a_call=events,
                   bound_ms=cs.bound(5 * n + 8 * k, n)[0],
                   digest=digest(out), equals_plain=bool(same))
        if variants:
            row["phases_us"] = k19_phases(tree, call)
        emit(rows, **row)
    if variants:
        picked = {label: (lambda a=args: masked_topk(*a))
                  for label, args in cases if args[2] in (10, 10000)}
        emit(rows, kernel="segment_topk", what="variants",
             variants=k19_variants(tree, picked, reps))
    del seg, cases
    torch.cuda.empty_cache()


#: a build of csrc/ivf_scan.cu (the deep path's design) whose blocks'
#: thread 0 adds %globaltimer intervals to five slots a block: the levels'
#: scoring passes, their barriers and decisions, the collect (and its
#: barrier), the chunks' sort (and its barrier), the placement
K7_STAMPS = [
    ('#include "sort_common.cuh"\n',
     '#include "sort_common.cuh"\n'
     "__device__ long long k7_dbg[4096 * 8];\n"
     "extern \"C\" int es_probe_k7_stamps(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k7_dbg, n * 64);\n}\n"
     "__device__ __forceinline__ long long k7_now() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)::"
     "\"memory\");\n  return t;\n}\n"
     "#define K7_STAMP(slot) if (threadIdx.x == 0) { const long long nw_ = "
     "k7_now(); dbg[slot] += nw_ - dbg_last; dbg_last = nw_; }\n"),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n"
     "  long long* dbg = k7_dbg + 8 * blockIdx.x;\n"
     "  long long dbg_last = 0;\n"
     "  if (threadIdx.x == 0) { for (int i = 0; i < 8; ++i) dbg[i] = 0; "
     "dbg_last = k7_now(); }\n"),
    ("    grid.sync();\n    for (int u = blockIdx.x; u < n_units; "
     "u += gridDim.x) {\n      const int qs = u / G;\n",
     "    K7_STAMP(0);\n    grid.sync();\n    for (int u = blockIdx.x; "
     "u < n_units; u += gridDim.x) {\n      const int qs = u / G;\n"),
    ("    if (L == K7_LEVELS - 1 || *(volatile unsigned*)(ctl + L) == 0u) "
     "break;\n",
     "    K7_STAMP(1);\n    if (L == K7_LEVELS - 1 || *(volatile "
     "unsigned*)(ctl + L) == 0u) break;\n"),
    ("  // 3. sort each chunk of survivors: a block merge sort, two keys a\n",
     "  K7_STAMP(2);\n  // 3. sort each chunk of survivors: a block merge "
     "sort, two keys a\n"),
    ("  // 4. place each chunk's keys by their ranks among all survivors\n",
     "  K7_STAMP(3);\n  // 4. place each chunk's keys by their ranks among "
     "all survivors\n"),
    ("        op[rank[i]] = pos;\n      }\n    }\n  }\n}\n",
     "        op[rank[i]] = pos;\n      }\n    }\n  }\n"
     "  __syncthreads();\n  K7_STAMP(4);\n}\n")]
K7_STAMP_KEYS = ("score_passes", "level_barriers", "collect", "sort",
                 "place")


def k7_phases(tree, call, blocks):
    """The stamps build's µs a deep-path block spends in each phase: the
    mean over blocks and the slowest block's."""
    lib = build_variant(tree, "stamps", K7_STAMPS, scratch_dir(),
                        source="ivf_scan")
    if lib is None:
        return "not measured (another design)"
    import torch
    typed_variant("ivf_scan", lib)
    with swapped_library("ivf_scan", lib):
        call()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (8 * blocks))()
    lib.es_probe_k7_stamps(buf, blocks)
    a = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 8)[:, :5] / 1e3
    out = {f"{k}_mean": float(a[:, i].mean())
           for i, k in enumerate(K7_STAMP_KEYS)}
    out.update({f"{k}_max": float(a[:, i].max())
                for i, k in enumerate(K7_STAMP_KEYS)})
    out["block_us_max"] = float(a.sum(1).max())
    return out


def k7_grid(kb, knn_mod, B, S, Pw, R, D, nlist, n_rows):
    """K7's launch shape at one window: the tree's (the mask grid, then
    the window path's scan grid or the deep path's cooperative grid and
    parts), or a parent's chunk path (chunks, the lists' workspace bytes,
    row tiles a block: each tile's merge reads and writes the block's
    lists)."""
    mask = [Pw, S, -(-B // 32)]
    if not hasattr(knn_mod, "ivf_scan_partials"):
        G = kb.query("ivf_scan", "es_ivf_scan_parts", B, S, R, D, nlist)
        if R <= knn_mod.K7_WINDOW_MAX:
            return dict(mask=mask, scan=[G, S, B])
        return dict(mask=mask, deep_blocks=kb.query(
            "ivf_scan", "es_ivf_deep_grid", D, nlist), parts=G)
    if R <= getattr(knn_mod, "K7_WINDOW_MAX", 0):
        return dict(mask=mask, scan=[kb.query(
            "ivf_scan", "es_ivf_window_parts", B, S, R), S, B])
    return None


def run_k7(rows, reps, tree=HERE, variants=False, ks=None):
    """K7 at the IVF shape (``ivf_plane``, the first query batch) at three
    windows: the IVF step's (k = 10), serve(k = 1,000)'s and serve(k =
    10,000)'s (``ks``, by default all three). For each: CUDA-event mean, host ms a call, device ms by
    kernel, launches a call, the grid, the plain version's mean, a digest
    of the window and its error against the plain version. A parent whose
    deep windows go through chunk lists and K3 also gets its chunk lists
    alone (``ivf_scan_partials``): their time, grid and workspace.
    ``--variants`` adds the deep path's block stamps (``K7_STAMPS``)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import knn as knn_mod
    dev = torch.device("cuda")
    _corpus, plane, _g, _p, q_batch = cs.ivf_plane(dev)
    qb = q_batch()
    nlist, blk = plane.ivf.nlist, plane.ivf.block
    for k in ks or (cs.IVF_K, cs.IVF_DEEP_K, cs.IVF_DEEPEST_K):
        a, R, Pw, qq, qn, scan_in, scan_kw = cs.ivf_step_inputs(plane, qb,
                                                                k=k)
        B, S, D = qq.shape[0], a["u_blocks"].shape[0], qq.shape[1]

        def call(scan_in=scan_in, scan_kw=scan_kw, R=R):
            return knn_mod.ivf_scan(*scan_in, **scan_kw, nlist=nlist,
                                    r_cand=R)
        wv, wp = call()
        pv, pp = knn_mod.ivf_scan_plain(*scan_in, **scan_kw, r_cand=R)
        n0 = dict(kb.launches)
        call()
        torch.cuda.synchronize()
        launched = {n: v - n0[n] for n, v in kb.launches.items()
                    if v != n0[n]}
        grid = k7_grid(kb, knn_mod, B, S, Pw, R, D, nlist, Pw * blk)
        fin = torch.isfinite(wv)
        row = dict(kernel="ivf_scan", what=f"window k={k}", B=B, S=S, Pw=Pw,
                   R=R, live=int(fin.sum()), ms=cs.timed(call, 5 * reps),
                   host_ms=host_ms(call, 5 * reps),
                   plain_ms=cs.timed(lambda: knn_mod.ivf_scan_plain(
                       *scan_in, **scan_kw, r_cand=R), 3),
                   launches_a_call=launched, grid=grid,
                   digest=digest((wv, wp)),
                   max_abs_err_vs_plain=float(
                       (wv - pv).abs()[fin].max().item())
                   if bool(fin.any()) else 0.0,
                   pos_equal_plain=bool(torch.equal(wp, pp)))
        by_name = cs.device_ms_by_name(call, reps)
        row.update(device_ms=sum(by_name.values()), by_name=by_name)
        if variants and grid and "deep_blocks" in grid:
            row["phases_us"] = k7_phases(tree, call, grid["deep_blocks"])
        emit(rows, **row)
        if hasattr(knn_mod, "ivf_scan_partials") and \
                R > getattr(knn_mod, "K7_WINDOW_MAX", 0):
            def lists(scan_in=scan_in, scan_kw=scan_kw, R=R):
                return knn_mod.ivf_scan_partials(*scan_in, **scan_kw,
                                                 nlist=nlist, r_cand=R)
            C = lists()[0].shape[2]
            ws = kb.query("ivf_scan", "es_ivf_scan_workspace_bytes", B, S,
                          C, R, nlist, D)
            tiles = -(-Pw * blk // knn_mod.TILE_ROWS)
            by_lists = cs.device_ms_by_name(lists, reps)
            emit(rows, kernel="ivf_scan", what=f"chunk lists k={k}", R=R,
                 ms=cs.timed(lists, 5 * reps),
                 device_ms=sum(by_lists.values()), by_name=by_lists,
                 grid=[C, S, -(-B // knn_mod.QUERY_TILE)],
                 workspace_bytes=ws, tiles_a_block=-(-tiles // C),
                 list_bytes_a_block=min(B, knn_mod.QUERY_TILE) * R * 8)
    del plane
    torch.cuda.empty_cache()


def k17_inputs(dev):
    """postings_match's calls on the per-segment path at 2^23 docs,
    recorded as the smoke's calls are: mix (g)'s terms filter (its first
    request's three tags) and a prefix query's one run (``tag0``: the
    postings of 100 tags). Returns ([(label, args, kwargs)], the
    segment)."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops import masks as masks_mod
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    tag, price = cs.segment_columns(cs.N_DOCS)
    seg, mapper = cs.segment_index(corpus, tag, price, dev)
    searcher = ShardSearcher([seg], mapper)
    top_tags = np.argsort(-np.bincount(tag, minlength=cs.SEG_TAGS))[:32]
    three = [int(x) for x in np.random.RandomState(100).choice(
        top_tags, 3, replace=False)]
    rec = []
    with cs.recording(rec, ("postings_match",), (masks_mod,)):
        searcher.search({"query": {"bool": {"filter": [{"terms": {"tag": [
            f"tag{o:03d}" for o in three]}}]}}, "size": 10})
        searcher.search({"query": {"bool": {"filter": [{"prefix": {
            "tag": "tag0"}}]}}, "size": 10})
    (_n, a_g, kw_g, _o), (_n, a_p, kw_p, _o) = rec[0], rec[-1]
    return [("(g) terms filter, three tags", a_g, kw_g),
            ("prefix tag0, one run", a_p, kw_p)], seg


def run_k17(rows, reps):
    """K17 at (g)'s terms filter and at one prefix run on the 2^23-doc
    segment: CUDA-event mean, host ms a call, device ms by kernel (or
    memset) and device events a call, the valid postings and the bound,
    a digest, and whether the counts are the plain version's."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import masks as masks_mod
    dev = torch.device("cuda")
    cases, seg = k17_inputs(dev)
    for label, a, kw in cases:
        def call(a=a, kw=kw):
            return masks_mod.postings_match(*a, **kw)
        got = call()
        want = masks_mod.postings_match_plain(*a, **kw)
        lens = np.clip(np.asarray(a[2], np.int64), 0, kw["L"])
        V = int(lens.sum())
        n_pad = kw["segment_pad"]
        # a grid of min(ceil(L / 256), 1,024) blocks of 256 threads a run,
        # whatever its length (the one-kernel-a-run design before the
        # cooperative one): the blocks with no posting
        bx = max(1, min(-(-kw["L"] // 256), 1024))
        idle = int(np.maximum(bx - -(-lens // 256), 0).sum())
        by_name = cs.device_ms_by_name(call, reps)
        emit(rows, kernel="postings_match", what=label, Q=len(lens),
             L=kw["L"], lengths=lens.tolist(), valid_postings=V,
             n_pad=n_pad, run_grid_blocks=bx * len(lens),
             run_grid_idle_blocks=idle,
             ms=cs.timed(call, 5 * reps), host_ms=host_ms(call, 5 * reps),
             device_ms=sum(by_name.values()), by_name=by_name,
             device_events_a_call=cs.device_events_a_call(call, reps),
             bound_ms=cs.bound(4 * V + 4 * n_pad, V)[0],
             digest=digest((got,)), equal_plain=bool(torch.equal(got, want)))
    del seg
    torch.cuda.empty_cache()

#: the wrappers K5 and K10 are called through, by kernel entry
K5_K10_WRAPPERS = {"bisect_exact_scores": ("bisect_exact_scores",
                                           "bisect_exact_scores_plain"),
                   "fuse_rank": ("fuse_rank", "fuse_rank_plain")}


def recorded_row(rows, name, what, calls, reps, **extra):
    """One row for the calls of kernel ``name`` that one dispatch made
    (``calls``: the recorded (args, kwargs) in order), replayed together:
    CUDA-event ms, host ms (enqueued back to back), device ms by kernel and
    device events (``torch.profiler``), whether the outputs are the plain
    version's bits, and a digest."""
    cs = smoke()
    from elasticsearch_tpu_torch.ops import fused_query as fq
    wrap, plain = (getattr(fq, n) for n in K5_K10_WRAPPERS[name])

    def call():
        return [wrap(*a, **kw) for a, kw in calls]
    got = call()
    want = [plain(*a, **kw) for a, kw in calls]
    same = all(len(g) == len(w) and all(cs.same_bits(x, y)
                                        for x, y in zip(g, w))
               for g, w in zip(got, want))
    by_name = cs.device_ms_by_name(call, reps)
    shapes = [[list(x.shape) for x in list(a) + list(kw.values())
               if hasattr(x, "shape")] for a, kw in calls]
    emit(rows, kernel=name, what=what, calls_a_dispatch=len(calls),
         shapes=shapes, ms=cs.timed(call, 5 * reps),
         host_ms=host_ms(call, 5 * reps), device_ms=sum(by_name.values()),
         by_name=by_name,
         device_events_a_call=cs.device_events_a_call(call, reps),
         equals_plain=bool(same),
         digest=digest([x for g in got for x in g]), **extra)


#: builds of csrc/bisect_exact_scores.cu at other sizes: T (pivots a
#: slot) of 32 and 1,024 in place of 128, and a block's candidates (RC) a
#: quarter or four times what the C entry picks
_K5_RC_LINE = "  while (rc * n_sm < work && rc < K5_ITEMS) rc <<= 1;\n"
K5_VARIANTS = {
    "T32": [("#define K5_PIVOTS 128\n", "#define K5_PIVOTS 32\n")],
    "T1024": [("#define K5_PIVOTS 128\n", "#define K5_PIVOTS 1024\n")],
    "RC_quarter": [(_K5_RC_LINE,
                    _K5_RC_LINE + "  rc = rc >= 4 ? rc / 4 : 1;\n")],
    "RC_x4": [(_K5_RC_LINE, _K5_RC_LINE + "  rc *= 4;\n")]}


def k5_variants(calls, reps):
    """Each build of ``K5_VARIANTS`` of this tree's source on the recorded
    calls: its device ms by ``torch.profiler`` (all calls of the dispatch)
    beside the tree's build's, and whether its outputs are the tree's
    bits."""
    import torch
    cs = smoke()
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import fused_query as fq

    def call():
        return [fq.bisect_exact_scores(*a, **kw) for a, kw in calls]
    want = call()
    out = {"tree_device_ms": sum(cs.device_ms_by_name(call, reps).values())}
    for name, edits in K5_VARIANTS.items():
        lib = build_variant(str(kb.PKG_DIR.parent), name, edits,
                            scratch_dir(), source="bisect_exact_scores")
        if lib is None:
            out[name] = "not measured (edit target missing)"
            continue
        typed_variant("bisect_exact_scores", lib)
        with swapped_library("bisect_exact_scores", lib):
            got = call()
            torch.cuda.synchronize()
            by = cs.device_ms_by_name(call, reps)
        out[name] = dict(
            device_ms=sum(by.values()),
            same_bits=all(cs.same_bits(x, y) for g, w in zip(got, want)
                          for x, y in zip(g, w)))
    return out


def dispatch_row(rows, kernel, what, batches, call, kb, reps):
    """A path driven over ``batches`` (the first a warm-up) through
    ``call(batch, stages)``: q/s, p50 and the mean stages a batch (host
    clock), launches a dispatch, and the device events and device ms by
    kernel a dispatch over the timed batches served again under
    ``torch.profiler``."""
    cs = smoke()
    call(batches[0], {})
    kb.reset_launches()
    lat, st = [], {}
    for b in batches[1:]:
        s1 = {}
        t0 = time.perf_counter()
        call(b, s1)
        lat.append(time.perf_counter() - t0)
        for key in ("prep_ms", "dispatch_ms", "fetch_ms"):
            st[key] = st.get(key, 0.0) + s1[key]
    n = len(lat)
    launches = {k: v / n for k, v in kb.launches.items() if v}

    def serve_all():
        for b in batches[1:]:
            call(b, {})
    by_name = cs.device_ms_by_name(serve_all, 1)
    events = cs.device_events_a_call(serve_all, 1) / n
    lat = np.asarray(lat)
    emit(rows, kernel=kernel, what=what, batches=n,
         batch=len(batches[1]), qps=len(batches[1]) * n / float(lat.sum()),
         p50_ms=float(np.percentile(lat, 50)) * 1e3,
         **{f"{k}_mean": v / n for k, v in st.items()},
         launches_a_dispatch=launches, device_events_a_dispatch=events,
         device_ms_a_dispatch=sum(by_name.values()) / n,
         by_name_a_dispatch={k: v / n for k, v in by_name.items()})


def run_k5_k10(rows, reps, which, variants=False):
    """K5 and K10 at the smoke's shapes (``k5``, ``k10``) and the pruned
    route and the hybrid path end to end (``pruned``, ``hybrid``), sharing
    the planes: K5 on the calls one dispatch makes at pruned (a) and (b)'s
    checked batch, the bool rescore (mix (d), total) and the hybrid
    rescore (total; a parent makes two calls there, this tree one); K10
    at the hybrid's rrf and sum (windows 100), with the rescore payload
    (this tree; a parent gathers it with five PyTorch ops after the call),
    and at windows of 10,000 (synthetic lists of the reduces' form); the
    phases' q/s, p50, stages, launches, device events and device ms a
    dispatch. ``variants``: K5 also at other sizes (``k5_variants``)."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.parallel import dist_search
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, DistributedSearchPlane, fused_search_device)
    from elasticsearch_tpu_torch.search.query_planner import \
        bool_rescore_device
    dev = torch.device("cuda")

    def record(name, fn):
        calls = []
        with cs.recording(calls, (name,), (dist_search,)):
            fn()
        return [(a, kw) for _n, a, kw, _o in calls]

    if "k5" in which or "pruned" in which:
        rng, corpus, plane, _cs, _ps = cs.prune_plane(dev)
        mixes = {m: cs.sample_queries(rng, corpus, 1 + cs.PRUNE_BATCHES,
                                      cs.PRUNE_BATCH, weighted=m == "a")
                 for m in ("a", "b")}
        if "k5" in which:
            for m, qs in mixes.items():
                calls = record("bisect_exact_scores",
                               lambda: plane.serve(qs[1], k=cs.K))
                recorded_row(rows, "bisect_exact_scores",
                             f"pruned mix ({m}), checked batch", calls,
                             reps, variants=k5_variants(calls, reps)
                             if variants else None)
            bmix, _extra, draw = cs.bool_traffic(corpus)
            bqs = bmix["d"][1]
            items = [{"rescore": dict(cs.RESCORE,
                                      terms=draw(cs.RESCORE_TERMS))}
                     for _ in bqs]
            calls = record("bisect_exact_scores", lambda: bool_rescore_device(
                plane, bqs, items, cs.RESCORE_WT, "total"))
            recorded_row(rows, "bisect_exact_scores",
                         "bool rescore (mix (d), total)", calls, reps)
        if "pruned" in which:
            for m, qs in mixes.items():
                dispatch_row(rows, "pruned_phase", f"pruned mix ({m})", qs,
                             lambda b, st: plane.serve(b, k=cs.K, stages=st),
                             kb, reps)
        del plane, corpus
        torch.cuda.empty_cache()
    if not ({"k5", "k10", "hybrid"} & which):
        return
    rng = np.random.RandomState(1234)
    corpus = cs.hybrid_corpus(rng, cs.HY_DOCS)
    tplane = DistributedSearchPlane([corpus], "body", device=dev)
    vecs = cs.hybrid_vectors(cs.HY_DOCS, cs.HY_DIM)
    kplane = DistributedKnnPlane([dict(vectors=vecs)],
                                 similarity="dot_product", device=dev)
    del vecs
    batches, el, p, _dense = cs.hybrid_traffic(rng, corpus, tplane,
                                               cs.HY_DIM)
    rs_rng = np.random.RandomState(4321)
    rescored = [[dict(f, rescore=dict(cs.RESCORE, terms=[
        f"t{t}" for t in rs_rng.choice(el, cs.RESCORE_TERMS, p=p)]))
        for f in b] for b in batches[:9]]
    if "k10" in which:
        for fusion in ("rrf", "sum"):
            calls = record("fuse_rank", lambda: fused_search_device(
                tplane, kplane, batches[1], fusion=fusion))
            recorded_row(rows, "fuse_rank",
                         f"hybrid {fusion}, windows {cs.HY_WINDOW}", calls,
                         reps)
        calls = record("fuse_rank", lambda: fused_search_device(
            tplane, kplane, rescored[1], fusion="rrf",
            rescore_mode="total"))
        recorded_row(rows, "fuse_rank", "hybrid rescore (rrf, total): the "
                     "fusion (and its payload where the call carries it)",
                     calls, reps,
                     payload_in_call=calls[0][1].get("tsec") is not None)
        for fusion in ("rrf", "sum"):
            args, kw = cs.fusion_lists(dev, cs.HY_BATCH, 10000)
            recorded_row(rows, "fuse_rank",
                         f"{fusion}, windows 10,000 (synthetic lists)",
                         [(args, dict(kw, fusion=fusion))], reps)
    if "k5" in which:
        calls = record("bisect_exact_scores", lambda: fused_search_device(
            tplane, kplane, rescored[1], fusion="rrf", rescore_mode="total"))
        recorded_row(rows, "bisect_exact_scores",
                     "hybrid rescore (rrf, total), both lists", calls, reps,
                     variants=k5_variants(calls, reps) if variants
                     else None)
    if "hybrid" in which:
        dispatch_row(rows, "hybrid_phase", "hybrid rrf", batches,
                     lambda b, st: fused_search_device(
                         tplane, kplane, b, fusion="rrf", stages=st),
                     kb, reps)
        dispatch_row(rows, "hybrid_phase", "hybrid rescore (rrf, total)",
                     rescored,
                     lambda b, st: fused_search_device(
                         tplane, kplane, b, fusion="rrf",
                         rescore_mode="total", stages=st),
                     kb, reps)
    del tplane, kplane, corpus
    torch.cuda.empty_cache()


def timed_row(rows, kernel, what, call, plain, reps, **extra):
    """One row for one wrapper call at a main path's shape: CUDA-event ms,
    host ms a call (enqueued back to back), card ms a call (CUDA events
    around calls queued behind a sleep kernel, ``chip_smoke.queued_ms``),
    device ms by kernel and device events a call (``torch.profiler``),
    whether the outputs are the plain version's bits, and a digest."""
    cs = smoke()
    got, want = call(), plain()
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    by_name = cs.device_ms_by_name(call, reps)
    emit(rows, kernel=kernel, what=what, ms=cs.timed(call, 5 * reps),
         host_ms=host_ms(call, 5 * reps),
         queued_ms=cs.queued_ms(call, 5 * reps),
         device_ms=sum(by_name.values()), by_name=by_name,
         device_events_a_call=cs.device_events_a_call(call, reps),
         equals_plain=all(cs.same_bits(x, y) for x, y in zip(got, want)),
         digest=digest(got), **extra)


def k11_inputs(dev, B, n, *, seed):
    """One K11 call's inputs of the routes' form: B rankings of n entries
    (scores descending, the last eighth at −inf as a fused list's
    duplicates leave them), unique ids, the rescore query's scores on
    about half, the smoke's weights (qw 0.7, rw 1.3) and its window."""
    import torch
    rng = np.random.RandomState(seed)
    vals = -np.sort(-rng.rand(B, n).astype(np.float32), axis=1)
    vals[:, n - n // 8:] = -np.inf
    ids = np.stack([rng.choice(1 << 22, n, replace=False)
                    for _ in range(B)]).astype(np.int32)
    sec = rng.rand(B, n).astype(np.float32)
    matched = rng.rand(B, n) < 0.5
    cs = smoke()
    host = (vals, ids, sec, matched,
            np.full(B, cs.RESCORE["qw"], np.float32),
            np.full(B, cs.RESCORE["rw"], np.float32),
            np.full(B, cs.RESCORE["window"], np.int32))
    return [torch.from_numpy(x).to(dev) for x in host]


def run_k11(rows, reps):
    """K11 at the smoke's shapes (``k11_inputs``, mode total): the bool
    rescore (16 queries, n = ``RESCORE_WT`` = 100, k = 100), the hybrid
    rescore (windows of 100: n = 256, the fused list of two lists padded
    to 128, k = 10) and the hybrid at windows of 300 (n = 1,024: past
    ``K11_COUNT_MAX``, the sorting path, k = 10); each in the five modes
    for equality."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import fused_query as fq
    dev = torch.device("cuda")
    for what, n, k in (("bool rescore", cs.RESCORE_WT, 100),
                       ("hybrid rescore, windows 100 (n = 256)",
                        2 * (1 << (cs.HY_WINDOW - 1).bit_length()), cs.K),
                       ("hybrid rescore, windows 300 (n = 1,024)", 1024,
                        cs.K)):
        a = k11_inputs(dev, cs.BOOL_BATCH, n, seed=n)
        same = all(cs.same_bits(x, y) for mode in fq.RESCORE_MODES
                   for x, y in zip(
                       fq.rescore_reorder(*a, mode=mode, k=k, pad_id=-1),
                       fq.rescore_reorder_body(*a, mode=mode, k=k,
                                               pad_id=-1)))
        kw = dict(mode="total", k=k, pad_id=-1)
        nb, nf = cs.k11_work(a, k)
        timed_row(rows, "rescore_reorder", what,
                  lambda a=a, kw=kw: fq.rescore_reorder(*a, **kw),
                  lambda a=a, kw=kw: fq.rescore_reorder_body(*a, **kw),
                  reps, B=cs.BOOL_BATCH, n=n, k=k,
                  window=cs.RESCORE["window"], five_modes_equal_plain=same,
                  counting_path=n <= getattr(fq, "K11_COUNT_MAX", 0),
                  bound_ms=cs.bound(nb, nf)[0])


def k20_call(ml, model):
    """The call a model's inference makes: the pack's wrapper where the
    tree has one, else ``_eval_trees`` over the node arrays."""
    if hasattr(ml, "eval_tree_pack"):
        return lambda X: ml.eval_tree_pack(X, model._pack, model._depth)
    return lambda X: ml._eval_trees(X, *model._dev_arrays, model._depth)


#: builds of csrc/tree_eval.cu with the batch block's warps along docs
#: (K20_DOC_WARPS) or the walks a thread (K20_WALKS) changed, timed at (j)
K20_VARIANTS = {
    f"doc_warps{w}": [("#define K20_DOC_WARPS 1 ",
                       f"#define K20_DOC_WARPS {w} ")] for w in (2, 4, 8)}
K20_VARIANTS.update({
    f"walks{w}": [("#define K20_WALKS 4 ", f"#define K20_WALKS {w} ")]
    for w in (2, 8)})
#: a build with every n sent to the batch shape (no few-docs shape),
#: timed at (k) and driven there
K20_FEW_VARIANTS = {"batch_only": [("#define K20_FEW_DOCS 8 ",
                                    "#define K20_FEW_DOCS 0 ")]}


_K20_LIBS = {}


def k20_libs(names):
    """The variant builds ``names`` of ``K20_VARIANTS`` and
    ``K20_FEW_VARIANTS``, typed, each built once a process; None for one
    whose edit target is not in the source."""
    from elasticsearch_tpu_torch.kernels import build as kb
    edits = {**K20_VARIANTS, **K20_FEW_VARIANTS}
    for name in names:
        if name not in _K20_LIBS:
            lib = build_variant(str(kb.PKG_DIR.parent), name, edits[name],
                                scratch_dir(), source="tree_eval")
            if lib is not None:
                typed_variant("tree_eval", lib)
            _K20_LIBS[name] = lib
    return {name: _K20_LIBS[name] for name in names}


def k20_variants(call, reps, libs):
    """Each build of ``libs`` on one recorded K20 call: its card ms (queued
    events and ``torch.profiler``) beside the tree's build's, and whether
    its leaf ids are the tree's."""
    import torch
    cs = smoke()
    want = call()
    out = {"tree": dict(queued_ms=cs.queued_ms(call, 5 * reps),
                        device_ms=sum(cs.device_ms_by_name(
                            call, reps).values()))}
    for name, lib in libs.items():
        if lib is None:
            out[name] = "not measured (edit target missing)"
            continue
        with swapped_library("tree_eval", lib):
            got = call()
            torch.cuda.synchronize()
            out[name] = dict(
                queued_ms=cs.queued_ms(call, 5 * reps),
                device_ms=sum(cs.device_ms_by_name(call, reps).values()),
                same=bool(torch.equal(got, want)))
    return out


def run_k20(rows, reps, variants=False):
    """K20 at the ML path's shapes: the smoke's 500-tree model (511 nodes,
    depth 9, 32 features) at (j)'s call (1,024 docs) and (k)'s (one doc),
    each with the bound; then both paths driven: (j) ``_infer`` of 1,024
    docs a call (``ML_INFER_CALLS`` calls) and (k) the ``inference``
    ingest processor a doc at a time (``ML_INGEST_DOCS``): docs/s and
    p50, launches a call."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ingest.pipeline import (IngestDocument,
                                                         Pipeline)
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.xpack import ml
    dev = torch.device("cuda")
    rng = np.random.RandomState(1234)
    svc = ml.MlService(lambda index, body: {"hits": {"hits": []}},
                       lambda index, lines: None, device=dev)
    svc.put_trained_model("m", cs.ml_model(rng))
    model = svc.models["m"]
    T, N = model._arrays[0].shape
    f = k20_call(ml, model)
    docs = [cs.ml_docs(rng, cs.ML_INFER_DOCS)
            for _ in range(cs.ML_INFER_CALLS + 1)]
    for what, n in (("(j) _infer, a call", cs.ML_INFER_DOCS),
                    ("(k) ingest, one doc", 1)):
        X = torch.from_numpy(model._vectorize(docs[0][:n])).to(dev)
        arrs = model._dev_arrays
        n_split = int((arrs[0] >= 0).sum())
        walk = cs.numpy_walk(X.cpu().numpy(),
                             *[a.cpu().numpy() for a in arrs], model._depth)
        if n == 1:          # the nodes one doc's walks read
            nodes = model._depth * T
            nbytes = 4 * X.shape[1] + 16 * nodes + 4 * T
        else:
            nbytes = 4 * n * X.shape[1] + 16 * n_split \
                + 4 * (T * N - n_split) + 4 * T * n
        timed_row(rows, "tree_eval", what, lambda X=X: f(X),
                  lambda X=X: ml._eval_trees_plain(X, *arrs, model._depth),
                  reps, T=T, N=N, n=n, depth=model._depth,
                  equals_numpy_walk=bool(np.array_equal(
                      f(X).cpu().numpy(), walk)),
                  bound_ms=cs.bound(nbytes, T * n * model._depth)[0],
                  variants=k20_variants(lambda X=X: f(X), reps, k20_libs(
                      K20_VARIANTS if n > 1 else K20_FEW_VARIANTS))
                  if variants else None)
    svc.infer("m", {"docs": docs[0]})
    torch.cuda.synchronize()
    kb.reset_launches()
    lat = np.zeros(cs.ML_INFER_CALLS)
    for i in range(cs.ML_INFER_CALLS):
        t1 = time.perf_counter()
        svc.infer("m", {"docs": docs[i + 1]})
        lat[i] = time.perf_counter() - t1
    emit(rows, kernel="ml_phase", what="(j) _infer",
         **cs.latency_stats(lat, cs.ML_INFER_DOCS),
         launches_a_call=kb.launches["tree_eval"] / cs.ML_INFER_CALLS)
    ml.registry_bind(svc)
    pipe = Pipeline("p", {"processors": [{"inference": {
        "model_id": "m", "target_field": "ml.inference"}}]})
    ing = cs.ml_docs(rng, cs.ML_INGEST_DOCS + 1)

    def drive_k(what):
        pipe.execute(IngestDocument("i", "w", dict(ing[0])))
        torch.cuda.synchronize()
        kb.reset_launches()
        lat = np.zeros(cs.ML_INGEST_DOCS)
        for i in range(cs.ML_INGEST_DOCS):
            t1 = time.perf_counter()
            pipe.execute(IngestDocument("i", str(i), dict(ing[i + 1])))
            lat[i] = time.perf_counter() - t1
        emit(rows, kernel="ml_phase", what=what, **cs.latency_stats(lat, 1),
             launches_a_doc=kb.launches["tree_eval"] / cs.ML_INGEST_DOCS)

    # three drives in a row: the spread within one process
    for r in range(3):
        drive_k(f"(k) ingest, a doc at a time, drive {r + 1}")
    if variants:
        # (k) with each few-docs variant in turns with this build, in one
        # process, in the order this, variant, variant, this, twice
        libs = {k: v for k, v in k20_libs(K20_FEW_VARIANTS).items() if v}
        for name, lib in libs.items():
            for r, order in enumerate(("ab", "ba", "ab", "ba")):
                for who in order:
                    if who == "a":
                        drive_k(f"(k) ingest, this build, turn {r + 1}")
                        continue
                    with swapped_library("tree_eval", lib):
                        drive_k(f"(k) ingest, {name}, turn {r + 1}")


#: builds of csrc/agg_rank_pick.cu whose pick searches read another
#: count of pivots a lane a round: 1 (a 32-ary search), 8 (256-ary) and
#: 32 (1,024-ary), in place of 4 (128-ary); and whose register pass has
#: no window, only each thread's search inside its run ("confined")
K13_VARIANTS = {f"lane_pivots{n}": [("#define K13_LANE_PIVOTS 4\n",
                                     f"#define K13_LANE_PIVOTS {n}\n")]
                for n in (1, 8, 32)}
K13_VARIANTS["confined"] = [
    ("  k13_window(c, a, b, lane, en, bal);\n", "  en = c[b];\n"),
    ("  if (k == 0 && j > a + 1)\n    j = k13_thread_search(c, a + 1, j, en);\n",
     "  j = k13_thread_search(c, a + 1, b, en);\n")]


def cold_queued_ms(fn, reps, flush):
    """Mean card ms of ``fn`` a call with L2 emptied before each call:
    ``flush`` (a write of a buffer larger than L2) runs before every call
    and CUDA events time each call alone, all queued behind a sleep kernel
    (``chip_smoke.queued_ms``); None when the host took longer to enqueue
    them than the card slept."""
    import torch
    flush()
    fn()
    torch.cuda.synchronize()
    e0, s0 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(reps)]
    e0.record()
    torch.cuda._sleep(50_000_000)
    s0.record()
    t0 = time.perf_counter()
    for a, b in ev:
        flush()
        a.record()
        fn()
        b.record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host >= e0.elapsed_time(s0):
        return None
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def k13_register_inputs(dev, vals_s, docs_s):
    """The HLL caches (p = 14: 32,767 runs, the offsets padded) of the
    stand-in segment of config #3's columns, as ``chip_smoke.run_aggs``
    builds them."""
    import types
    from elasticsearch_tpu_torch.ops import aggs
    from elasticsearch_tpu_torch.utils.shapes import round_up_pow2
    n = docs_s.shape[0]
    vals_doc = np.empty(n, np.float32)
    vals_doc[docs_s] = vals_s
    seg = types.SimpleNamespace(
        n_docs=n, n_pad=round_up_pow2(n), keyword_fields={},
        numeric_fields={"fare": types.SimpleNamespace(
            docs_host=np.arange(n, dtype=np.int32),
            vals_host=vals_doc.astype(np.float64))})
    return aggs.hll_sketch_pairs(seg, "fare", device=dev)


def run_k13(rows, reps, tree, variants):
    """K13 at its two real inputs, each under the route's 25 % mask and a
    0.1 % one (where its fallbacks run): (p) the route's pick (config #3's
    columns, the Hazen ranks of the top 10 ordinals at [50, 95, 99]) and
    (r) the register pass over the HLL caches' K12 prefix. ``timed_row``'s
    figures, the card ms with L2 emptied before each call
    (``cold_queued_ms``), the bound (``chip_smoke.py``'s count), the
    library call
    (``torch.searchsorted`` + gather: the pick's, or the pass's with its
    where), and how many entries or runs left the first look; with
    ``variants`` each build of ``K13_VARIANTS`` by queued events in turn
    with the tree's (tree, variant, tree, variant) and whether its outputs
    are the tree's bits."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import aggs
    dev = torch.device("cuda")
    off_d, docs_d, vals_d, mask_d, off, docs_s, vals_s = \
        k12_route_inputs(dev)
    n, n_pad = cs.AGG_DOCS, mask_d.shape[0]
    sparse = np.zeros(n_pad, bool)
    sparse[:n] = np.random.default_rng(4321).random(n, dtype=np.float32) \
        < cs.AGG_SPARSE
    masks = (("25 % mask", mask_d),
             ("0.1 % mask", torch.from_numpy(sparse).to(dev)))
    del sparse
    libs = {name: build_variant(tree, name, edits, scratch_dir(),
                                source="agg_rank_pick")
            for name, edits in K13_VARIANTS.items()} if variants else {}

    l2_flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def flush():
        l2_flush.fill_(7)

    def row(what, call, plain, lib, nbytes, **extra):
        out = call()
        found = {}
        for name, vlib in libs.items():
            if vlib is None:
                found[name] = "not measured (edit target missing)"
                continue
            warm, cold = [], []
            for _turn in range(2):
                warm.append(cs.queued_ms(call, 5 * reps))
                cold.append(cold_queued_ms(call, 2 * reps, flush))
                with swapped_library("agg_rank_pick", vlib):
                    warm.append(cs.queued_ms(call, 5 * reps))
                    cold.append(cold_queued_ms(call, 2 * reps, flush))
                    same = cs.same_bits(call(), out)
            found[name] = dict(queued_ms=warm[1::2],
                               tree_queued_ms=warm[0::2],
                               cold_queued_ms=cold[1::2],
                               tree_cold_queued_ms=cold[0::2],
                               equals_tree=same)
        if found:
            extra["variants"] = found
        timed_row(rows, "agg_rank_pick", what, call, plain, reps,
                  cold_queued_ms=cold_queued_ms(call, 2 * reps, flush),
                  bound_ms=cs.bound(nbytes, 0)[0], bound_bytes=nbytes,
                  library_ms=cs.timed(lib, 5 * reps), **extra)

    for label, mask in masks:
        counts, c = aggs.masked_rank_prefix(off_d, docs_d, mask)
        top_counts, top = aggs.top_ordinals(counts, cs.AGG_TOP)
        lo, hi, frac = aggs.hazen_ranks(top_counts, cs.AGG_QS)
        args = (c, off_d, vals_d) + tuple(
            torch.from_numpy(x).to(dev) for x in (top, lo, hi, frac))
        B, R = lo.shape
        base = c[off_d[args[3].long()].long()][:, None]

        def lib_pick(args=args, base=base):
            tgt = torch.cat([base + args[4] + 1, base + args[5] + 1], 1)
            idx = torch.searchsorted(args[0], tgt.contiguous()) - 1
            return args[2][idx.clamp(0, args[2].shape[0] - 1)]
        row(f"(p) the route's pick, {label}: top {B} ordinals at "
            f"{list(cs.AGG_QS)}, {n} pairs",
            lambda args=args: aggs.rank_pick(*args),
            lambda args=args: aggs.rank_pick_plain(*args), lib_pick,
            cs.k13_pick_bytes(*args), B=B, R=R,
            counts=top_counts.tolist(),
            hi_past_window=cs.k13_hi_searched(c, off_d, *args[3:6]))
        del counts, c, args, base
    hll = k13_register_inputs(dev, vals_s, docs_s)
    del off_d, docs_d, vals_d
    h_off, h_rhos = hll["off_dev"], hll["rhos_dev"]
    V = h_off.shape[0] - 1
    a, b = h_off[:-1].long(), h_off[1:].long()
    for label, mask in masks:
        hc = aggs.masked_rank_prefix(h_off, hll["docs_dev"], mask)[1]
        st, en = hc[a], hc[b]

        def lib_regs(hc=hc, st=st, en=en):
            idx = torch.searchsorted(hc, en) - 1
            return torch.where(en > st,
                               h_rhos[idx.clamp(0, h_rhos.shape[0] - 1)], 0)
        row(f"(r) the register pass, {label}: {V} runs over the HLL "
            f"prefix ({hll['n_pairs']} pairs)",
            lambda hc=hc: aggs.register_max(hc, h_off, h_rhos),
            lambda hc=hc: aggs.register_max_plain(hc, h_off, h_rhos),
            lib_regs,
            cs.k13_register_bytes(hc, h_off, h_rhos), runs=V,
            real_runs=hll["m"], nonempty_runs=int((en > st).sum()),
            window_missed=cs.k13_window_missed(hc, h_off))
        del hc, st, en
    del hll, masks, mask_d, l2_flush
    torch.cuda.empty_cache()


def run_k18(rows, reps):
    """K18 on the 2^23-doc segment at mix (g)'s price range (i32 ranks)
    and (h)'s keyword range (f32 ordinals), recorded from the searches:
    CUDA-event mean, host time, device time, device events a call, the
    bound (8 bytes a pair, a byte a doc) and its share, the library
    yardstick (``scatter_reduce_`` amax after the compare) and whether the
    mask is the plain version's."""
    cs = smoke()
    import torch
    from elasticsearch_tpu_torch.ops import masks as masks_mod
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    dev = torch.device("cuda")
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    tag, price = cs.segment_columns(cs.N_DOCS)
    seg, mapper = cs.segment_index(corpus, tag, price, dev)
    del corpus
    searcher = ShardSearcher([seg], mapper)
    p25, p75 = (float(x) for x in np.percentile(price, [25, 75]))
    rec = []
    with cs.recording(rec, ("range_mask",), (masks_mod,)):
        searcher.search({"query": {"bool": {"filter": [{"range": {
            "price": {"gte": p25, "lt": p75}}}]}}, "size": 10})
        searcher.search({"query": {"range": {"tag": {
            "gte": "tag010", "lt": "tag040"}}}, "size": 10})
    for (_n, a, kw, _o), what in zip(rec, ("(g) price range, i32 ranks",
                                          "(h) tag range, f32 ordinals")):
        M = a[0].shape[0]
        n_pad = kw["segment_pad"]
        hit = (a[0] >= a[2]) & (a[0] <= a[3])
        m = torch.zeros(n_pad + 1, dtype=torch.uint8, device=dev)
        d = a[1].long()
        lib_ms = cs.timed(lambda: m.scatter_reduce_(
            0, d, hit.to(torch.uint8), "amax"), 5 * reps)
        bms = cs.bound(8 * M + n_pad, 2 * M)[0]
        timed_row(rows, "range_mask", what,
                  lambda a=a, kw=kw: masks_mod.range_mask(*a, **kw),
                  lambda a=a, kw=kw: masks_mod.range_mask_plain(*a, **kw),
                  reps, pairs=M, n_pad=n_pad, bound_ms=bms,
                  library_ms=lib_ms)
    del seg, searcher
    torch.cuda.empty_cache()


def run_aggs_phase(rows):
    """Config #3's aggregation phase of ``chip_smoke.py`` (``run_aggs``)
    against ``--tree``'s package: the route's aggs/s, p50 and p99 (its
    printed lines) and the K12–K15 rows through the caches."""
    cs = smoke()
    from elasticsearch_tpu_torch.device import card_info
    agg_rows, counts = cs.run_aggs(card_info())
    emit(rows, kernel="aggs_phase", kernel_rows=agg_rows, launches=counts)


def run_segment_phase(rows):
    """The per-segment phase of ``chip_smoke.py`` (``run_segment``: mixes
    (e)–(i) through ``ShardSearcher.search`` on the 2^23-doc segment)
    against ``--tree``'s package: each mix's q/s, p50 and p99 (its printed
    lines) and the K16–K19 rows."""
    cs = smoke()
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(cs.VOCAB)}
    seg_rows, counts, _index = cs.run_segment(card_info(), corpus)
    emit(rows, kernel="segment_phase", kernel_rows=seg_rows,
         launches=counts)


def run_serving_phase(rows):
    """The serving phase of ``chip_smoke.py`` (``run_serving``: config #1's
    text serving route from 32 client threads, mixes (s1)–(s3) and the
    delta, on the 2^23-doc segment) against ``--tree``'s package: each
    mix's requests/s, p50, p99, batches, stages and busy share (its printed
    lines and the row) and the route's launches."""
    import torch
    cs = smoke()
    from elasticsearch_tpu_torch.common import breakers
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    if not hasattr(breakers.BreakerService, "fit_device"):
        # a tree whose cache leaves the breakers at the host's 1 GiB: give
        # them the card's memory, as its own smoke did
        total = torch.cuda.mem_get_info()[1]
        for key in ("indices.breaker.total.limit",
                    "indices.breaker.accounting.limit"):
            breakers.DEFAULT.apply_setting(key, f"{total}b")
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, cs.N_DOCS, cs.VOCAB, cs.AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(cs.VOCAB)}
    tag, price = cs.segment_columns(cs.N_DOCS)
    seg, mapper = cs.segment_index(corpus, tag, price, torch.device("cuda"))
    path, stats = cs.run_serving(card_info(), corpus, seg, mapper)
    emit(rows, kernel="serving_phase",
         launches={k: v for k, v in path.items() if v},
         stats=json.loads(json.dumps(stats, default=float)))


def run_ivf_phase(rows):
    """The IVF phase of ``chip_smoke.py`` (``run_knn_ivf``: the route
    through ``serve`` at the IVF shape) against ``--tree``'s package: its
    q/s, p50, ``dispatch_ms`` and recall (its printed lines) and the K7
    and K8 rows. A package whose K7 has no one-call window reduces its
    chunk lists with a third K3 call a step."""
    cs = smoke()
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.ops import knn as knn_mod
    if not hasattr(knn_mod, "K7_WINDOW_MAX"):
        cs.IVF_K3_CALLS = 3
    if hasattr(knn_mod, "ivf_scan_partials"):
        cs.IVF_DEEP_WINDOW_K3 = 1    # chunk lists past the window path
    ivf_rows, counts, k3_err = cs.run_knn_ivf(card_info())
    emit(rows, kernel="ivf_phase", kernel_rows=ivf_rows, launches=counts,
         k3_max_abs_err=k3_err)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=HERE)
    p.add_argument("--kernels",
                   default="k16,k6,k9,k8,k1,k4,k3,k21,k2,k12,k14,k22,k19,"
                   "k7,k17,k5,k10,k11,k20,k18,k13",
                   help="comma-separated: which of k16, k6, k9, k8, k1, k4, "
                   "k3, k21, k2, k12, k14, k22, k19, k7, k17, k5, k10, k11, "
                   "k20, k18, k13 to "
                   "probe, and aggs, segment, ivf and serving "
                   "(chip_smoke.py's aggregation, per-segment, IVF and "
                   "serving phases) and pruned "
                   "and hybrid (the pruned route and the hybrid path "
                   "driven, their device events a dispatch)")
    p.add_argument("--variants", action="store_true")
    p.add_argument("--k7-ks", default=None,
                   help="comma-separated ks whose IVF windows k7 times "
                   "(default: 10, 1000, 10000)")
    p.add_argument("--out", default=None)
    p.add_argument("--reps", type=int, default=20)
    opts = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, HERE)
    sys.path.insert(0, tree)
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.kernels import build as kb
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    t0 = time.perf_counter()
    emit(rows, tree=tree, card=card_info(),
         build_s=kb.build_all())
    which = set(opts.kernels.split(","))
    if "k16" in which:
        run_k16(rows, opts.reps)
    if "k6" in which:
        run_k6(rows, opts.reps, opts.variants, tree)
    if "k9" in which:
        run_k9(rows, opts.reps, tree, opts.variants)
    if "k8" in which:
        run_k8(rows, opts.reps)
    if "k1" in which:
        run_k1(rows, opts.reps, tree, opts.variants)
    if "k4" in which:
        run_k4(rows, opts.reps, tree, opts.variants)
    if "k3" in which:
        run_k3(rows, opts.reps)
    if "k21" in which:
        run_k21(rows, max(opts.reps // 4, 2), tree)
    if "k2" in which:
        run_k2(rows, opts.reps, tree, opts.variants)
    if "k12" in which:
        run_k12(rows, max(opts.reps // 2, 2), tree, opts.variants)
    if "k14" in which:
        run_k14(rows, max(opts.reps // 2, 2), tree, opts.variants)
    if "k22" in which:
        run_k22(rows, max(opts.reps // 4, 2), tree, opts.variants)
    if "k19" in which:
        run_k19(rows, opts.reps, tree, opts.variants)
    if "k7" in which:
        run_k7(rows, opts.reps, tree, opts.variants,
               opts.k7_ks and [int(k) for k in opts.k7_ks.split(",")])
    if "k17" in which:
        run_k17(rows, opts.reps)
    if "k11" in which:
        run_k11(rows, opts.reps)
    if "k20" in which:
        run_k20(rows, opts.reps, opts.variants)
    if "k18" in which:
        run_k18(rows, opts.reps)
    if "k13" in which:
        run_k13(rows, opts.reps, tree, opts.variants)
    if which & {"k5", "k10", "pruned", "hybrid"}:
        run_k5_k10(rows, opts.reps, which, opts.variants)
    if "aggs" in which:
        run_aggs_phase(rows)
    if "segment" in which:
        run_segment_phase(rows)
    if "ivf" in which:
        run_ivf_phase(rows)
    if "serving" in which:
        run_serving_phase(rows)
    emit(rows, total_s=time.perf_counter() - t0)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
