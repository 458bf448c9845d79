#!/usr/bin/env python3
"""Probe of K16 (``bm25_scatter``) and K6 (``knn_scan``) on one card, at the
inputs ``chip_smoke.py`` gives them on its main paths.

    python3 kernel_probe.py [--tree DIR] [--variants] [--out FILE]

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


def build_variant(tree, name, edits, scratch):
    """The tree's ``csrc/knn_scan.cu`` with ``edits`` (target, new; an empty
    target appends), built as a library; None when a target is missing."""
    from elasticsearch_tpu_torch.kernels import build as kb
    csrc = os.path.join(tree, "elasticsearch_tpu_torch", "csrc")
    with open(os.path.join(csrc, "knn_scan.cu")) as f:
        src = f.read()
    if not all(old in src for old, _ in edits if old):
        return None
    for old, new in edits:
        src = src.replace(old, new) if old else src + new
    path = os.path.join(scratch, f"knn_scan_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(scratch, f"knn_scan_{name}.so")
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
    scratch = os.path.join(HERE, "elasticsearch_tpu_torch", "_build",
                           "probe")
    os.makedirs(scratch, exist_ok=True)
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=HERE)
    p.add_argument("--variants", action="store_true")
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
    run_k16(rows, opts.reps)
    run_k6(rows, opts.reps, opts.variants, tree)
    emit(rows, total_s=time.perf_counter() - t0)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
