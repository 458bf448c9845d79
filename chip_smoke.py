#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives the port's serving plane (``elasticsearch_tpu_torch``, no JAX) at
the headline size of the repository's benchmark: a 2^23-document synthetic
Zipf corpus (vocabulary 2^16, mean length 32, s = 1.2, seed 1234), packed
into a tiered BM25 plane on the card and served in batches of 64 four-term
queries at k = 10. Phases, each fatal on failure:

1. the card's name and power limit; build the three CUDA kernels;
2. each kernel against its plain PyTorch version on the card, on the
   inputs of a main-path batch at each path's launch shapes: ``search``
   at the benchmark's (Q = 4, the workload's L) and ``serve`` at its own
   (Q floored to 8, a ladder rung L) (K1 bitwise, K2 rtol 1e-5, K3 exact);
3. the main path's two paths, each with its launch counts zeroed before
   and read after, every kernel launched in each: ``plane.search`` (the
   benchmark's tiered shape) and ``plane.serve`` batches timed; three
   queries of each path checked against a numpy term-at-a-time exact
   reference (scores within 1 %, docs equal where the reference's
   neighbours differ by more than 1 %, totals exact);
4. per-kernel times (CUDA events) beside their bounds, plain versions and
   library calls;
5. the ``kernels`` JSON line, the card line, and the final status line.

Exits non-zero with no result line when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

VOCAB = 1 << 16
AVG_DL = 32
N_DOCS = 1 << 23
BATCH = 64
N_TERMS = 4
K = 10
TIMED_BATCHES = 64
SERVE_BATCHES = 16
REF_QUERIES = 3
K1, B_BM25 = 1.2, 0.75
#: card peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, f32 non-tensor
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

#: tolerances: K2 sums f32 products in another order than torch.matmul;
#: the reference holds f32 impacts where the dense tier holds bf16
K2_RTOL, K2_ATOL = 1e-5, 1e-6
REF_RTOL = 1e-2


def sample_queries(rng, corpus, n_batches, batch=BATCH):
    """Term-frequency-weighted query sampling (as the benchmark draws):
    term t with probability ∝ its posting mass, no df cap."""
    df = corpus["df"].astype(np.float64)
    eligible = np.flatnonzero(df >= 2)
    p = df[eligible] / df[eligible].sum()
    return [[[f"t{t}" for t in row]
             for row in rng.choice(eligible, size=(batch, N_TERMS), p=p)]
            for _ in range(n_batches)]


def exact_bm25(corpus, terms, k):
    """Numpy term-at-a-time BM25 over the whole corpus (f32 impacts):
    (top k+1 docs, their scores, number of matching docs)."""
    offsets, docs, tf = corpus["offsets"], corpus["docs"], corpus["tf"]
    dl = corpus["doc_len"]
    n_docs = dl.shape[0]
    avgdl = dl.mean()
    df = corpus["df"]
    scores = np.zeros(n_docs, np.float32)
    hit = np.zeros(n_docs, bool)
    for t in set(terms):
        tid = int(t[1:])
        st, en = offsets[tid], offsets[tid + 1]
        if en == st:
            continue
        run_docs = docs[st:en]
        run_tf = tf[st:en]
        idf = np.log(1 + (n_docs - df[tid] + 0.5) / (df[tid] + 0.5))
        w = terms.count(t)
        norm = run_tf + K1 * (1 - B_BM25 + B_BM25 * dl[run_docs] / avgdl)
        scores[run_docs] += w * idf * (K1 + 1) * run_tf / norm
        hit[run_docs] = True
    top = np.argpartition(-scores, k + 1)[:k + 1]
    top = top[np.lexsort((top, -scores[top]))]
    return top, scores[top], int(hit.sum())


def workload_L(plane, batches):
    """One launch shape for the run, sized to the workload's longest
    sparse run (as the benchmark sizes it)."""
    from elasticsearch_tpu_torch.utils.shapes import round_up_pow2
    max_len = 1
    for qs in batches:
        max_len = max(max_len, plane.max_run_len(qs))
    return min(round_up_pow2(max_len), plane.L_cap)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up (CUDA
    events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, flops):
    t_b = nbytes / HBM_BPS * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def same_bits(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def check_topk(v1, d1, v2, d2, v_next, rtol, atol, what):
    """Values within tolerance slot by slot; docs equal wherever the
    reference's neighbouring values differ by more than the tolerance."""
    v1, v2 = np.asarray(v1, np.float64), np.asarray(v2, np.float64)
    if not np.array_equal(np.isfinite(v1), np.isfinite(v2)):
        fail(f"{what}: finite slots differ")
    f = np.isfinite(v2)
    if not np.allclose(v1[f], v2[f], rtol=rtol, atol=atol):
        fail(f"{what}: scores differ beyond rtol={rtol}")
    R = v2.shape[0]
    ext = np.concatenate([np.full((R, 1), np.inf), v2,
                          np.asarray(v_next, np.float64)[:, None]], 1)
    tol = atol + rtol * np.abs(v2)
    with np.errstate(invalid="ignore"):
        sep = (np.abs(ext[:, :-2] - v2) > tol) & \
            (np.abs(v2 - ext[:, 2:]) > tol) & f
    if (sep & (np.asarray(d1) != np.asarray(d2))).any():
        fail(f"{what}: docs differ at separated ranks")
    return float(np.max(np.abs(v1[f] - v2[f]), initial=0.0))


def check_kernels(plane, queries, shape, label):
    """Phase 2 at one path's launch shape: K1, K2 and K3 on the inputs
    ``plane.prepare`` builds for ``queries`` at ``shape``, each held
    against its plain version. Returns the inputs (for the timings) and
    K2's largest error."""
    import torch
    from elasticsearch_tpu_torch.ops.sorted_merge import (
        sparse_candidates_topk, sparse_candidates_topk_plain)
    from elasticsearch_tpu_torch.ops.tiered_bm25 import (
        dense_stream_partials, dense_stream_topk_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain

    prep = plane.prepare(queries, K, **shape)
    if prep["step"] != "tiered":
        fail(f"{label}: the batch does not take the tiered step")
    a = prep["args"]
    k1_kw = dict(n_pad=plane.n_pad, L=prep["L"], k=K, dense=a["dense"],
                 dense_rid=a["dense_rid"], dense_w=a["dense_w"],
                 u_ids=a["u_ids"])
    k1_in = (a["postings_docs"], a["postings_impact"], a["starts"],
             a["lengths"], a["idfw"])
    k1_out = sparse_candidates_topk(*k1_in, **k1_kw)
    k1_ref = sparse_candidates_topk_plain(*k1_in, **k1_kw)
    if not all(same_bits(x, y) for x, y in zip(k1_out, k1_ref)):
        fail(f"{label}: K1 sparse_candidates_topk differs from its plain "
             f"version")

    W, dense, u_ids = a["W"], a["dense"], a["u_ids"]
    part_v, part_d, nm = dense_stream_partials(W, dense, k=K, u_ids=u_ids)
    Bq, S, n_tiles, _ = part_v.shape
    pv = part_v.view(Bq * S, n_tiles * K)
    pd = part_d.view(Bq * S, n_tiles * K)
    k2_v, k2_d = topk_merge(pv, pd, k=K, fill_id=plane.n_pad)
    ref_v, ref_d, ref_nm = dense_stream_topk_plain(W, dense, k=K + 1,
                                                   u_ids=u_ids)
    if not torch.equal(nm.cpu(), ref_nm.cpu()):
        fail(f"{label}: K2 matched counts differ from the plain version")
    rv = ref_v.reshape(Bq * S, K + 1).cpu().numpy()
    rd = ref_d.reshape(Bq * S, K + 1).cpu().numpy()
    k2_err = check_topk(k2_v.cpu().numpy(), k2_d.cpu().numpy(), rv[:, :K],
                        rd[:, :K], rv[:, K], K2_RTOL, K2_ATOL,
                        f"{label}: K2 dense_stream_topk")

    # K3's three calls of the step, on their inputs
    cv, cd = k1_out[0].reshape(Bq * S, K), k1_out[1].reshape(Bq * S, K)
    mv, md = topk_merge(cv, cd, k2_v, k2_d, k=K, fill_id=plane.n_pad,
                        dedup=True)
    k3_calls = [
        (dict(a_vals=pv, a_ids=pd), dict(k=K, fill_id=plane.n_pad)),
        (dict(a_vals=cv, a_ids=cd, b_vals=k2_v, b_ids=k2_d),
         dict(k=K, fill_id=plane.n_pad, dedup=True)),
        (dict(a_vals=mv.view(Bq, S * K), a_ids=md.view(Bq, S * K)),
         dict(k=K, fill_id=S * plane.n_pad, seg_len=K,
              seg_stride=plane.n_pad)),
    ]
    for args, kw in k3_calls:
        got = topk_merge(*args.values(), **kw)
        want = topk_merge_plain(*args.values(), **kw)
        if not all(same_bits(x, y) for x, y in zip(got, want)):
            fail(f"{label}: K3 topk_merge differs from its plain version "
                 f"({kw})")
    print(f"# {label} (Q={prep['Q']}, L={prep['L']}, U={prep['U']}): "
          f"K1 == plain (bitwise), K2 ~= plain (max abs err {k2_err:.3g}),"
          f" K3 == plain (exact, 3 call shapes)", flush=True)
    return dict(prep=prep, k1_in=k1_in, k1_kw=k1_kw, k3_calls=k3_calls,
                n_tiles=n_tiles, k2_err=k2_err)


def check_against_exact(corpus, plane, queries, vals, hits, totals, label):
    """The first ``REF_QUERIES`` queries' hits against the numpy exact
    reference: scores within REF_RTOL, docs equal where the reference's
    neighbours are separated, totals exact."""
    for qi in range(REF_QUERIES):
        top, sc, n_match = exact_bm25(corpus, queries[qi], K)
        got_docs = [s * plane.n_pad + d for s, d in hits[qi]]
        if len(got_docs) != K:
            fail(f"{label} query {qi}: {len(got_docs)} hits, expected {K}")
        check_topk(vals[qi:qi + 1], np.asarray([got_docs]), sc[None, :K],
                   top[None, :K], sc[K:K + 1], REF_RTOL, 0.0,
                   f"{label} query {qi} against the exact reference")
        if totals[qi] != n_match:
            fail(f"{label} query {qi}: total {totals[qi]} != exact "
                 f"{n_match}")
    print(f"# {label}: {REF_QUERIES} queries agree with the exact reference"
          f" (scores within {REF_RTOL:.0%}, totals exact)", flush=True)


def drive(plane, batches, call, kb):
    """One path of the main path: launch counts zeroed, a warm-up batch
    and the timed batches through ``call``, counts read. Returns the
    per-batch seconds, the mean stages, the counts, the dispatches and
    the first timed batch's (vals, hits)."""
    kb.reset_launches()
    n0 = plane.n_dispatches
    call(batches[0], {})
    lat, first = [], None
    stages_sum = {"prep_ms": 0.0, "dispatch_ms": 0.0, "fetch_ms": 0.0}
    for qs in batches[1:]:
        st = {}
        t0 = time.perf_counter()
        vals, hits = call(qs, st)
        lat.append(time.perf_counter() - t0)
        for key in stages_sum:
            stages_sum[key] += st[key]
        if first is None:
            first = (vals, hits)
    counts = dict(kb.launches)
    if not all(counts[n] > 0 for n in kb.KERNELS):
        fail(f"a kernel of the main path never launched: {counts}")
    stages = {key: v / len(lat) for key, v in stages_sum.items()}
    return (np.asarray(lat), stages, counts, plane.n_dispatches - n0,
            first)


def run(*, n_docs=N_DOCS, timed_batches=TIMED_BATCHES,
        serve_batches=SERVE_BATCHES, reps=20):
    import torch
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.sorted_merge import (
        sparse_candidates_topk, sparse_candidates_topk_plain)
    from elasticsearch_tpu_torch.ops.tiered_bm25 import (
        dense_stream_partials, dense_stream_topk_plain, k2_tiling)
    from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_info()

    # ---- phase 1: card + kernel build -----------------------------------
    print(f"# card: {card}", flush=True)
    build_s = kb.build_all()
    print(f"# kernels built in {build_s:.3f} s", flush=True)
    for name, log in kb.ptxas_report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {name}: {line.strip()}")

    # ---- set-up: corpus, plane, batches (as the benchmark draws them) ----
    t0 = time.perf_counter()
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, n_docs, VOCAB, AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    sample_queries(rng, corpus, 1, batch=12)       # the benchmark's CPU ref
    print(f"# corpus: {n_docs} docs, {corpus['docs'].shape[0]} postings "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    plane = DistributedSearchPlane([corpus], "body", device=dev)
    torch.cuda.synchronize()
    print(f"# plane: n_pad {plane.n_pad}, dense T={plane.n_dense} "
          f"(pad {plane.T_pad}), L_cap {plane.L_cap}, p_pad {plane.p_pad}, "
          f"{plane.device_corpus_bytes() / 2**30:.3f} GiB on {dev} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not plane.T_pad:
        fail("the plane has no dense tier")
    warm = sample_queries(rng, corpus, 1)[0]
    batches = sample_queries(rng, corpus, timed_batches)
    L1 = workload_L(plane, [warm] + batches)
    print(f"# workload L {L1} (cap {plane.L_cap})", flush=True)
    search_shape = dict(Q=N_TERMS, L=L1, tiered=True)
    serve_set = batches[-serve_batches:]
    serve_shapes = []
    for qs in serve_set:
        shape = plane.serving_shape(qs)
        if shape not in [sh for sh, _ in serve_shapes]:
            serve_shapes.append((shape, qs))

    # ---- phase 2: kernels against plain versions, each path's shapes -----
    main = check_kernels(plane, batches[0], search_shape, "search")
    k2_err = main["k2_err"]
    for shape, qs in serve_shapes:
        k2_err = max(k2_err, check_kernels(plane, qs, shape,
                                           "serve")["k2_err"])

    # ---- phase 3: the main path, each of its two paths counted alone -----
    def search_call(qs, st):
        return plane.search(qs, k=K, **search_shape, stages=st)

    def serve_call(qs, st):
        return plane.serve(qs, k=K, stages=st)

    lat, stages, counts_search, n_search, (s_vals, s_hits) = drive(
        plane, [warm] + batches, search_call, kb)
    print(f"# search: {len(lat) * BATCH / lat.sum():.1f} q/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms per {BATCH}-query batch "
          f"over {len(lat)} batches [{card}]", flush=True)
    print("# search stages (mean ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"# search launches over {n_search} dispatches: {counts_search}",
          flush=True)
    serve_lat, serve_stages, counts_serve, n_serve, (v_vals, v_hits) = \
        drive(plane, [warm] + serve_set, serve_call, kb)
    print(f"# serve: {len(serve_lat) * BATCH / serve_lat.sum():.1f} q/s, "
          f"p50 {np.percentile(serve_lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(serve_lat, 99) * 1e3:.3f} ms over "
          f"{len(serve_lat)} batches [{card}]", flush=True)
    print("# serve stages (mean ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in serve_stages.items()))
    print(f"# serve launches over {n_serve} dispatches: {counts_serve}",
          flush=True)

    # exact reference on a few queries of each path's first timed batch
    qs = batches[0]
    _, _, totals = plane.search(qs[:REF_QUERIES], k=K, **search_shape,
                                with_totals=True)
    check_against_exact(corpus, plane, qs, s_vals, s_hits, totals, "search")
    qs = serve_set[0]
    _, _, totals = plane.serve(qs[:REF_QUERIES], k=K, with_totals=True)
    check_against_exact(corpus, plane, qs, v_vals, v_hits, totals, "serve")

    # ---- phase 4: per-kernel times at the search path's shapes -----------
    prep, k1_in, k1_kw, k3_calls = (main["prep"], main["k1_in"],
                                    main["k1_kw"], main["k3_calls"])
    a = prep["args"]
    W, dense, u_ids = a["W"], a["dense"], a["u_ids"]
    lens = a["lengths"].cpu().numpy()
    starts = a["starts"].cpu().numpy()
    pdocs = plane.docs_dev[0].cpu().numpy()
    dw = a["dense_w"].cpu().numpy()
    n_post = int(lens.sum())
    owner_slots = 0
    n_owner = 0
    for b in range(lens.shape[0]):
        runs = [pdocs[starts[b, 0, q]: starts[b, 0, q] + lens[b, 0, q]]
                for q in range(lens.shape[2]) if lens[b, 0, q]]
        own = np.unique(np.concatenate(runs)).size if runs else 0
        n_owner += own
        owner_slots += own * int((dw[b, 0] > 0).sum())
    B_, S_ = lens.shape[0], lens.shape[1]
    k1_bytes = 8 * n_post + 2 * owner_slots + 8 * B_ * S_ * K + 4 * B_ * S_
    k1_flops = n_post + 2 * (n_post - n_owner) + 2 * owner_slots + n_owner
    Wn = W.cpu().numpy()
    rows_used = int(sum(np.count_nonzero(np.any(Wn[:, s] != 0, axis=0))
                        for s in range(S_)))
    nnz_w = int(np.count_nonzero(Wn))
    per, n_tiles = k2_tiling(plane.n_pad, K)
    k2_bytes = 2 * rows_used * plane.n_pad + Wn.nbytes \
        + 8 * B_ * S_ * n_tiles * K + 4 * B_ * S_
    k2_flops = 2 * nnz_w * plane.n_pad
    k3_bytes = sum(8 * x["a_vals"].numel() + 8 * x.get(
        "b_vals", x["a_vals"][:, :0]).numel() + 8 * x["a_vals"].shape[0]
        * kw["k"] for x, kw in k3_calls)

    def k3_all(plain=False):
        f = topk_merge_plain if plain else topk_merge
        for x, kw in k3_calls:
            f(*x.values(), **kw)

    def k3_library():
        for x, _ in k3_calls:
            v = x["a_vals"] if "b_vals" not in x else \
                torch.cat([x["a_vals"], x["b_vals"]], 1)
            torch.sort(v, dim=1, descending=True, stable=True)

    def launches(name):
        return dict(launches=counts_search[name] + counts_serve[name],
                    launches_by_path={"search": counts_search[name],
                                      "serve": counts_serve[name]})

    kernels = []
    # K1
    ms = timed(lambda: sparse_candidates_topk(*k1_in, **k1_kw), reps)
    plain = timed(lambda: sparse_candidates_topk_plain(*k1_in, **k1_kw), 3)
    bms, bby = bound(k1_bytes, k1_flops)
    kernels.append(dict(
        name="sparse_candidates_topk", route="cuda",
        source="elasticsearch_tpu_torch/csrc/sparse_candidates_topk.cu",
        replaces="elasticsearch_tpu/ops/sorted_merge.py:53",
        **launches("sparse_candidates_topk"), max_abs_err=0.0,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
        library_ms=None))
    # K2 (the partial pass alone; its tile reduce is K3's first call)
    ms = timed(lambda: dense_stream_partials(W, dense, k=K, u_ids=u_ids),
               reps)
    plain = timed(lambda: dense_stream_topk_plain(W, dense, k=K,
                                                  u_ids=u_ids), 2)
    rows = dense[0] if u_ids is None else dense[0][:, u_ids[0].long()]
    rows = rows.permute(1, 0, 2).reshape(rows.shape[1], -1).float()
    Ws = W[:, 0].contiguous()

    def k2_library():
        sc = torch.matmul(Ws, rows)
        torch.sort(sc, dim=1, descending=True, stable=True)

    lib = timed(k2_library, 3)
    del rows
    bms, bby = bound(k2_bytes, k2_flops)
    kernels.append(dict(
        name="dense_stream_topk", route="cuda",
        source="elasticsearch_tpu_torch/csrc/dense_stream_topk.cu",
        replaces="elasticsearch_tpu/ops/tiered_bm25.py:123",
        **launches("dense_stream_topk"), max_abs_err=k2_err, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=lib))
    # K3 (its three calls of one dispatch)
    ms = timed(k3_all, reps)
    plain = timed(lambda: k3_all(True), 3)
    lib = timed(k3_library, reps)
    bms, bby = bound(k3_bytes, 0)
    kernels.append(dict(
        name="topk_merge", route="cuda",
        source="elasticsearch_tpu_torch/csrc/topk_merge.cu",
        replaces="elasticsearch_tpu/ops/tiered_bm25.py:200",
        **launches("topk_merge"), max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=lib))
    n_disp = n_search + n_serve
    for kd in kernels:
        print(f"# {kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f}"
              f" ms by {kd['bound_by']}), plain {kd['plain_ms']:.3f} ms, "
              f"library {kd['library_ms']}, "
              f"{kd['launches'] / n_disp:.2f} launches/dispatch [{card}]")
    print(f"# K1 inputs: {n_post} valid postings, {n_owner} candidates; "
          f"K2 inputs: {rows_used} dense rows used, {nnz_w} non-zero "
          f"weights, U={prep['U']}, {n_tiles} tiles of {per} docs")
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return kernels, card


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import elasticsearch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kernels, card = run()
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
