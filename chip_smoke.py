#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives the port's serving planes (``elasticsearch_tpu_torch``, no JAX) at
the headline size of the repository's benchmark: a 2^23-document synthetic
Zipf corpus (vocabulary 2^16, mean length 32, s = 1.2, seed 1234), packed
into a tiered BM25 plane on the card and served in batches of 64 four-term
queries at k = 10; then the block-max pruned route at the repository's
prune configuration (``lexical_10m_prune``): a 2^22-document corpus
(mean length 16, seed 1234) with no dense tier and a block-max tier,
served through ``plane.serve`` in batches of 16 four-term queries; bool
trees on that plane; the kNN plane's exact and IVF routes at the
benchmark's two kNN shapes; the one-dispatch hybrid (BM25 + kNN + RRF)
at BEIR/NQ's size; config #3's terms + percentiles aggregation at the
NYC-taxi rally track's size; and, between the headline and the pruned
route, the per-segment search path (``ShardSearcher``) over the headline
corpus as one segment and the serving route (``ServingPlaneCache`` →
micro-batcher → ``serve``) from 32 client threads on that segment; and,
last, the ML path (``MlService``: trained-model
inference, the ``inference`` ingest processor, outlier detection and
classification over a frame of Kibana's flights sample schema at ten
times its size). Phases, each fatal on failure:

1. the card's name and power limit; build the CUDA kernels (one ``nvcc``
   a source, all started together);
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
5. the per-segment search path (:func:`run_segment`): phase 1's corpus as
   one force-merged segment (the ``body`` text field, terms ``w{tid}``)
   with a ``tag`` keyword (256 Zipf(1.1) ordinals) and a ``price`` double
   (lognormal(3, 1)), one value a doc, n_pad 2^23, no cut; requests one at
   a time through ``ShardSearcher.search``: (e) ``match`` of four terms
   ∝ df, size 10; (f) the same with ``operator: and``; (g) a ``bool`` of
   (e)'s match, a ``terms`` filter on three tags, a ``range`` filter on
   price's 25th-75th percentiles and a ``must_not`` tag term; (h) a
   keyword ``range`` on tag and the ``count`` of (g); (i) (e) from 990
   and from 9,990: each mix's launches counted alone, every K16–K19 call
   of its first request held against its plain version (K16's scores
   bitwise and counts exact, K17 and K18 exact, K19 bitwise), three
   requests of each against numpy (scores within 1 %, docs at separated
   ranks, totals exact), (e)'s top 10 against ``plane.search`` of an f32
   plane (no dense tier) of the same corpus, q/s and p50/p99 per mix,
   K16–K19's times (K16's pre-pass and tile kernel apart, by
   ``torch.profiler``);
6. the serving route (:func:`run_serving`, config #1 as users reach it)
   on phase 5's segment: ``ServingPlaneCache(device=cuda).plane_for``
   builds the serving generation (dense and block-max tiers; its
   seconds, bytes and accounting-breaker reservation printed), and 32
   client threads send ``match`` bodies of four terms through
   ``ShardSearcher(plane_provider=cache.plane_for).search`` at size 10,
   2,048 requests a mix: (s1) terms ∝ df at Elasticsearch's default
   ``track_total_hits: 10000`` (the pruned route where a batch has no
   dense-tier term), (s2) the same with ``track_total_hits: true`` (the
   eager tiered route, exact totals), (s3) uniform tail terms at 10000
   (mostly pruned dispatches); requests/s, p50/p99/max a request,
   dispatches and batch sizes, stage means, launches a dispatch by
   kernel, each mix's launches counted alone, the garbage collector's
   pauses in each window, the card's busy share under (s1)
   (``torch.profiler``); the first pruned dispatch's K4 equal
   and K5 bitwise to their plain versions and every recorded K3 call
   bitwise; every dispatch replayed through ``serve`` alone on its batch
   (values bitwise, hits, totals) and every response's hits its
   dispatch's; three requests a mix against numpy (totals exact in
   (s2)); then a 2^16-doc segment appended (seed 1235): served from the
   delta tier with no rebuild, its host scan's ms a dispatch, three
   requests against numpy BM25 over both segments at the frozen avgdl;
7. the pruned route (:func:`run_pruned`): K4 equal and K5 bitwise to their
   plain versions, and K3 exact, on one batch of each traffic mix; each
   mix driven through ``serve`` with its launch counts zeroed before and
   read after (K4, K5 and K3 on every pruned dispatch, K1 iff a query was
   unsafe); pruned == eager on three batches of each mix (the benchmark
   mix (a), whose queries K1 re-serves, and mix (b), whose certified
   queries come from K4's survivors through K5 and K3); three queries of
   each mix against the exact reference; K1 against its plain version at
   the eager fallback's shape, its time beside its bound and plain
   version; K4's and K5's times, and K5's yardstick (``k5_yardstick``:
   ``torch.searchsorted`` over a shard's (run start, doc) keys, the
   gather, the products and the ordered sum; bitwise the plain version);
8. bool trees (:func:`run_bool`, config #2) through ``serve_bool`` on the
   pruned phase's plane, batches of 16 at k = 10 in two mixes: (c) one
   8-term should clause (``bench_bool_disjunction``'s draws), (d) must /
   should (3 terms) / filter / must_not: K9 bitwise and K3 exact against
   their plain versions on a batch of each mix and of a tree with three
   should clauses at msm 2; three trees of each against a numpy exact
   reference (clause membership, scores within 1 %, totals exact); mix
   (c) equal to ``plane.search`` of the same bags (the K1 path); the
   rescore stage (``bool_rescore_device``) for each of the five score
   modes with K5, K3's selection, the payload gather and K11 (its
   counting path, n = 100) bitwise;
   each mix's launches counted alone; K9's and K11's times, K9's launch
   (its plan, blocks, blocks an SM) and, after every timing, its device
   time a dispatch over each mix's timed batches (``torch.profiler``);
9. the exact kNN route (:func:`run_knn_exact`) at ``bench.py:bench_knn``'s
   GloVe shape: 1.2M x 100 ``randn`` rows (seed 1234), one shard, cosine,
   k = 100, 32 timed batches of 16 through ``plane.serve``: K6 within the
   parity bar of its plain version and every K3 call of the step bitwise,
   K6 also at 2^18 rows for dot_product and l2_norm with duplicates and
   ``exists`` holes, every query of one batch against numpy (matmul +
   lexsort), the path's launches counted alone, K6's times, chunks and
   blocks an SM;
10. the IVF route (:func:`run_knn_ivf`) at ``bench.py:bench_knn_ivf``'s
   shape: 2^20 x 64 rows around 2048 centers (noise 0.35), nlist 1024,
   seed 7, queries perturbed corpus rows (noise 0.15), k = 10 at the
   tier's default nprobe and rerank, 24 timed batches through ``serve``:
   the pack time, the union width, r_cand, recall@10 against the exact
   route for the kernels and for the plain versions (the kernels' may
   not be lower), K7/K8 within the parity bar and K3 bitwise, the card's
   and numpy's cluster assignments compared, the path's launches counted
   alone, K7's and K8's times, and K8's and its yardstick's device times
   (``torch.profiler``);
11. the hybrid (:func:`run_hybrid`, config #5): 2,681,468 passages (mean
   length 79) and as many 768-d ``standard_normal`` rows, one shard each,
   batches of 16 queries (9 sparse-tier terms in one should clause, a
   randn vector; RRF, rank constant 60, windows 100, k = 10) through
   ``fused_search_device``: K9, K10 and every K3 call bitwise and K6
   within the parity bar against their plain versions; sum fusion and
   the five rescore modes with K10 (its rescore payload too), K5 (one
   launch for both lists) and K11 (its counting path, n = 200) bitwise;
   K10's and K11's sorting paths at rank windows of 300 (K11 in the five
   modes, n = 1,024); a dense-tier term refused; four queries against numpy (exact BM25 top-100, matmul +
   lexsort kNN top-100, their RRF by ``rrf_fuse_rows``); the path's
   launches counted alone; each kernel's time, K9's launch and its device
   time a dispatch over the timed batches;
12. aggregations (:func:`run_aggs`, config #3): 165,346,692 docs (Rally's
    ``nyc_taxis``), one pair a doc, 256 Zipf(1.1) ordinals, lognormal(3, 1)
    values, pairs sorted by (ordinal, value), a fresh 25 % mask a agg:
    33 aggs (one warm-up) through ``masked_rank_prefix`` (K12) →
    ``top_ordinals`` → ``prefix_percentiles`` (K13), top 10 and
    percentiles [50, 95, 99] of four of them equal to numpy; the ordinal
    CSR, HLL pairs and histogram ids of a stand-in segment of the same
    columns built by the port's caches (``pack_s``), and over them, for
    three masks, K12's counts and sums, K13's register max (equal to
    ``host_register_max``), K14's bucket counts and sums and K15; K12–K15
    against their plain versions (integers, picks, min and max bitwise;
    f32 sums within 2^-22 of their |v| mass); K13 also where each of its
    fallbacks runs (``k13_edge_checks``: a 0.1 % mask, a run with no
    masked pair, ordinal V and past it, ranks at count − 1 of the last
    run); the path's launches counted alone; each kernel's time beside
    its bound, plain version and library call;
13. the ML path (:func:`run_ml`, ``xpack/ml.py``) through ``MlService`` on
    the card, all from ``RandomState(1234)``: (j) ``_infer`` of a
    ``weighted_sum`` ensemble of 500 full trees of depth 8 (511 nodes) over
    32 features (a fifth of the splits ``default_left: false``), 1,024
    docs a call with 10 % of their features missing, 20 timed calls; (k)
    the same model through the ``inference`` ingest processor of the
    port's ``Pipeline``, 256 docs one at a time; (l) outlier detection
    (``n_neighbors`` unset: 5) and (m) classification of ``FlightDelay``
    (500 steps; ``FlightDelayMin`` excluded) over a frame of
    ``kibana_sample_data_flights``' schema at 131,072 docs (eight numeric
    fields), paged through ``_load_frame`` from an in-memory source, then
    regression of ``FlightDelayMin`` (host ``lstsq``, timed only): K20
    (its batch shape at (j), its few-docs shape at (k), over the pack
    the model built once: no pack at inference) equal to its plain
    version and to a numpy walk on every recorded call, and on a model of
    8,191-node trees at (j)'s and (k)'s n (the batch shape), K21 bitwise to its plain version over every row (in chunks)
    and 1,024 sampled rows' dk against f64, K22 within 1e-5 of
    max(1, |W|) of its plain version and of a numpy f64 run (a planted
    TF32 run must land outside that bar), the written results recomputed
    from the gated arrays; K20 launched once a call
    and a doc, K21 once an outlier run, K22 once a run; docs/s and
    p50/p99, the analytics' wall split (frame load, standardise, kernel,
    tail, write), each kernel's time beside its bound, plain version and
    library call;
14. a comment line with the redesigned kernels' times before their
    redesign (from PERF.md's kernel table, not measured in this run),
    the ``kernels``
    JSON line, the whole run's seconds, the card line, and the final
    status line.

Exits non-zero with no result line when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import contextlib
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

#: the pruned route (``bench.py:bench_lexical_prune``): no dense tier,
#: block-max tier with its defaults, B = 16 four-term queries, k = 10
PRUNE_DOCS = 1 << 22
PRUNE_AVG_DL = 16
PRUNE_BATCH = 16
PRUNE_BATCHES = 16           # timed batches per mix (one warm-up more)
SAFETY_BATCHES = 3           # pruned == eager on these batches of mix (a)
#: queries per plain-K1 call in the fallback-shape check (the plain
#: version holds Q·L entries a query, 2^25 at L = 2^22)
FALLBACK_CHUNK = 4


def sample_queries(rng, corpus, n_batches, batch=BATCH, weighted=True):
    """Batches of four-term queries over the terms of df >= 2, as the
    benchmark draws them: term t with probability ∝ its posting mass, no
    df cap (the pruned route's mix (a)); ``weighted=False`` draws terms
    uniformly (mix (b): tail terms, whose top-k the pruned route's
    survivor window is meant to certify)."""
    df = corpus["df"].astype(np.float64)
    eligible = np.flatnonzero(df >= 2)
    p = df[eligible] / df[eligible].sum() if weighted else None
    return [[[f"t{t}" for t in row]
             for row in rng.choice(eligible, size=(batch, N_TERMS), p=p)]
            for _ in range(n_batches)]


def exact_bm25(corpus, terms, k, *, and_=False, mask=None, avgdl=None,
               extra=()):
    """Numpy term-at-a-time BM25 over the whole corpus (f32 impacts) at
    ``avgdl`` (by default the mean over all docs): (top k+1 docs by
    (score desc, doc asc), their scores, number of matching docs). A doc
    matches on any term (on every term with ``and_``) and only inside
    ``mask``; docs that do not match score -inf. ``extra``: further
    corpora of the same index (an appended segment), their docs numbered
    after the corpus's, the dfs and the doc count summed over all."""
    parts = [corpus, *extra]
    dls = [c["doc_len"] for c in parts]
    n_docs = sum(dl.shape[0] for dl in dls)
    if avgdl is None:
        avgdl = np.concatenate(dls).mean()
    uniq = sorted(set(terms))
    df = {t: sum(int(c["df"][int(t[1:])]) for c in parts) for t in uniq}
    scores, cnt = [], []
    for c, dl in zip(parts, dls):
        offsets, docs, tf = c["offsets"], c["docs"], c["tf"]
        sc = np.zeros(dl.shape[0], np.float32)
        ct = np.zeros(dl.shape[0], np.int32)
        for t in uniq:
            tid = int(t[1:])
            st, en = offsets[tid], offsets[tid + 1]
            if en == st:
                continue
            run_docs = docs[st:en]
            run_tf = tf[st:en]
            idf = np.log(1 + (n_docs - df[t] + 0.5) / (df[t] + 0.5))
            w = terms.count(t)
            norm = run_tf + K1 * (1 - B_BM25 + B_BM25 * dl[run_docs] / avgdl)
            sc[run_docs] += w * idf * (K1 + 1) * run_tf / norm
            ct[run_docs] += 1
        scores.append(sc)
        cnt.append(ct)
    scores, cnt = np.concatenate(scores), np.concatenate(cnt)
    hit = cnt >= (len(uniq) if and_ else 1)
    if mask is not None:
        hit &= mask
    scores[~hit] = -np.inf
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


def queued_ms(fn, reps, sleep_cycles=50_000_000):
    """Mean card ms of ``fn`` a call: CUDA events around ``reps`` calls
    enqueued behind a sleep kernel, so the card runs them back to back and
    no host time falls between them; None when the host took longer to
    enqueue the calls than the card slept (then host time would count)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(sleep_cycles)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    if host >= e0.elapsed_time(a):
        return None
    return a.elapsed_time(b) / reps


def bound(nbytes, flops):
    t_b = nbytes / HBM_BPS * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def same_bits(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def max_abs_err(pairs):
    """Largest |kernel - plain| over (kernel, plain) output pairs; equal
    entries (infinities included) count 0, integer outputs are skipped."""
    import torch
    err = 0.0
    for a, b in pairs:
        if not a.is_floating_point():
            continue
        a, b = a.double(), b.double()
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        if d.numel():
            err = max(err, float(d.max()))
    return err


def check_topk(v1, d1, v2, d2, v_next, rtol, atol, what, sep_rtol=None):
    """Values within tolerance slot by slot; docs equal wherever the
    reference's neighbouring values differ by more than the tolerance
    (``sep_rtol`` in place of ``rtol`` there, where given)."""
    v1, v2 = np.asarray(v1, np.float64), np.asarray(v2, np.float64)
    if not np.array_equal(np.isfinite(v1), np.isfinite(v2)):
        fail(f"{what}: finite slots differ")
    f = np.isfinite(v2)
    if not np.allclose(v1[f], v2[f], rtol=rtol, atol=atol):
        fail(f"{what}: scores differ beyond rtol={rtol}")
    R = v2.shape[0]
    ext = np.concatenate([np.full((R, 1), np.inf), v2,
                          np.asarray(v_next, np.float64)[:, None]], 1)
    tol = atol + (rtol if sep_rtol is None else sep_rtol) * np.abs(v2)
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
    k1_err = max_abs_err(zip(k1_out, k1_ref))

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
    k3_err = 0.0
    for args, kw in k3_calls:
        got = topk_merge(*args.values(), **kw)
        want = topk_merge_plain(*args.values(), **kw)
        if not all(same_bits(x, y) for x, y in zip(got, want)):
            fail(f"{label}: K3 topk_merge differs from its plain version "
                 f"({kw})")
        k3_err = max(k3_err, max_abs_err(zip(got, want)))
    print(f"# {label} (Q={prep['Q']}, L={prep['L']}, U={prep['U']}): "
          f"K1 == plain (bitwise), K2 ~= plain (max abs err {k2_err:.3g}),"
          f" K3 == plain (exact, 3 call shapes)", flush=True)
    return dict(prep=prep, k1_in=k1_in, k1_kw=k1_kw, k3_calls=k3_calls,
                n_tiles=n_tiles, k2_err=k2_err, k1_err=k1_err, k3_err=k3_err)


def k1_work(plane, a, k):
    """Bytes and f32 operations K1 needs on one call's inputs ``a`` (a
    ``prepare`` dispatch's arguments): each valid posting read once (doc
    and impact, 8 bytes), 2 bytes a dense-tier value gathered (one a
    candidate and weighted slot), the k best and the count written.
    Operations: a product a posting, an add a posting past a doc's
    first, a product and an add a gathered value, the final add a
    candidate. Returns (bytes, operations, valid postings, candidates)."""
    lens = a["lengths"].cpu().numpy()
    starts = np.clip(a["starts"].cpu().numpy(), 0, None)
    dw = a.get("dense_w")
    dw = None if dw is None or a.get("dense") is None else dw.cpu().numpy()
    B, S, Q = lens.shape
    n_post = int(lens.sum())
    owner_slots = n_owner = 0
    for s in range(S):
        pdocs = plane.docs_dev[s].cpu().numpy()
        for b in range(B):
            runs = [pdocs[starts[b, s, q]: starts[b, s, q] + lens[b, s, q]]
                    for q in range(Q) if lens[b, s, q]]
            own = int(np.unique(np.concatenate(runs)).size) if runs else 0
            n_owner += own
            if dw is not None:
                owner_slots += own * int((dw[b, s] > 0).sum())
    nbytes = 8 * n_post + 2 * owner_slots + 8 * B * S * k + 4 * B * S
    flops = n_post + 2 * (n_post - n_owner) + 2 * owner_slots + n_owner
    return nbytes, flops, n_post, n_owner


def check_against_exact(corpus, plane, queries, vals, hits, totals, label):
    """The first ``REF_QUERIES`` queries' hits against the numpy exact
    reference: min(k, matching docs) hits, scores within REF_RTOL, docs
    equal where the reference's neighbours are separated, totals exact
    (or, from a pruned scan, ``gte`` lower bounds)."""
    for qi in range(REF_QUERIES):
        top, sc, n_match = exact_bm25(corpus, queries[qi], K)
        n = min(K, n_match)
        got_docs = [s * plane.n_pad + d for s, d in hits[qi]]
        row = np.asarray(vals[qi], np.float64)
        if len(got_docs) != n or not np.isneginf(row[n:]).all():
            fail(f"{label} query {qi}: {len(got_docs)} hits, expected {n}")
        check_topk(row[None, :n], np.asarray([got_docs]), sc[None, :n],
                   top[None, :n], sc[n:n + 1], REF_RTOL, 0.0,
                   f"{label} query {qi} against the exact reference")
        t = totals[qi]
        if isinstance(t, tuple):        # a pruned scan's lower bound
            if t[1] != "gte" or t[0] > n_match:
                fail(f"{label} query {qi}: total {t} is no lower bound of "
                     f"{n_match}")
        elif t != n_match:
            fail(f"{label} query {qi}: total {t} != exact {n_match}")
    print(f"# {label}: {REF_QUERIES} queries agree with the exact reference"
          f" (scores within {REF_RTOL:.0%}, totals exact or gte lower "
          f"bounds)", flush=True)


EAGER_KERNELS = ("sparse_candidates_topk", "dense_stream_topk", "topk_merge")
PRUNED_KERNELS = ("blockmax_scan", "bisect_exact_scores", "topk_merge")


def drive(plane, batches, call, kb, required=EAGER_KERNELS,
          stage_keys=("prep_ms", "dispatch_ms", "fetch_ms")):
    """One path of the main path: launch counts zeroed, a warm-up batch
    and the timed batches through ``call``, counts read. Returns the
    per-batch seconds, the summed stages of the timed batches, the
    counts, the dispatches and the first timed batch's (vals, hits)."""
    kb.reset_launches()
    n0 = plane.n_dispatches
    call(batches[0], {})
    lat, first = [], None
    stages_sum = {key: 0.0 for key in stage_keys}
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
    if not all(counts[n] > 0 for n in required):
        fail(f"a kernel of the main path never launched: {counts}")
    return (np.asarray(lat), stages_sum, counts, plane.n_dispatches - n0,
            first)


def run(*, n_docs=N_DOCS, timed_batches=TIMED_BATCHES,
        serve_batches=SERVE_BATCHES, reps=20):
    import torch
    from elasticsearch_tpu_torch.device import card_info
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.sorted_merge import (
        sparse_candidates_topk, sparse_candidates_topk_plain)
    from elasticsearch_tpu_torch.ops.tiered_bm25 import (
        dense_stream_partials, dense_stream_topk_plain, dense_stream_topk_plan)
    from elasticsearch_tpu_torch.ops.topk import (card_limits, topk_merge,
                                                  topk_merge_plain)
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
    errs = {key: main[key] for key in ("k1_err", "k2_err", "k3_err")}
    for shape, qs in serve_shapes:
        ck = check_kernels(plane, qs, shape, "serve")
        errs = {key: max(v, ck[key]) for key, v in errs.items()}
    k2_err = errs["k2_err"]

    # ---- phase 3: the main path, each of its two paths counted alone -----
    def search_call(qs, st):
        return plane.search(qs, k=K, **search_shape, stages=st)

    def serve_call(qs, st):
        return plane.serve(qs, k=K, stages=st)

    lat, stages, counts_search, n_search, (s_vals, s_hits) = drive(
        plane, [warm] + batches, search_call, kb)
    stages = {key: v / len(lat) for key, v in stages.items()}
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
    serve_stages = {key: v / len(serve_lat)
                    for key, v in serve_stages.items()}
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
    k1_bytes, k1_flops, n_post, n_owner = k1_work(plane, a, K)
    B_, S_ = a["lengths"].shape[:2]
    Wn = W.cpu().numpy()
    rows_used = int(sum(np.count_nonzero(np.any(Wn[:, s] != 0, axis=0))
                        for s in range(S_)))
    nnz_w = int(np.count_nonzero(Wn))
    k2_plan = dense_stream_topk_plan(B_, S_, W.shape[2], plane.n_pad, K,
                                     *card_limits(0))
    per, n_tiles = k2_plan["tile"], k2_plan["n_tiles"]
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
        **launches("sparse_candidates_topk"), max_abs_err=errs["k1_err"],
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
        **launches("topk_merge"), max_abs_err=errs["k3_err"], ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=lib))
    n_disp = n_search + n_serve
    for kd in kernels:
        print(f"# {kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f}"
              f" ms by {kd['bound_by']}), plain {kd['plain_ms']:.3f} ms, "
              f"library {kd['library_ms']}, "
              f"{kd['launches'] / n_disp:.2f} launches/dispatch [{card}]")
    print(f"# K1 inputs: {n_post} valid postings, {n_owner} candidates; "
          f"K2 inputs: {rows_used} dense rows used, {nnz_w} non-zero "
          f"weights, U={prep['U']}, {n_tiles} tiles of {per} docs, "
          f"{k2_plan['QB']} queries a block, a ring of "
          f"{k2_plan['rows_max']} rows a pass")
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return kernels, card, corpus


def check_pruned_kernels(plane, queries, label):
    """K4, K5 and K3's two calls of one pruned dispatch on the inputs
    ``plane.prepare_pruned`` builds for ``queries``, each held against its
    plain version (K4 equal in every output, K5 bitwise, K3 exact)."""
    import torch
    from elasticsearch_tpu_torch.ops.blockmax import (blockmax_scan,
                                                      blockmax_scan_plain)
    from elasticsearch_tpu_torch.ops.fused_query import (
        bisect_exact_scores, bisect_exact_scores_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain

    prep = plane.prepare_pruned(queries, K)
    if prep["step"] != "pruned":
        fail(f"{label}: the batch does not take the pruned step")
    a = prep["args"]
    B, S, R = prep["B"], plane.n_shards, prep["R"]
    kq = K * prep["Q"]
    k4_kw = dict(n_pad=plane.n_pad, NB=plane.blockmax.n_blocks,
                 W=prep["W"], R=R, kq_idx=min(kq, prep["W"]) - 1,
                 prune_active=kq <= prep["W"])
    k4_in = [a[n] for n in ("t_docs", "t_codes", "t_scale", "t_off",
                            "sched", "w", "rho", "slack")]
    acc = plane.blockmax.scan_workspace(B * S, plane.device)
    k4_out = blockmax_scan(*k4_in, **k4_kw, acc=acc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k4_ref = blockmax_scan_plain(*k4_in, **k4_kw)
    torch.cuda.synchronize()
    k4_plain_ms = (time.perf_counter() - t0) * 1e3
    names = ("survivors", "partials", "matched", "unsafe", "pruned", "n_sc")
    for name, x, y in zip(names, k4_out, k4_ref):
        if not same_bits(x, y):
            fail(f"{label}: K4 blockmax_scan {name} differ from its plain "
                 f"version")
    if acc is not None and bool(acc.any()):
        fail(f"{label}: K4 left its accumulator workspace dirty")
    k4_err = max_abs_err(zip(k4_out, k4_ref))
    ci = k4_out[0]
    k5_in = (a["postings_docs"], a["postings_impact"], a["starts"],
             a["lengths"], a["idfw"], ci)
    k5_out = bisect_exact_scores(*k5_in, n_pad=plane.n_pad)
    k5_ref = bisect_exact_scores_plain(*k5_in, n_pad=plane.n_pad)
    if not all(same_bits(x, y) for x, y in zip(k5_out, k5_ref)):
        fail(f"{label}: K5 bisect_exact_scores differs from its plain "
             f"version (bitwise)")
    k5_err = max_abs_err(zip(k5_out, k5_ref))
    kk = min(K, plane.n_pad)
    v1, d1 = topk_merge(k5_out[0].reshape(B * S, R), ci.reshape(B * S, R),
                        k=kk, fill_id=plane.n_pad)
    k3_calls = [
        (dict(a_vals=k5_out[0].reshape(B * S, R),
              a_ids=ci.reshape(B * S, R)), dict(k=kk, fill_id=plane.n_pad)),
        (dict(a_vals=v1.view(B, S * kk), a_ids=d1.view(B, S * kk)),
         dict(k=min(K, S * kk), fill_id=S * plane.n_pad, seg_len=kk,
              seg_stride=plane.n_pad))]
    k3_err = 0.0
    for args, kw in k3_calls:
        got = topk_merge(*args.values(), **kw)
        want = topk_merge_plain(*args.values(), **kw)
        if not all(same_bits(x, y) for x, y in zip(got, want)):
            fail(f"{label}: K3 topk_merge differs from its plain version "
                 f"({kw})")
        k3_err = max(k3_err, max_abs_err(zip(got, want)))
    counts = [x.cpu().numpy() for x in k4_out[2:]]
    print(f"# {label} (Q={prep['Q']}, P_sched={prep['P_sched']}, "
          f"W={prep['W']}, R={R}): K4 == plain (every output), K5 == plain "
          f"(bitwise), K3 == plain (2 call shapes); plain K4 "
          f"{k4_plain_ms:.1f} ms; matched {counts[0].ravel().tolist()}, "
          f"unsafe {int(counts[1].sum())}, pruned {int(counts[2].sum())}, "
          f"blocks scored {int(counts[3].sum())} of "
          f"{int(prep['sched_lens'].sum())}", flush=True)
    return dict(prep=prep, k4_in=k4_in, k4_kw=k4_kw, acc=acc, k5_in=k5_in,
                k3_calls=k3_calls, k4_plain_ms=k4_plain_ms,
                unsafe=counts[1][:, 0] > 0, pruned=counts[2], n_sc=counts[3],
                n_real=(ci < plane.n_pad).sum(-1).cpu().numpy(),
                k3_err=k3_err, k4_err=k4_err, k5_err=k5_err)


def k4_work(plane, a, ck, R):
    """Bytes and f32 operations K4 needs on one checked batch: each input
    read once and each output written once, of what the scan reaches. The
    scored blocks are each schedule's first ``n_sc`` steps: 5 bytes a real
    posting (doc, code) and 8 a block (scale, off); 12 bytes a scored step
    (sched, w, rho) and 8 for the step that stops a pruned scan; slack;
    survivors (8 bytes a slot) and 4 counts. The accumulator is the
    kernel's workspace, so its read-modify-write is left out. Operations:
    4 a real posting (the FMA counted as 2, the product with w, the add)."""
    import torch
    sched = a["sched"]
    B, S, P = sched.shape
    dev = sched.device
    n_sc = torch.from_numpy(ck["n_sc"]).to(dev)
    scored = torch.arange(P, device=dev) < n_sc[..., None]
    shard = torch.arange(S, device=dev)[None, :, None].expand(B, S, P)
    docs = a["t_docs"][shard[scored], sched[scored].long()]
    real_post = int((docs < plane.n_pad).sum())
    blocks = int(ck["n_sc"].sum())
    nbytes = real_post * 5 + blocks * (8 + 12) + int(ck["pruned"].sum()) * 8 \
        + B * S * 4 + B * S * R * 8 + B * S * 16
    return nbytes, real_post * 4, real_post


def k5_work(plane, a, ck):
    """Bytes and f32 operations K5 needs on one checked batch: the
    candidates, starts, lengths and idfw read once; for each real candidate
    and non-empty slot a bisect of ceil(log2(len + 1)) dependent 4-byte doc
    reads; 4 bytes for each impact found; scores (4 bytes) and found flags
    (1 byte) written. Empty slots and ``n_pad`` candidates read no run.
    Operations: a multiply and an add for each impact found."""
    import torch
    ci = ck["k5_in"][5]
    B, S, R = ci.shape
    lens = a["lengths"].cpu().numpy()
    starts = a["starts"].cpu().numpy()
    Q = lens.shape[2]
    steps = np.ceil(np.log2(lens + 1.0))                  # [B, S, Q]
    bisect_reads = int((steps.sum(-1) * ck["n_real"]).sum()) * 4
    found = 0
    for b in range(B):
        for s in range(S):
            cand = ci[b, s][ci[b, s] < plane.n_pad]
            for q in range(Q):
                st, n = int(starts[b, s, q]), int(lens[b, s, q])
                if n and cand.numel():
                    run = plane.docs_dev[s, st:st + n]
                    found += int(torch.isin(cand, run).sum())
    nbytes = B * S * R * 4 + B * S * Q * 8 + B * Q * 4 + bisect_reads \
        + found * 4 + B * S * R * 5
    return nbytes, 2 * found, found, bisect_reads


def k5_keys(plane):
    """K5's yardstick's sorted keys, i64[S, P]: a posting's run start
    · 2^32 + its doc (past a shard's runs P · 2^32, after every key),
    built once outside the timed call."""
    import torch
    S, P = plane.docs_dev.shape
    keys = np.full((S, P), P << 32, np.int64)
    for s, sh in enumerate(plane.shards):
        off = np.asarray(sh["sparse_offsets"], np.int64)
        n = int(off[-1])
        start = np.repeat(off[:-1], np.diff(off))
        keys[s, :n] = (start << 32) + \
            plane.docs_dev[s, :n].cpu().numpy().astype(np.int64)
    return torch.from_numpy(keys).to(plane.docs_dev.device)


def k5_yardstick(keys, postings_impact, starts, lengths, idfw, cand_docs,
                 *, n_pad):
    """K5's function in PyTorch calls: one ``torch.searchsorted`` a shard
    row over ``k5_keys`` for every (candidate, slot) key, then the
    gathers, the products and the sum from the highest slot down (the
    plain version's order, so the same bits where every slot's run is a
    whole term run or empty, as the plane's lookups give them)."""
    import torch
    B, S, R = cand_docs.shape
    Q = starts.shape[2]
    P = keys.shape[1]
    st = starts.long()[:, :, None, :]
    q = ((st << 32) + cand_docs.long()[..., None]).permute(1, 0, 2, 3)
    end = (st + lengths.long()[:, :, None, :]).permute(1, 0, 2, 3)
    q = q.reshape(S, -1)
    p = torch.searchsorted(keys, q).clamp(max=P - 1)
    # a key found inside the slot's run (an empty slot's start is another
    # term's)
    found = ((torch.gather(keys, 1, p) == q).reshape(S, B, R, Q)
             & (p.reshape(S, B, R, Q) < end))
    imp = torch.gather(postings_impact, 1, p).reshape(S, B, R, Q)
    found, imp = found.permute(1, 0, 2, 3), imp.permute(1, 0, 2, 3)
    c = torch.where(found, idfw[:, None, None, :] * imp,
                    torch.zeros((), device=imp.device))
    score = c[..., Q - 1]
    for qs in range(Q - 2, -1, -1):
        score = score + c[..., qs]
    live = cand_docs < n_pad
    return (torch.where(live, score, torch.zeros_like(score)),
            found.any(-1) & live)


def prune_plane(dev, n_docs=PRUNE_DOCS):
    """The prune configuration's corpus (seed 1234) and its plane on
    ``dev`` (no dense tier, a block-max tier): (the generator, positioned
    for the traffic draws, the corpus, the plane, the corpus's and the
    plane's seconds)."""
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    t0 = time.perf_counter()
    rng = np.random.RandomState(1234)
    corpus = synthetic_csr_corpus_fast(rng, n_docs, VOCAB, PRUNE_AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = DistributedSearchPlane([corpus], "body", device=dev,
                                   dense_threshold=1 << 30, blockmax={})
    tier = plane.blockmax
    if plane.T_pad or tier is None:
        fail("the prune plane must have a block-max tier and no dense tier")
    tier.device_arrays(dev)
    torch.cuda.synchronize()
    return rng, corpus, plane, corpus_s, time.perf_counter() - t0


def run_pruned(card, *, n_docs=PRUNE_DOCS, n_batches=PRUNE_BATCHES,
               reps=20):
    """The block-max pruned route end to end (phase 7). Returns the K4/K5
    rows of the ``kernels`` line, each pruned path's launch counts, K1 at
    the fallback shape, the largest errors, and the plane with its corpus
    (the bool phase serves the same plane)."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan
    from elasticsearch_tpu_torch.ops.fused_query import (
        bisect_exact_scores, bisect_exact_scores_plain)
    from elasticsearch_tpu_torch.ops.sorted_merge import (
        sparse_candidates_topk, sparse_candidates_topk_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    from elasticsearch_tpu_torch.parallel.dist_search import (
        total_is_lower_bound, total_value)

    dev = torch.device("cuda")
    rng, corpus, plane, corpus_s, plane_s = prune_plane(dev, n_docs)
    tier = plane.blockmax
    print(f"# prune corpus: {n_docs} docs, {corpus['docs'].shape[0]} "
          f"postings, largest df {int(corpus['df'].max())} "
          f"({corpus_s:.1f} s)", flush=True)
    print(f"# prune plane: n_pad {plane.n_pad}, L_cap {plane.L_cap}, "
          f"{tier.n_blocks} blocks of {tier.block}, tier {tier.nbytes()} B "
          f"on the host, {plane.device_corpus_bytes() / 2**30:.3f} GiB on "
          f"{dev} ({plane_s:.1f} s)", flush=True)
    mixes = {m: sample_queries(rng, corpus, 1 + n_batches, PRUNE_BATCH,
                               weighted=m == "a") for m in ("a", "b")}

    # ---- kernels against their plain versions, one batch of each mix ------
    chk = {m: check_pruned_kernels(plane, qs[1], f"pruned mix ({m})")
           for m, qs in mixes.items()}

    # ---- the route, each mix counted alone --------------------------------
    counts, res = {}, {}
    for m, qs in mixes.items():
        unsafe_by_batch = []

        def call(batch, st):
            out = plane.serve(batch, k=K, stages=st)
            unsafe_by_batch.append(st["unsafe"])
            return out

        lat, st, c, n_disp, first = drive(
            plane, qs, call, kb,
            required=PRUNED_KERNELS,
            stage_keys=("prep_ms", "dispatch_ms", "fetch_ms",
                        "lex_blocks_scored", "lex_blocks_total", "unsafe"))
        n_pruned = len(qs)
        if c["blockmax_scan"] != n_pruned or \
                c["bisect_exact_scores"] != n_pruned or \
                c["topk_merge"] < 2 * n_pruned:
            fail(f"mix ({m}): K4/K5/K3 did not launch on every pruned "
                 f"dispatch: {c} over {n_pruned} dispatches")
        n_unsafe_batches = sum(1 for u in unsafe_by_batch if u)
        if c["sparse_candidates_topk"] != n_unsafe_batches:
            fail(f"mix ({m}): K1 launched {c['sparse_candidates_topk']} "
                 f"times for {n_unsafe_batches} batches with unsafe queries")
        n_q = len(lat) * PRUNE_BATCH
        counts[m] = c
        res[m] = first
        print(f"# pruned mix ({m}): {n_q / lat.sum():.1f} q/s, p50 "
              f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.3f} ms per "
              f"{PRUNE_BATCH}-query batch over {len(lat)} batches [{card}]",
              flush=True)
        print(f"# pruned mix ({m}) stages (mean ms): " + ", ".join(
            f"{key} {st[key] / len(lat):.3f}"
            for key in ("prep_ms", "dispatch_ms", "fetch_ms")))
        scored, total = int(st["lex_blocks_scored"]), \
            int(st["lex_blocks_total"])
        print(f"# pruned mix ({m}): blocks scored {scored} of {total} in "
              f"the schedules ({1 - scored / max(total, 1):.4f} skipped); "
              f"unsafe {int(st['unsafe'])} of {n_q} queries "
              f"({st['unsafe'] / n_q:.4f}); K1 re-served unsafe queries in "
              f"{n_unsafe_batches} of {len(qs)} batches (warm-up included)",
              flush=True)
        print(f"# pruned mix ({m}) launches over {n_disp} dispatches "
              f"({n_pruned} pruned): {c}", flush=True)

    # ---- rank safety as the benchmark asserts it, exact reference ---------
    # mix (a)'s queries are all unsafe (K1 re-serves them); mix (b)'s safe
    # ones come from K4's survivors through K5 and K3
    for m in ("a", "b"):
        t_pruned = t_eager = 0.0
        n_safe = 0
        for qs in mixes[m][1:1 + SAFETY_BATCHES]:
            st = {}
            t0 = time.perf_counter()
            pv, ph, pt = plane.serve(qs, k=K, with_totals=True, stages=st)
            t1 = time.perf_counter()
            ev, eh, et = plane.serve(qs, k=K, with_totals=True,
                                     prune=False)
            t_eager += time.perf_counter() - t1
            t_pruned += t1 - t0
            n_safe += len(qs) - st["unsafe"]
            if not (same_bits(torch.from_numpy(np.asarray(pv)),
                              torch.from_numpy(np.asarray(ev)))
                    and ph == eh):
                fail(f"rank safety: pruned != eager on a batch of mix ({m})")
            for p, e in zip(pt, et):
                if not (total_value(p) == e or (total_is_lower_bound(p)
                                                and total_value(p) <= e)):
                    fail(f"rank safety: pruned total {p} vs eager {e}")
        n_q = SAFETY_BATCHES * PRUNE_BATCH
        if m == "b" and n_safe == 0:
            fail("rank safety: no query of mix (b) was certified, so K4's "
                 "survivors were never held against the eager step")
        print(f"# rank safety: pruned == eager on {SAFETY_BATCHES} batches "
              f"of mix ({m}) (values bitwise, hits equal, totals exact or "
              f"gte lower bounds), {n_safe} of {n_q} queries served by K4 "
              f"-> K5 -> K3; on these batches, with totals, pruned "
              f"{n_q / t_pruned:.1f} q/s, eager (serve(prune=False)) "
              f"{n_q / t_eager:.1f} q/s [{card}]", flush=True)
    for m, qs in mixes.items():
        _, _, totals = plane.serve(qs[1][:REF_QUERIES], k=K,
                                   with_totals=True)
        check_against_exact(corpus, plane, qs[1], res[m][0], res[m][1],
                            totals, f"pruned mix ({m})")

    # ---- K1 at the eager fallback's shape ---------------------------------
    bad = [q for q, u in zip(mixes["a"][1], chk["a"]["unsafe"]) if u]
    k1_fallback = None
    if bad:
        Qf = chk["a"]["prep"]["Q"]
        Lf = plane.ladder_L(plane.max_run_len(bad))
        fprep = plane.prepare(bad, K, Q=Qf, L=Lf, tiered=None)
        fa = fprep["args"]
        k1_in = (fa["postings_docs"], fa["postings_impact"], fa["starts"],
                 fa["lengths"], fa["idfw"])
        k1_kw = dict(n_pad=plane.n_pad, L=Lf, k=K)
        got = sparse_candidates_topk(*k1_in, **k1_kw)
        k1_err = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(0, len(bad), FALLBACK_CHUNK):
            part = [x[j:j + FALLBACK_CHUNK].contiguous() for x in k1_in[2:]]
            want = sparse_candidates_topk_plain(*k1_in[:2], *part, **k1_kw)
            mine = [x[j:j + FALLBACK_CHUNK] for x in got]
            if not all(same_bits(x, y) for x, y in zip(mine, want)):
                fail("K1 differs from its plain version at the fallback "
                     "shape")
            k1_err = max(k1_err, max_abs_err(zip(mine, want)))
        # the plain version's time over all the unsafe queries, in chunks
        # (its sort of Q·L candidates a query would not fit at once), with
        # the comparisons
        k1_plain = (time.perf_counter() - t0) * 1e3
        k1_ms = timed(lambda: sparse_candidates_topk(*k1_in, **k1_kw), reps)
        nb, nf, n_post, n_owner = k1_work(plane, fa, K)
        bms, bby = bound(nb, nf)
        k1_fallback = dict(B=len(bad), Q=Qf, L=Lf, ms=k1_ms,
                           plain_ms=k1_plain, bound_ms=bms, bound_by=bby,
                           postings=n_post, candidates=n_owner, err=k1_err)
        print(f"# K1 at the fallback shape (B={len(bad)} unsafe queries of "
              f"the checked batch, Q={Qf}, L={Lf}, {n_post} valid "
              f"postings, {n_owner} candidates): {k1_ms:.4f} ms (bound "
              f"{bms:.5f} ms by {bby}), plain {k1_plain:.1f} ms; == plain "
              f"on all {len(bad)} (bitwise) [{card}]", flush=True)

    # ---- K4 and K5 times, each mix's checked batch -------------------------
    rows = {"blockmax_scan": {}, "bisect_exact_scores": {}}
    keys = k5_keys(plane)
    k5_lib = {}
    for m, ck in chk.items():
        prep, B = ck["prep"], ck["prep"]["B"]
        S, R, Q = plane.n_shards, ck["prep"]["R"], ck["prep"]["Q"]
        a = prep["args"]
        k4_bytes, k4_flops, real_post = k4_work(plane, a, ck, R)
        k5_bytes, k5_flops, found_pairs, bisect_reads = k5_work(plane, a, ck)
        blocks_scored = int(ck["n_sc"].sum())
        blocks_total = int(prep["sched_lens"].sum())
        k4_ms = timed(lambda: blockmax_scan(*ck["k4_in"], **ck["k4_kw"],
                                            acc=ck["acc"]), reps)
        k5_ms = timed(lambda: bisect_exact_scores(*ck["k5_in"],
                                                  n_pad=plane.n_pad), reps)
        k5_plain = timed(lambda: bisect_exact_scores_plain(
            *ck["k5_in"], n_pad=plane.n_pad), 3)
        ys_in = (keys, *ck["k5_in"][1:])
        same = all(same_bits(x, y) for x, y in zip(
            k5_yardstick(*ys_in, n_pad=plane.n_pad),
            bisect_exact_scores_plain(*ck["k5_in"], n_pad=plane.n_pad)))
        k5_lib[m] = dict(ms=timed(lambda: k5_yardstick(
            *ys_in, n_pad=plane.n_pad), reps), same_bits=same)
        print(f"# K5's yardstick mix ({m}) (torch.searchsorted over the "
              f"(run start, doc) keys, gathers, products, ordered sum): "
              f"{k5_lib[m]['ms']:.4f} ms, {'==' if same else '!='} plain "
              f"(bitwise) [{card}]", flush=True)
        k3_ms = timed(lambda: [topk_merge(*x.values(), **kw)
                               for x, kw in ck["k3_calls"]], reps)
        for name, ms, plain, nb, nf in (
                ("blockmax_scan", k4_ms, ck["k4_plain_ms"], k4_bytes,
                 k4_flops),
                ("bisect_exact_scores", k5_ms, k5_plain, k5_bytes,
                 k5_flops)):
            bms, bby = bound(nb, nf)
            rows[name][m] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                 bound_by=bby)
            print(f"# {name} mix ({m}): {ms:.4f} ms (bound {bms:.5f} ms by "
                  f"{bby}), plain {plain:.3f} ms [{card}]")
        print(f"# topk_merge, the pruned step's 2 calls, mix ({m}): "
              f"{k3_ms:.4f} ms [{card}]")
        print(f"# K4 mix ({m}) inputs: B={B}, P_sched={prep['P_sched']}, "
              f"{blocks_scored} of {blocks_total} blocks scored, {real_post} "
              f"real postings in them, {k4_bytes} bytes; K5 inputs: "
              f"{int(ck['n_real'].sum())} real candidates of {B * S * R}, "
              f"Q={Q}, {bisect_reads} bisect bytes, {found_pairs} impacts "
              f"found, {k5_bytes} bytes")
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = []
    for name, err_key, src, repl in (
            ("blockmax_scan", "k4_err",
             "elasticsearch_tpu_torch/csrc/blockmax_scan.cu",
             "elasticsearch_tpu/parallel/dist_search.py:1347"),
            ("bisect_exact_scores", "k5_err",
             "elasticsearch_tpu_torch/csrc/bisect_exact_scores.cu",
             "elasticsearch_tpu/ops/fused_query.py:93")):
        err = max(ck[err_key] for ck in chk.values())
        lib = dict(library_ms=None,
                   library_none="no thresholded block scan in PyTorch")
        if name == "bisect_exact_scores":
            # the yardstick computes the same function where it gives the
            # plain version's bits
            lib = dict(library_ms=k5_lib["a"]["ms"]) \
                if k5_lib["a"]["same_bits"] else \
                dict(library_ms=None, library_none="the yardstick differs "
                     "from the plain version on these inputs")
            lib["library_ms_by_mix"] = {m: v["ms"]
                                        for m, v in k5_lib.items()}
        out.append(dict(name=name, route="cuda", source=src, replaces=repl,
                        max_abs_err=err, **rows[name]["a"], **lib,
                        ms_by_mix={m: r["ms"] for m, r in rows[name].items()},
                        plain_ms_by_mix={m: r["plain_ms"]
                                         for m, r in rows[name].items()},
                        bound_ms_by_mix={m: r["bound_ms"]
                                         for m, r in rows[name].items()}))
    errs = dict(k3_err=max(ck["k3_err"] for ck in chk.values()),
                k1_err=k1_fallback["err"] if k1_fallback else 0.0)
    return (out, {f"pruned_{m}": c for m, c in counts.items()}, k1_fallback,
            errs, (plane, corpus))


#: exact kNN at the GloVe shape (``bench.py:bench_knn``): 1.2M rows of
#: d = 100, cosine, k = 100, batches of 16
#: K3 calls a dispatch: exact kNN's chunk reduce (one call, whatever the
#: row's length) and shard reduce; IVF's window top-k and shard reduce
#: (K7 forms the window itself); the hybrid's chunk reduce and its two
#: sides' shard reduces
KNN_K3_CALLS, IVF_K3_CALLS, HY_K3_CALLS = 2, 2, 3
KNN_ROWS = 1_200_000
KNN_DIM = 100
KNN_K = 100
KNN_BATCH = 16
KNN_BATCHES = 32
#: K6 also held at 2^18 rows for the other two similarities
KNN_SMALL_ROWS = 1 << 18
#: IVF at ``bench.py:bench_knn_ivf``'s shape: 2^20 rows of d = 64 around
#: 2048 centers (noise 0.35), nlist 1024, seed 7; queries are corpus rows
#: plus noise 0.15; k = 10 at the tier's default nprobe and rerank
IVF_ROWS = 1 << 20
IVF_DIM = 64
IVF_CENTERS = 2048
IVF_NLIST = 1024
IVF_K = 10
#: ks whose windows (rerank · k = 4,000; serve(k = 10,000)'s min(40,000,
#: the union's rows)) are past K7's window path (1,024): its deep path
IVF_DEEP_K = 1000
IVF_DEEPEST_K = 10000
#: K3 calls K7 makes at such a window (none: the deep path forms it)
IVF_DEEP_WINDOW_K3 = 0
#: timed serve(k = IVF_DEEP_K) batches
IVF_DEEP_BATCHES = 8
IVF_BATCHES = 24
IVF_EVAL = 4
#: rows of the card-vs-host cluster assignment comparison
ASSIGN_SAMPLE = 1 << 15


def knn_tol(q, vecs_max_norm, similarity):
    """The parity bar: 1e-5·‖q‖·max‖v‖ (dot, cosine: unit rows) or
    1e-5·(‖q‖ + max‖v‖)² (l2, whose expansion cancels)."""
    qn = float(np.linalg.norm(q, axis=1).max())
    vn = vecs_max_norm
    if similarity == "cosine":
        qn = vn = 1.0
    return 1e-5 * (qn + vn) ** 2 if similarity == "l2_norm" else \
        1e-5 * qn * vn


def check_bitwise(got, want, what):
    if len(got) != len(want) or \
            not all(same_bits(x, y) for x, y in zip(got, want)):
        fail(f"{what} differs from its plain version")
    return max_abs_err(zip(got, want))


def check_lists(v1, i1, v2, i2, tol, what):
    """[R, k] lists of a kernel (v1, i1) against [R, k+1] of the plain
    version, under the parity bar; equal kernel scores in ascending id
    order. Returns the largest |Δ| over the compared slots."""
    v1, i1 = v1.cpu().numpy(), i1.cpu().numpy()
    v2, i2 = v2.cpu().numpy(), i2.cpu().numpy()
    k = v1.shape[1]
    err = check_topk(v1, i1, v2[:, :k], i2[:, :k], v2[:, k], 0.0, tol, what)
    tie = (v1[:, 1:] == v1[:, :-1]) & np.isfinite(v1[:, 1:])
    if (i1[:, 1:][tie] <= i1[:, :-1][tie]).any():
        fail(f"{what}: equal scores out of id order")
    return err


@contextlib.contextmanager
def recording(calls, names, mods=None):
    """Record every call of the named kernel wrappers made through the
    modules ``mods`` (by default those of the bool and hybrid steps and the
    kNN scan), as (name, args, kwargs, out)."""
    if mods is None:
        from elasticsearch_tpu_torch.ops import knn
        from elasticsearch_tpu_torch.parallel import dist_search
        mods = (dist_search, knn)
    saved = []
    for mod in mods:
        for name in names:
            if not hasattr(mod, name):
                continue
            orig = getattr(mod, name)

            def rec(*args, _name=name, _orig=orig, **kw):
                out = _orig(*args, **kw)
                calls.append((_name, args, kw, out))
                return out

            saved.append((mod, name, orig))
            setattr(mod, name, rec)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def of(calls, name):
    return [c for c in calls if c[0] == name]


def check_recorded_k3(calls, what):
    """Each recorded K3 call's output against its plain version on the same
    inputs, bitwise (no kernel launched); returns the largest error."""
    from elasticsearch_tpu_torch.ops.topk import topk_merge_plain
    err = 0.0
    for _n, args, kw, out in of(calls, "topk_merge"):
        err = max(err, check_bitwise(out, topk_merge_plain(*args, **kw),
                                     f"{what}: K3 topk_merge ({kw})"))
    return err


def knn_inputs(dev, *, n, dim, B, similarity, seed):
    """A one-shard packed corpus with duplicates of row 3 and ``exists``
    holes (some whole tiles), and a batch whose first query is row 3."""
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import \
        prepare_knn_corpus
    rng = np.random.RandomState(seed)
    raw = rng.randn(1, n, dim).astype(np.float32)
    raw[0, 50:60] = raw[0, 3]
    raw[0, n - 9] = raw[0, 3]
    exists = rng.rand(1, n) > 0.15
    exists[0, n // 2: n // 2 + 4096] = False
    exists[0, 3] = exists[0, 50:60] = exists[0, n - 9] = True
    vecs, vn = prepare_knn_corpus(raw, similarity)
    vecs[~exists] = 0.0
    vn[~exists] = 0.0
    q = rng.randn(B, dim).astype(np.float32)
    q[0] = raw[0, 3]
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) \
        if similarity == "cosine" else q
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (vecs, vn, exists, qq.astype(np.float32),
                   np.sum(q * q, axis=1).astype(np.float32))]
    return t, knn_tol(q, float(np.linalg.norm(raw, axis=-1).max()),
                      similarity)


def run_knn_exact(card, *, reps=20):
    """Phase 9: the exact kNN route at the GloVe shape through ``serve``.
    Returns the K6 row of the ``kernels`` line, the path's launch counts
    and K3's largest error."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.knn import (
        knn_scan_partials, knn_shard_scan, knn_shard_scan_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, _knn_blocking, _packed_queries, knn_step)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rng = np.random.RandomState(1234)
    corpus = rng.randn(KNN_ROWS, KNN_DIM).astype(np.float32)
    batches = [rng.randn(KNN_BATCH, KNN_DIM).astype(np.float32)
               for _ in range(1 + KNN_BATCHES)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = DistributedKnnPlane([dict(vectors=corpus)], similarity="cosine",
                                device=dev)
    plane._device_arrays()
    torch.cuda.synchronize()
    print(f"# knn corpus: {KNN_ROWS} x {KNN_DIM} randn ({gen_s:.1f} s); "
          f"plane n_pad {plane.n_pad}, "
          f"{plane.device_corpus_bytes() / 2**30:.3f} GiB on {dev} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- K6 and every K3 call of the step against their plain versions ---
    vecs, vn, exists = plane._device_arrays()
    S, n_pad = plane.n_shards, plane.n_pad
    q = torch.from_numpy(batches[1]).to(dev)
    qq = _packed_queries(q, "cosine")
    qn = torch.sum(q * q, dim=-1)
    kk = min(KNN_K, n_pad)
    blk, use_blocks = _knn_blocking(plane.block, n_pad, kk)
    tol = knn_tol(batches[1], 1.0, "cosine")
    B = KNN_BATCH
    rec = []
    with recording(rec, ("topk_merge",)):
        knn_step(vecs, vn, exists, q, n_pad=n_pad, k=KNN_K,
                 similarity="cosine", block=plane.block)
    k3_err = check_recorded_k3(rec, "knn_exact")
    k3_calls = [(a, kw) for _n, a, kw, _o in rec]
    k6_v, k6_i = knn_shard_scan(vecs, vn, exists, qq, qn,
                                similarity="cosine", kk=kk)
    plain_kw = dict(similarity="cosine", kk=kk, blk=blk,
                    use_blocks=use_blocks)
    ref_v, ref_i = knn_shard_scan_plain(vecs, vn, exists, qq, qn,
                                        **dict(plain_kw, kk=kk + 1))
    k6_err = check_lists(k6_v[:, 0], k6_i[:, 0], ref_v[:, 0], ref_i[:, 0],
                         tol, "K6 knn_scan (GloVe shape)")
    C = knn_scan_partials(vecs, vn, exists, qq, qn, l2=False,
                          kk=kk)[0].shape[2]
    print(f"# knn_exact (B={B}, k={KNN_K}, {C} chunks): K6 ~= plain (max abs "
          f"err {k6_err:.3g}, tol {tol:.3g}), K3 == plain (its "
          f"{len(k3_calls)} calls of the step)", flush=True)
    for sim in ("dot_product", "l2_norm"):
        ins, stol = knn_inputs(dev, n=KNN_SMALL_ROWS, dim=KNN_DIM, B=B,
                               similarity=sim, seed=9)
        gv, gi = knn_shard_scan(*ins, similarity=sim, kk=KNN_K)
        wv, wi = knn_shard_scan_plain(*ins, similarity=sim, kk=KNN_K + 1)
        err = check_lists(gv[:, 0], gi[:, 0], wv[:, 0], wi[:, 0], stol,
                          f"K6 knn_scan ({sim}, 2^18 rows)")
        row, vals = gi[0, 0].cpu().numpy(), gv[0, 0].cpu().numpy()
        dup = np.isin(row, [3, KNN_SMALL_ROWS - 9] + list(range(50, 60)))
        if dup.sum() < 2 or len(set(vals[dup].view(np.int32).tolist())) != 1:
            fail(f"K6 ({sim}): duplicate rows do not tie bitwise")
        k6_err = max(k6_err, err)
        print(f"# K6 ({sim}, {KNN_SMALL_ROWS} rows, duplicates and holes) ~= "
              f"plain (max abs err {err:.3g}, tol {stol:.3g}); "
              f"{int(dup.sum())} duplicates tie bitwise in row order",
              flush=True)

    # ---- the route through serve, counted alone -------------------------
    lat, st, counts, n_disp, (vals, hits) = drive(
        plane, batches, lambda qs, stg: plane.serve(qs, k=KNN_K, stages=stg),
        kb, required=("knn_scan", "topk_merge"))
    if len(k3_calls) != KNN_K3_CALLS or counts["knn_scan"] != n_disp or \
            counts["topk_merge"] != KNN_K3_CALLS * n_disp:
        fail(f"knn_exact: launches {counts} over {n_disp} dispatches, "
             f"{len(k3_calls)} K3 calls in the checked step")
    n_q = len(lat) * KNN_BATCH
    print(f"# knn_exact: {n_q / lat.sum():.1f} q/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms per {KNN_BATCH}-query "
          f"batch over {len(lat)} batches [{card}]", flush=True)
    print("# knn_exact stages (mean ms): " + ", ".join(
        f"{key} {v / len(lat):.3f}" for key, v in st.items()))
    print(f"# knn_exact launches over {n_disp} dispatches: {counts}",
          flush=True)

    # ---- every query of the first timed batch against numpy --------------
    fn = corpus / np.maximum(np.linalg.norm(corpus, axis=1, keepdims=True),
                             1e-12)
    qb = batches[1]
    qn_h = qb / np.maximum(np.linalg.norm(qb, axis=1, keepdims=True), 1e-12)
    sc = qn_h @ fn.T
    for qi in range(KNN_BATCH):
        top = np.argpartition(-sc[qi], KNN_K + 1)[:KNN_K + 1]
        top = top[np.lexsort((top, -sc[qi][top]))]
        got = np.asarray([s * n_pad + d for s, d in hits[qi]])
        if got.size != KNN_K:
            fail(f"knn_exact query {qi}: {got.size} hits")
        check_topk(vals[qi][None], got[None], sc[qi][top[:KNN_K]][None],
                   top[None, :KNN_K], sc[qi][top[KNN_K:]], 0.0, tol,
                   f"knn_exact query {qi} against numpy")
    print(f"# knn_exact: all {KNN_BATCH} queries of a batch agree with numpy "
          f"(matmul + lexsort) within {tol:.3g}", flush=True)
    del fn, sc

    # ---- times ----------------------------------------------------------
    ms = timed(lambda: knn_scan_partials(vecs, vn, exists, qq, qn, l2=False,
                                         kk=kk), reps)
    plain_ms = timed(lambda: knn_shard_scan_plain(vecs, vn, exists, qq, qn,
                                                  **plain_kw), 2)
    k3_ms = timed(lambda: [topk_merge(*a, **kw) for a, kw in k3_calls], reps)
    flat = vecs[0, :plane.n_docs_total]

    def library():
        torch.topk(qq @ flat.T, kk, dim=1)

    lib = timed(library, reps)
    live = int(exists.sum())
    nbytes = live * KNN_DIM * 4 + S * n_pad + B * KNN_DIM * 4 + B * 4 \
        + B * S * kk * 8
    bms, bby = bound(nbytes, 2 * B * live * KNN_DIM)
    print(f"# knn_scan: {ms:.4f} ms (bound {bms:.4f} ms by {bby}: {live} "
          f"live rows of {S * n_pad}, {nbytes} bytes), plain {plain_ms:.3f} "
          f"ms, library (fp32 matmul + torch.topk) {lib:.4f} ms; K3's "
          f"{len(k3_calls)} calls {k3_ms:.4f} ms [{card}]", flush=True)
    per_sm, ring = (kb.query("knn_scan", f"es_knn_scan_{q}", B, KNN_DIM,
                             kk) for q in ("blocks_per_sm", "ring"))
    print(f"# knn_scan launch: {C} chunks, {per_sm} blocks an SM, a ring "
          f"of {ring // 100} stages of {ring % 100} values", flush=True)
    row = dict(name="knn_scan", route="cuda",
               source="elasticsearch_tpu_torch/csrc/knn_scan.cu",
               replaces="elasticsearch_tpu/parallel/dist_search.py:323",
               max_abs_err=k6_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=bby, library_ms=lib, chunks=C,
               blocks_per_sm=per_sm, ring_stages=ring // 100,
               stage_values=ring % 100)
    return row, counts, k3_err


def plain_ivf_route(plane, prep):
    """The IVF step of one prepared dispatch through the plain versions
    (on the card): the window, the re-rank, K3's final and cross-shard
    top-k. Returns (vals, hits) as ``serve`` does."""
    import torch
    from elasticsearch_tpu_torch.ops.knn import (ivf_rerank_plain,
                                                 ivf_scan_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge_plain
    from elasticsearch_tpu_torch.parallel.dist_search import _packed_queries
    a = prep["args"]
    S, n_pad = plane.n_shards, plane.n_pad
    l2 = plane.similarity == "l2_norm"
    qq = _packed_queries(a["q"], plane.similarity)
    qsum, qn = qq.sum(-1), torch.sum(a["q"] * a["q"], dim=-1)
    wv, wp = ivf_scan_plain(a["codes"], a["scale"], a["off"], a["rowid"],
                            a["rcl"], a["vnorm2"], qq, qsum, qn, a["probed"],
                            a["u_blocks"], l2=l2, n_pad=n_pad,
                            r_cand=prep["r_cand"])
    ex, rows = ivf_rerank_plain(wv, wp, a["u_blocks"], a["rowid"], a["vecs"],
                                a["vnorm2"], qq, qn, l2=l2, n_pad=n_pad)
    B, _, R = ex.shape
    kk = min(prep["k"], n_pad)
    v, i = topk_merge_plain(ex.view(B * S, R), rows.view(B * S, R), k=kk,
                            fill_id=n_pad)
    v, i = topk_merge_plain(v.view(B, S * kk), i.view(B, S * kk),
                            k=min(prep["k"], S * kk), fill_id=S * n_pad,
                            seg_len=kk, seg_stride=n_pad)
    from elasticsearch_tpu_torch.parallel.dist_search import decode_hits
    vals = v.cpu().numpy()
    return vals, decode_hits(vals, i.cpu().numpy(), plane.n_pad)


def recall(got_hits, exact_hits):
    return float(np.mean([len(set(g) & set(e)) / max(len(e), 1)
                          for gb, eb in zip(got_hits, exact_hits)
                          for g, e in zip(gb, eb)]))


def ivf_plane(dev):
    """``bench_knn_ivf``'s corpus (2^20 x 64 rows around 2048 centers,
    seed 1234) in an IVF plane on ``dev`` (nlist 1024, cosine): (the
    corpus, the plane, the corpus's and the pack's seconds, a function
    drawing the next batch of queries, perturbed corpus rows, from the
    corpus's generator)."""
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedKnnPlane
    t0 = time.perf_counter()
    rng = np.random.RandomState(1234)
    centers = rng.randn(IVF_CENTERS, IVF_DIM).astype(np.float32)
    corpus = np.empty((IVF_ROWS, IVF_DIM), np.float32)
    for lo in range(0, IVF_ROWS, 1 << 17):
        n = min(1 << 17, IVF_ROWS - lo)
        corpus[lo: lo + n] = centers[rng.randint(0, IVF_CENTERS, n)] \
            + 0.35 * rng.randn(n, IVF_DIM).astype(np.float32)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = DistributedKnnPlane([dict(vectors=corpus)], similarity="cosine",
                                ivf=dict(nlist=IVF_NLIST, seed=7),
                                device=dev)
    pack_s = time.perf_counter() - t0
    plane.ivf.device_arrays(dev, plane.n_pad)
    plane._device_arrays()
    torch.cuda.synchronize()

    def q_batch():
        qi = rng.randint(0, IVF_ROWS, KNN_BATCH)
        return (corpus[qi] + 0.15 * rng.randn(KNN_BATCH, IVF_DIM)).astype(
            np.float32)

    return corpus, plane, gen_s, pack_s, q_batch


def ivf_step_inputs(plane, qb, k=IVF_K):
    """One IVF dispatch's inputs at the tier's default nprobe and rerank:
    (the step's arguments, r_cand, the union width, the packed queries,
    their squared norms, K7's inputs and keywords)."""
    import torch
    from elasticsearch_tpu_torch.parallel.dist_search import (
        IVF_DEFAULT_RERANK, _packed_queries)
    prep = plane.prepare_ivf(qb, k, nprobe=plane.ivf.default_nprobe,
                             rerank=IVF_DEFAULT_RERANK)
    a = prep["args"]
    qq = _packed_queries(a["q"], "cosine")
    qsum, qn = qq.sum(-1), torch.sum(a["q"] * a["q"], dim=-1)
    scan_in = (a["codes"], a["scale"], a["off"], a["rowid"], a["rcl"],
               a["vnorm2"], qq, qsum, qn, a["probed"], a["u_blocks"])
    return (a, prep["r_cand"], prep["Pw"], qq, qn, scan_in,
            dict(l2=False, n_pad=plane.n_pad))


def run_knn_ivf(card, *, reps=20):
    """Phase 10: the IVF route at ``bench_knn_ivf``'s shape through
    ``serve``. Returns the K7 and K8 rows of the ``kernels`` line, the
    path's launch counts and K3's largest error."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.knn import (
        ivf_rerank, ivf_rerank_plain, ivf_scan, ivf_scan_plain, window_rows)
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    from elasticsearch_tpu_torch.parallel.dist_search import (
        IVF_DEFAULT_RERANK, _assign_clusters, ivf_knn_step,
        prepare_knn_corpus)

    dev = torch.device("cuda")
    corpus, plane, gen_s, pack_s, q_batch = ivf_plane(dev)
    tier = plane.ivf
    print(f"# ivf corpus: {IVF_ROWS} x {IVF_DIM} around {IVF_CENTERS} "
          f"centers ({gen_s:.1f} s); pack (k-means on the card, assignment, "
          f"int8 quantization, reorder) {pack_s:.1f} s; nlist {tier.nlist}, "
          f"{tier.n_blocks} blocks of {tier.block}, "
          f"{plane.device_corpus_bytes() / 2**30:.3f} GiB on {dev}",
          flush=True)
    idx = np.random.RandomState(7).choice(IVF_ROWS, ASSIGN_SAMPLE,
                                          replace=False)
    x = prepare_knn_corpus(corpus[idx], "cosine")[0]
    a_dev = _assign_clusters(x, tier.centroids, False, device=dev)
    a_host = _assign_clusters(x, tier.centroids, False, device="cpu")
    n_diff = int((a_dev != a_host).sum())
    print(f"# card vs numpy _assign_clusters on {ASSIGN_SAMPLE} packed rows: "
          f"{n_diff} rows in another cluster", flush=True)

    eval_b = [q_batch() for _ in range(IVF_EVAL)]
    batches = eval_b + [q_batch() for _ in range(IVF_BATCHES - IVF_EVAL)]
    nprobe = tier.default_nprobe
    S, n_pad = plane.n_shards, plane.n_pad

    # ---- K7, K8 and every K3 call of the step against their plain versions
    a, R, Pw, qq, qn, scan_in, scan_kw = ivf_step_inputs(plane, eval_b[0])
    tol = knn_tol(eval_b[0], 1.0, "cosine")
    B = KNN_BATCH
    rec = []
    with recording(rec, ("topk_merge",)):
        ivf_knn_step(**a, n_pad=n_pad, k=IVF_K, similarity="cosine",
                     nlist=tier.nlist, r_cand=R)
    k3_err = check_recorded_k3(rec, "knn_ivf")
    k3_calls = [(a, kw) for _n, a, kw, _o in rec]
    wv, wp = ivf_scan(*scan_in, **scan_kw, nlist=tier.nlist, r_cand=R)
    pv, pp = ivf_scan_plain(*scan_in, **scan_kw, r_cand=R + 1)
    # the window's values: the dequantized dot differs from the plain
    # product by its summation order, within the parity bar
    k7_err = check_lists(wv[:, 0], wp[:, 0], pv[:, 0], pp[:, 0], tol,
                         "K7 ivf_scan (the window)")
    # the windows serve(k=IVF_DEEP_K) and serve(k=IVF_DEEPEST_K) ask for,
    # past K7's window path: its deep path, one call, no K3
    deep = {}
    for kd in (IVF_DEEP_K, IVF_DEEPEST_K):
        _a, R_d, _p, _q, _n, d_in, d_kw = ivf_step_inputs(plane, eval_b[0],
                                                          k=kd)
        n0 = dict(kb.launches)
        dv, dp = ivf_scan(*d_in, **d_kw, nlist=tier.nlist, r_cand=R_d)
        torch.cuda.synchronize()
        launched = {key: kb.launches[key] - n0[key]
                    for key in ("ivf_scan", "topk_merge")}
        if launched != {"ivf_scan": 1, "topk_merge": IVF_DEEP_WINDOW_K3}:
            fail(f"K7 deep path at r_cand {R_d}: launches {launched}")
        dpv, dpp = ivf_scan_plain(*d_in, **d_kw, r_cand=R_d + 1)
        err = check_lists(dv[:, 0], dp[:, 0], dpv[:, 0], dpp[:, 0], tol,
                          f"K7 ivf_scan (deep path, r_cand {R_d})")
        # the whole IVF step at this k: K3's calls (the window needs none)
        n0 = kb.launches["topk_merge"]
        ivf_knn_step(**_a, n_pad=n_pad, k=kd, similarity="cosine",
                     nlist=tier.nlist, r_cand=R_d)
        torch.cuda.synchronize()
        k3_step = kb.launches["topk_merge"] - n0
        if k3_step != IVF_K3_CALLS + IVF_DEEP_WINDOW_K3:
            fail(f"IVF step at k = {kd}: {k3_step} K3 calls, not "
                 f"{IVF_K3_CALLS + IVF_DEEP_WINDOW_K3}")
        deep[kd] = dict(k=kd, r_cand=R_d, launches=launched,
                        k3_calls_a_step=k3_step, max_abs_err=err,
                        inputs=(d_in, d_kw),
                        live=int(torch.isfinite(dv).sum()))
    rr_in = (wv, wp, a["u_blocks"], a["rowid"], a["vecs"], a["vnorm2"], qq,
             qn)
    ex, rows = ivf_rerank(*rr_in, l2=False, n_pad=n_pad)
    ex_p, rows_p = ivf_rerank_plain(*rr_in, l2=False, n_pad=n_pad)
    if not torch.equal(rows, rows_p):
        fail("K8 ivf_rerank: rows differ from its plain version")
    e, ep = ex.cpu().numpy(), ex_p.cpu().numpy()
    fin = np.isfinite(ep)
    if not np.array_equal(np.isfinite(e), fin) or \
            np.abs(e[fin] - ep[fin]).max(initial=0.0) > tol:
        fail("K8 ivf_rerank: scores differ from its plain version beyond "
             "the parity bar")
    k8_err = float(np.abs(e[fin].astype(np.float64) - ep[fin]).max(
        initial=0.0))
    n_real = int((a["u_blocks"] < tier.n_blocks).sum())
    live = int(np.isfinite(e).sum())
    print(f"# knn_ivf (B={B}, k={IVF_K}, nprobe {nprobe}, rerank "
          f"{IVF_DEFAULT_RERANK}): Pw {Pw}, r_cand {R}, {n_real} "
          f"union blocks scanned of {S * Pw} gathered; K7 ~= plain (max abs "
          f"err {k7_err:.3g}, tol {tol:.3g}), K8 ~= plain (rows equal, max "
          f"abs err {k8_err:.3g}), K3 == plain (its {len(k3_calls)} calls of "
          f"the step); {live} "
          f"window rows re-ranked" + "".join(
              f"; at k = {d['k']} (r_cand {d['r_cand']}, {d['live']} live "
              f"entries) K7's deep path ~= plain (max abs err "
              f"{d['max_abs_err']:.3g}), the step's K3 calls "
              f"{d['k3_calls_a_step']}" for d in deep.values()),
          flush=True)

    # ---- recall against the exact route, kernel and plain ----------------
    exact = [plane.serve(qb, k=IVF_K, nprobe=0)[1] for qb in eval_b]
    plain_hits = [plain_ivf_route(plane, plane.prepare_ivf(
        qb, IVF_K, nprobe=nprobe, rerank=IVF_DEFAULT_RERANK))[1]
        for qb in eval_b]

    # ---- the route through serve, counted alone -------------------------
    docs_scanned = []

    def call(qs, stg):
        out = plane.serve(qs, k=IVF_K, stages=stg)
        docs_scanned.append(stg["docs_scanned"])
        return out

    ivf_hits = [plane.serve(qb, k=IVF_K)[1] for qb in eval_b]
    lat, st, counts, n_disp, _ = drive(
        plane, [eval_b[0]] + batches, call, kb,
        required=("ivf_scan", "ivf_rerank", "topk_merge"),
        stage_keys=("prep_ms", "dispatch_ms", "fetch_ms",
                    "ann_quantized_bytes", "ann_exact_bytes"))
    if len(k3_calls) != IVF_K3_CALLS or \
            counts["topk_merge"] != IVF_K3_CALLS * n_disp:
        fail(f"knn_ivf: launches {counts} over {n_disp} dispatches, "
             f"{len(k3_calls)} K3 calls in the checked step")
    n_q = len(lat) * KNN_BATCH
    r_kernel, r_plain = recall(ivf_hits, exact), recall(plain_hits, exact)
    print(f"# knn_ivf: {n_q / lat.sum():.1f} q/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms per {KNN_BATCH}-query "
          f"batch over {len(lat)} batches [{card}]", flush=True)
    print("# knn_ivf stages (mean): " + ", ".join(
        f"{key} {v / len(lat):.3f}" for key, v in st.items())
        + f", docs_scanned {np.mean(docs_scanned):.1f}")
    print(f"# knn_ivf launches over {n_disp} dispatches: {counts}",
          flush=True)
    print(f"# knn_ivf recall@{IVF_K} against the exact route on {IVF_EVAL} "
          f"batches: kernels {r_kernel:.4f}, plain versions {r_plain:.4f}",
          flush=True)
    if r_kernel < r_plain:
        fail(f"IVF recall {r_kernel} below the plain route's {r_plain}")
    if counts["knn_scan"]:
        fail("K6 launched on the IVF path")
    # deep pages through serve: k = IVF_DEEP_K, its window past K7's window
    # path, counted alone
    lat_d, _st, counts_d, n_disp_d, _ = drive(
        plane, batches[:IVF_DEEP_BATCHES + 1],
        lambda qs, stg: plane.serve(qs, k=IVF_DEEP_K, stages=stg), kb,
        required=("ivf_scan", "ivf_rerank", "topk_merge"))
    if counts_d["topk_merge"] != \
            (IVF_K3_CALLS + IVF_DEEP_WINDOW_K3) * n_disp_d:
        fail(f"knn_ivf at k = {IVF_DEEP_K}: launches {counts_d} over "
             f"{n_disp_d} dispatches")
    deep_serve = dict(k=IVF_DEEP_K, batches=len(lat_d),
                      qps=len(lat_d) * KNN_BATCH / lat_d.sum(),
                      p50_ms=float(np.percentile(lat_d, 50) * 1e3),
                      launches=counts_d, dispatches=n_disp_d)
    print(f"# knn_ivf at k = {IVF_DEEP_K}: {deep_serve['qps']:.1f} q/s, p50 "
          f"{deep_serve['p50_ms']:.3f} ms per {KNN_BATCH}-query batch over "
          f"{len(lat_d)} batches; launches {counts_d} over {n_disp_d} "
          f"dispatches [{card}]", flush=True)

    # ---- times ----------------------------------------------------------
    # the window (K7's one call on the path) and, beside it, the deep
    # path's windows
    k7_ms = timed(lambda: ivf_scan(*scan_in, **scan_kw, nlist=tier.nlist,
                                   r_cand=R), reps)
    k7_dev = device_ms_by_name(lambda: ivf_scan(
        *scan_in, **scan_kw, nlist=tier.nlist, r_cand=R), reps)
    for d in deep.values():
        d_in, d_kw = d.pop("inputs")

        def deep_window(d_in=d_in, d_kw=d_kw, R_d=d["r_cand"]):
            ivf_scan(*d_in, **d_kw, nlist=tier.nlist, r_cand=R_d)
        d["ms"] = timed(deep_window, reps)
        d["device_ms"] = sum(device_ms_by_name(deep_window, reps).values())
        d["plain_ms"] = timed(lambda d_in=d_in, d_kw=d_kw, R_d=d["r_cand"]:
                              ivf_scan_plain(*d_in, **d_kw, r_cand=R_d), 3)
    k8_ms = timed(lambda: ivf_rerank(*rr_in, l2=False, n_pad=n_pad), reps)
    k7_plain = timed(lambda: ivf_scan_plain(*scan_in, **scan_kw, r_cand=R), 3)
    k8_plain = timed(lambda: ivf_rerank_plain(*rr_in, l2=False, n_pad=n_pad),
                     3)
    k3_ms = timed(lambda: [topk_merge(*x, **kw) for x, kw in k3_calls],
                  reps)
    safe = window_rows(wp, a["u_blocks"], a["rowid"]).clamp(
        0, n_pad - 1).long()[:, 0]
    vec0 = a["vecs"][0]

    def k8_library():
        torch.bmm(vec0[safe], qq[:, :, None])

    k8_lib = timed(k8_library, reps)
    # the device time a call, beside the CUDA-event means (which read the
    # host's time too where it is the longer)
    k8_dev, k8_lib_dev = (
        sum(device_ms_by_name(f, reps).values())
        for f in (lambda: ivf_rerank(*rr_in, l2=False, n_pad=n_pad),
                  k8_library))
    # K7's work: the rowid and rcl of each row of a real union block (the
    # sentinel block NB is all padding); the codes, scale and off of a row
    # some query of the batch probes; per (row, query) pair a D-long dot
    # (2 ops a term) and the dequantization (3 ops); the window written
    rcl = a["rcl"][0][a["u_blocks"][0].long()].reshape(-1)
    member = (rcl[None, :, None] == a["probed"][:, None, :]).any(-1)
    pairs = int(member.sum())
    rows_read = int(member.any(0).sum())
    k7_bytes = n_real * tier.block * 8 + rows_read * (IVF_DIM + 8) \
        + a["probed"].numel() * 4 + a["u_blocks"].numel() * 4 + B * 8 \
        + B * S * R * 8
    k7_bms, k7_bby = bound(k7_bytes, pairs * (2 * IVF_DIM + 3))
    # a deep window reads the same union and writes its own width
    for d in deep.values():
        d["bound_ms"], d["bound_by"] = bound(
            k7_bytes + B * S * (d["r_cand"] - R) * 8,
            pairs * (2 * IVF_DIM + 3))
    k8_bytes = live * (8 + 4 + 4 + IVF_DIM * 4 + 8) + B * IVF_DIM * 4
    k8_bms, k8_bby = bound(k8_bytes, live * 2 * IVF_DIM)
    print(f"# ivf_scan (the window): {k7_ms:.4f} ms, on the card "
          f"{sum(k7_dev.values()):.5f} ms {k7_dev} (bound {k7_bms:.5f} ms "
          f"by {k7_bby}: {n_real} real union blocks, {rows_read} probed "
          f"rows read, {pairs} (row, query) pairs, {k7_bytes} bytes), "
          + "".join(f"at r_cand {d['r_cand']} (deep path) {d['ms']:.4f} "
                    f"ms, on the card {d['device_ms']:.5f} ms (bound "
                    f"{d['bound_ms']:.5f} ms by {d['bound_by']}), plain "
                    f"{d['plain_ms']:.3f} ms, " for d in deep.values())
          + f"plain {k7_plain:.3f} ms; ivf_rerank: "
          f"{k8_ms:.4f} ms (bound {k8_bms:.5f} ms by {k8_bby}), plain "
          f"{k8_plain:.3f} ms, library (gather + torch.bmm) {k8_lib:.4f} ms; "
          f"on the card (torch.profiler) K8 {k8_dev:.5f} ms, the library "
          f"{k8_lib_dev:.5f} ms; "
          f"K3's {len(k3_calls)} calls {k3_ms:.4f} ms [{card}]", flush=True)
    rows_out = [
        dict(name="ivf_scan", route="cuda",
             source="elasticsearch_tpu_torch/csrc/ivf_scan.cu",
             replaces="elasticsearch_tpu/parallel/dist_search.py:798",
             max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain,
             bound_ms=k7_bms, bound_by=k7_bby, library_ms=None,
             library_none="no one PyTorch call scans a gathered union "
                          "under per-query cluster masks into a window",
             device_ms=sum(k7_dev.values()), device_ms_by_kernel=k7_dev,
             deep_path=list(deep.values()), deep_serve=deep_serve),
        dict(name="ivf_rerank", route="cuda",
             source="elasticsearch_tpu_torch/csrc/ivf_rerank.cu",
             replaces="elasticsearch_tpu/parallel/dist_search.py:894",
             max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain,
             bound_ms=k8_bms, bound_by=k8_bby, library_ms=k8_lib,
             device_ms=k8_dev, library_device_ms=k8_lib_dev,
             library_note="the yardstick gathers rows found before the "
                          "timed call: it leaves out the window-to-row "
                          "mapping (u_blocks, rowid) and the -inf mask "
                          "that K8 does in each call")]
    return rows_out, counts, k3_err


# ---------------------------------------------------------------------------
# bool trees (config #2) and the one-dispatch hybrid (config #5)
# ---------------------------------------------------------------------------

#: bool trees on the prune phase's plane: batches of 16 at k = 10, 16
#: timed batches per mix after one warm-up
BOOL_BATCH = 16
BOOL_BATCHES = 16
#: the rescore checks: 2 rescore terms, window 50, qw 0.7, rw 1.3, over a
#: ranking of 100 (``rank_window_size``)
RESCORE = dict(qw=0.7, rw=1.3, window=50)
RESCORE_TERMS = 2
RESCORE_WT = 100
RESCORE_MODES = ("total", "multiply", "avg", "max", "min")
#: BEIR/NQ (Thakur et al. 2021, Table 1): 2,681,468 passages of 78.9
#: words on average, queries of 9.2 words; 768-d dot-product vectors
HY_DOCS = 2_681_468
HY_AVG_DL = 79
HY_DIM = 768
HY_TERMS = 9
HY_BATCH = 16
HY_BATCHES = 24
HY_WINDOW = 100              # Elasticsearch's rank_window_size default
HY_SORT_WINDOW = 300         # a rank window past 256: K10 sorts
HY_SORT_SYNTH = 10_000       # synthetic windows: K10 sorts in device memory
HY_RC = 60.0                 # and its rank_constant
HY_EVAL = 4
#: relative separation of the fused RRF scores (f32 on the card, f64 in
#: the host fusion)
RRF_RTOL = 1e-6


def exact_bool(corpus, bq, k):
    """Numpy term-at-a-time scoring of a lowered bool tree over the whole
    corpus (f64 BM25 of the scoring clauses, clause bits per doc, the
    bool eligibility): (top k+1 docs, their scores, the eligible mask)."""
    offsets, docs, tf = corpus["offsets"], corpus["docs"], corpus["tf"]
    dl = corpus["doc_len"]
    n_docs = dl.shape[0]
    avgdl = dl.mean()
    df = corpus["df"]
    scores = np.zeros(n_docs, np.float64)
    bits = np.zeros(n_docs, np.int32)
    req = neg = shd = 0
    for ci, (role, terms) in enumerate(bq["clauses"]):
        bit = 1 << ci
        if role in ("must", "filter"):
            req |= bit
        elif role == "must_not":
            neg |= bit
        else:
            shd |= bit
        for t in set(terms):
            tid = int(t[1:])
            st, en = offsets[tid], offsets[tid + 1]
            if en == st:
                continue
            run_docs = docs[st:en]
            bits[run_docs] |= bit
            if role in ("must", "should"):
                run_tf = tf[st:en].astype(np.float64)
                idf = np.log(1 + (n_docs - df[tid] + 0.5) / (df[tid] + 0.5))
                norm = run_tf + K1 * (1 - B_BM25 + B_BM25 * dl[run_docs]
                                      / avgdl)
                scores[run_docs] += terms.count(t) * idf * (K1 + 1) \
                    * run_tf / norm
    sb = bits & shd & 0xFF
    n_should = np.zeros(n_docs, np.int32)
    for ci in range(8):
        n_should += (sb >> ci) & 1
    elig = ((bits & req) == req) & ((bits & neg) == 0) & \
        (n_should >= bq["msm"])
    sc = np.where(elig, scores, -np.inf)
    top = np.argpartition(-sc, k + 1)[:k + 1]
    top = top[np.lexsort((top, -sc[top]))]
    return top, sc[top], elig


def check_bool_exact(corpus, plane, bqs, vals, hits, totals, label, k=K):
    """The first ``REF_QUERIES`` trees against :func:`exact_bool`: every
    hit eligible, min(k, eligible) hits, scores within REF_RTOL, docs
    equal where separated, totals exact."""
    for qi in range(REF_QUERIES):
        top, sc, elig = exact_bool(corpus, bqs[qi], k)
        n_match = int(elig.sum())
        n = min(k, n_match)
        got = [s * plane.n_pad + d for s, d in hits[qi]]
        if not all(elig[d] for d in got):
            fail(f"{label} query {qi}: a hit that is not eligible")
        row = np.asarray(vals[qi], np.float64)
        if len(got) != n or not np.isneginf(row[n:]).all():
            fail(f"{label} query {qi}: {len(got)} hits, expected {n}")
        check_topk(row[None, :n], np.asarray([got]), sc[None, :n],
                   top[None, :n], sc[n:n + 1], REF_RTOL, 0.0,
                   f"{label} query {qi} against the exact reference")
        if totals[qi] != n_match:
            fail(f"{label} query {qi}: total {totals[qi]} != exact "
                 f"{n_match}")
    print(f"# {label}: {REF_QUERIES} trees agree with the exact reference "
          f"(clause membership, scores within {REF_RTOL:.0%}, totals exact)",
          flush=True)


def bool_args(a):
    return [a[n] for n in ("postings_docs", "postings_impact", "starts",
                           "lengths", "idfw", "cbits", "req", "neg", "shd",
                           "msm")]


def check_k9(args, kw, label, got=None, chunk=FALLBACK_CHUNK):
    """K9's outputs (``got``, else a launch) against its plain version,
    bitwise, a few queries per plain call (the plain version holds Q·L
    entries a query). Returns the outputs and the plain version's time
    over the batch (ms)."""
    import torch
    from elasticsearch_tpu_torch.ops.fused_query import (
        bool_bm25_topk, bool_bm25_topk_plain)
    if got is None:
        got = bool_bm25_topk(*args, **kw)
    B = args[2].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(0, B, chunk):
        part = [x[j:j + chunk].contiguous() for x in args[2:]]
        want = bool_bm25_topk_plain(*args[:2], *part, **kw)
        mine = [x[j:j + chunk] for x in got]
        if not all(same_bits(x, y) for x, y in zip(mine, want)):
            fail(f"{label}: K9 bool_bm25_topk differs from its plain "
                 f"version")
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def k9_work(plane, args, k):
    """Bytes and f32 operations K9 needs: each valid posting read once (doc
    and impact), the slot tables (starts, lengths, idfw, clause bits) and
    masks, the lists and counts written; a product per posting and an add
    per posting that joins an owner's group."""
    import torch
    docs, _imp, starts, lengths = args[:4]
    B, S, Q = starts.shape
    st, ln = starts.cpu().numpy(), lengths.cpu().numpy()
    n_post = int(ln.sum())
    n_owner = 0
    for b in range(B):
        for s in range(S):
            runs = [docs[s, int(st[b, s, q]): int(st[b, s, q])
                         + int(ln[b, s, q])]
                    for q in range(Q) if ln[b, s, q]]
            if runs:
                n_owner += int(torch.unique(torch.cat(runs)).numel())
    nbytes = 8 * n_post + B * Q * 8 + B * S * Q * 8 + 16 * B \
        + B * S * (8 * k + 4)
    return nbytes, n_post + (n_post - n_owner), n_post, n_owner


def k9_launch(args, kw):
    """K9's launch on these inputs: its plan (docs a tile, blocks a (query,
    shard), tiles a block, tiles of edges at a time), blocks in the grid
    and blocks of the tile kernel an SM holds."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import bool_bm25_topk_plan
    B, S, Q = args[2].shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bool_bm25_topk_plan(kw["n_pad"], B, S, Q, kw["L"], kw["k"], n_sm)
    per_sm = kb.query("bool_bm25_topk", "es_bool_bm25_topk_blocks_per_sm",
                      Q, kw["k"], plan["tile_shift"], plan["edge_tiles"])
    return dict(tile=plan["tile"], G=plan["G"],
                tiles_per_block=plan["tiles_per_block"],
                edge_tiles=plan["edge_tiles"], blocks=B * S * plan["G"],
                blocks_per_sm=per_sm)


def k9_device_ms(call, n_disp):
    """K9's device ms a dispatch (its tile and merge kernels) over one
    ``call`` that serves ``n_disp`` dispatches, by ``torch.profiler``."""
    by = device_ms_by_name(call, 1)
    if not by:
        fail("torch.profiler recorded no device event")
    return sum(v for name, v in by.items() if "K9Bool" in name) / n_disp


def k11_work(args, k):
    """K11 reads each entry's value, id, secondary and match flag once,
    the per-query weights and window, and writes k (value, id) pairs;
    three f32 operations an entry at most."""
    vals = args[0]
    B, n = vals.shape
    return B * n * 13 + B * 12 + B * k * 8, 3 * B * n


def bool_traffic(corpus, n_batches=BOOL_BATCHES):
    """The bool phase's trees over the prune corpus, terms ∝ df over df >=
    2 (seed 1234): mixes (c) (``bench_bool_disjunction``'s 8-term should
    clause) and (d) (the lowered shape of a must / should / filter /
    must_not tree), each a warm-up batch and ``n_batches`` timed ones;
    a batch of trees with three should clauses at msm 2; and the draw
    function, which goes on drawing from the same generator."""
    rng = np.random.RandomState(1234)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    p = df[el] / df[el].sum()

    def draw(m):
        return [f"t{t}" for t in rng.choice(el, m, p=p)]

    mixes = {
        "c": [[{"clauses": [("should", draw(8))], "msm": 1}
               for _ in range(BOOL_BATCH)] for _ in range(1 + n_batches)],
        "d": [[{"clauses": [("must", draw(1)), ("should", draw(3)),
                            ("filter", draw(1)), ("must_not", draw(1))],
                "msm": 0} for _ in range(BOOL_BATCH)]
              for _ in range(1 + n_batches)]}
    extra = [{"clauses": [("must", draw(1)), ("should", draw(2)),
                          ("should", draw(2)), ("should", draw(2)),
                          ("filter", draw(1)), ("must_not", draw(1))],
              "msm": 2} for _ in range(BOOL_BATCH)]
    return mixes, extra, draw


def run_bool(card, plane, corpus, *, n_batches=BOOL_BATCHES, reps=20):
    """Phase 8: bool trees (config #2) through ``serve_bool`` on the prune
    phase's plane. Returns K9's row, K11's bool timing and the path's
    launch counts."""
    import torch
    from elasticsearch_tpu_torch.ops.fused_query import K11_COUNT_MAX
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import (
        bisect_exact_scores, bisect_exact_scores_plain, bool_bm25_topk,
        rescore_reorder, rescore_reorder_body)
    from elasticsearch_tpu_torch.ops.topk import topk_merge_plain
    from elasticsearch_tpu_torch.search.query_planner import \
        bool_rescore_device

    mixes, extra, draw = bool_traffic(corpus, n_batches)
    kk = min(K, plane.n_pad)

    # ---- K9 and K3 against their plain versions, one batch a mix ----------
    chk = {}
    for m, qs in list(mixes.items()) + [("d, msm 2", [None, extra])]:
        prep = plane.prepare_bool(qs[1])
        args = bool_args(prep["args"])
        kw = dict(n_pad=plane.n_pad, L=prep["L"], k=kk)
        got, plain_ms = check_k9(args, kw, f"bool mix ({m})")
        calls = []
        with recording(calls, ("topk_merge",)):
            out = plane.search_bool(qs[1], k=K, with_totals=True)
        check_recorded_k3(calls, f"bool ({m})")
        chk[m] = dict(prep=prep, args=args, kw=kw, plain_ms=plain_ms,
                      out=out)
        print(f"# bool mix ({m}) (Q={prep['Q']}, L={prep['L']}): K9 == "
              f"plain (bitwise), K3 == plain; plain K9 {plain_ms:.1f} ms",
              flush=True)
    check_bool_exact(corpus, plane, extra, *chk["d, msm 2"]["out"],
                     "bool mix (d), 3 should clauses at msm 2")

    # ---- mix (c) against plane.search of the same bags (the K1 path) -------
    qs = mixes["c"][1]
    bags = [bq["clauses"][0][1] for bq in qs]
    shape = plane.serving_shape(bags)
    pb = chk["c"]["prep"]
    st, ln, iw = plane._lookup(bags, shape["Q"])[:3]
    np.minimum(ln, shape["L"], out=ln)
    same_in = (shape["Q"] == pb["Q"] and shape["L"] == pb["L"] and all(
        np.array_equal(x, pb["args"][n].cpu().numpy())
        for x, n in ((st, "starts"), (ln, "lengths"), (iw, "idfw"))))
    if not same_in:
        fail("mix (c): _lookup and bool_inputs assign different slots")
    ev, eh, et = plane.search(bags, k=K, **shape, with_totals=True)
    bv, bh, bt = chk["c"]["out"]
    if not (same_bits(torch.from_numpy(np.asarray(ev, np.float32)),
                      torch.from_numpy(np.asarray(bv, np.float32)))
            and eh == bh and et == bt):
        fail("mix (c): serve_bool differs from plane.search of the bags")
    print("# bool mix (c) == plane.search of the same bags (the K1 path: "
          "same slots, scores bitwise, hits and totals equal)", flush=True)

    # ---- each mix through serve_bool, counted alone ------------------------
    counts, res = {}, {}
    path = {name: 0 for name in kb.launches}
    for m, batches in mixes.items():
        lat, stg, c, n_disp, first = drive(
            plane, batches,
            lambda b, s: plane.serve_bool(b, k=K, stages=s), kb,
            required=("bool_bm25_topk", "topk_merge"))
        if c["bool_bm25_topk"] != n_disp or c["topk_merge"] != n_disp or \
                c["sparse_candidates_topk"] or c["blockmax_scan"]:
            fail(f"bool mix ({m}): launches {c} over {n_disp} dispatches")
        for name in path:
            path[name] += c[name]
        n_q = len(lat) * BOOL_BATCH
        counts[m], res[m] = c, first
        print(f"# bool mix ({m}): {n_q / lat.sum():.1f} q/s, p50 "
              f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.3f} ms per {BOOL_BATCH}-query"
              f" batch over {len(lat)} batches [{card}]", flush=True)
        print(f"# bool mix ({m}) stages (mean ms): " + ", ".join(
            f"{key} {v / len(lat):.3f}" for key, v in stg.items()))
        print(f"# bool mix ({m}) launches over {n_disp} dispatches: "
              f"{ {n: v for n, v in c.items() if v} }", flush=True)
    for m, batches in mixes.items():
        _, _, totals = plane.serve_bool(batches[1][:REF_QUERIES], k=K,
                                        with_totals=True)
        check_bool_exact(corpus, plane, batches[1], *res[m], totals,
                         f"bool mix ({m})")

    # ---- the rescore stage, one batch a mode --------------------------------
    bqs = mixes["d"][1]
    k11_calls, k5_rec, n_rs = {}, {}, 0
    kb.reset_launches()
    for mode in RESCORE_MODES:
        items = [{"rescore": dict(RESCORE, terms=draw(RESCORE_TERMS))}
                 for _ in bqs]
        calls = []
        with recording(calls, ("bisect_exact_scores", "topk_merge",
                               "rescore_reorder")):
            bool_rescore_device(plane, bqs, items, RESCORE_WT, mode)
        n_rs += 1
        (_n, k5a, k5k, (sec, fnd)), = of(calls, "bisect_exact_scores")
        check_bitwise((sec, fnd), bisect_exact_scores_plain(*k5a, **k5k),
                      f"bool rescore ({mode}): K5")
        k5_rec[mode] = (k5a, k5k)
        (_n, k3a, k3k, k3o), = of(calls, "topk_merge")
        want = topk_merge_plain(*k3a, **k3k)
        check_bitwise(k3o, want, f"bool rescore ({mode}): K3 with sel")
        (_n, k11a, k11k, k11o), = of(calls, "rescore_reorder")
        if k11a[0].shape[1] > K11_COUNT_MAX:
            fail(f"bool rescore ({mode}): K11 took its sorting path")
        B = sec.shape[0]
        sel = want[2].long()
        for x, ch in ((k11a[2], sec), (k11a[3], fnd)):
            if not same_bits(x, torch.gather(ch.reshape(B, -1), 1, sel)):
                fail(f"bool rescore ({mode}): the payload gather differs "
                     f"from the plain selection's")
        check_bitwise(k11o, rescore_reorder_body(*k11a, **k11k),
                      f"bool rescore ({mode}): K11 rescore_reorder")
        k11_calls[mode] = (k11a, k11k)
    c = dict(kb.launches)
    for name in ("bool_bm25_topk", "bisect_exact_scores", "topk_merge",
                 "rescore_reorder"):
        if c[name] != n_rs:
            fail(f"bool rescore: {name} launched {c[name]} times in {n_rs} "
                 f"dispatches")
    for name in path:
        path[name] += c[name]
    print(f"# bool rescore (window {RESCORE['window']}, over "
          f"{RESCORE_WT}): K5, K3 with sel, the payload gather and K11 "
          f"(its counting path, n = {RESCORE_WT}) == plain (bitwise) for "
          f"{', '.join(RESCORE_MODES)}; launches "
          f"{ {n: v for n, v in c.items() if v} } over {n_rs} dispatches",
          flush=True)

    # ---- times ---------------------------------------------------------------
    rows, launches_k9 = {}, {}
    for m in ("c", "d"):
        ck = chk[m]
        nb, nf, n_post, n_owner = k9_work(plane, ck["args"], kk)
        ms = timed(lambda: bool_bm25_topk(*ck["args"], **ck["kw"]), reps)
        bms, bby = bound(nb, nf)
        launch = k9_launch(ck["args"], ck["kw"])
        rows[m] = dict(ms=ms, plain_ms=ck["plain_ms"], bound_ms=bms,
                       bound_by=bby)
        launches_k9[m] = launch
        print(f"# bool_bm25_topk mix ({m}), the checked batch: {ms:.4f} ms "
              f"(bound {bms:.5f} ms by {bby}: {n_post} valid postings, "
              f"{n_owner} candidates, {nb} bytes), plain "
              f"{ck['plain_ms']:.3f} ms; launch {launch} [{card}]",
              flush=True)
    a, kw = k11_calls["total"]
    k11_ms = timed(lambda: rescore_reorder(*a, **kw), reps)
    k11_dev = queued_ms(lambda: rescore_reorder(*a, **kw), reps)
    k11_plain = timed(lambda: rescore_reorder_body(*a, **kw), 3)
    nb, nf = k11_work(a, kw["k"])
    k11_b = bound(nb, nf)
    print(f"# rescore_reorder (bool, total, n={a[0].shape[1]}): "
          f"{k11_ms:.4f} ms (on the card {fmt_ms(k11_dev)}; bound "
          f"{k11_b[0]:.6f} ms by {k11_b[1]}), plain {k11_plain:.3f} ms "
          f"[{card}]", flush=True)
    k9_row = dict(name="bool_bm25_topk", route="cuda",
                  source="elasticsearch_tpu_torch/csrc/bool_bm25_topk.cu",
                  replaces="elasticsearch_tpu/ops/fused_query.py:50",
                  max_abs_err=0.0, **rows["c"], library_ms=None,
                  library_none="no one PyTorch call merges postings runs "
                               "with clause bits",
                  ms_by_path={"bool_c": rows["c"]["ms"],
                              "bool_d": rows["d"]["ms"]},
                  device_ms_per_dispatch={},
                  launch={f"bool_{m}": v for m, v in launches_k9.items()})
    a5, kw5 = k5_rec["total"]
    k11_bool = dict(ms=k11_ms, device_ms=k11_dev, plain_ms=k11_plain,
                    bound_ms=k11_b[0], bound_by=k11_b[1],
                    k5_ms=timed(lambda: bisect_exact_scores(*a5, **kw5),
                                reps),
                    k5_plain_ms=timed(lambda: bisect_exact_scores_plain(
                        *a5, **kw5), 3))
    print(f"# bisect_exact_scores (bool rescore, total, "
          f"R={a5[5].shape[2]}, Q={a5[2].shape[2]}): "
          f"{k11_bool['k5_ms']:.4f} ms, plain "
          f"{k11_bool['k5_plain_ms']:.3f} ms [{card}]", flush=True)
    # K9's device time a dispatch over each mix's timed batches, served
    # again under the profiler after every timing
    for m, batches in mixes.items():
        ms = k9_device_ms(lambda: [plane.serve_bool(b, k=K)
                                   for b in batches[1:]], len(batches) - 1)
        k9_row["device_ms_per_dispatch"][f"bool_{m}"] = ms
        print(f"# bool mix ({m}): K9's device time {ms:.4f} ms a dispatch "
              f"over the {len(batches) - 1} timed batches (torch.profiler) "
              f"[{card}]", flush=True)
    return k9_row, k11_bool, path


def hybrid_corpus(rng, n_docs):
    """The text corpus of the hybrid (``synthetic_csr_corpus_fast`` at
    BEIR/NQ's passage count and length)."""
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    corpus = synthetic_csr_corpus_fast(rng, n_docs, VOCAB, HY_AVG_DL,
                                       zipf_s=1.2)
    corpus["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    return corpus


def hybrid_vectors(n_docs, dim, seed=1234, chunk=1 << 18):
    """``standard_normal`` f32 rows from ``default_rng(seed)``, made in
    chunks."""
    g = np.random.default_rng(seed)
    vecs = np.empty((n_docs, dim), np.float32)
    for lo in range(0, n_docs, chunk):
        hi = min(n_docs, lo + chunk)
        vecs[lo:hi] = g.standard_normal((hi - lo, dim), dtype=np.float32)
    return vecs


def hybrid_traffic(rng, corpus, tplane, dim, n_batches=HY_BATCHES):
    """The hybrid's queries, drawn from ``rng`` after the text corpus: 9
    terms ∝ df over the sparse-tier terms of df >= 2 in one should clause,
    a randn query vector, Elasticsearch's RRF defaults; a warm-up batch
    and ``n_batches`` timed ones. Returns (batches, the eligible terms,
    their draw weights, the dense-tier mask)."""
    sh = tplane.shards[0]
    df = corpus["df"].astype(np.float64)
    dense = np.zeros(df.shape[0], bool)
    dense[list(sh["dense_row_of"])] = True
    el = np.flatnonzero((df >= 2) & ~dense)
    p = df[el] / df[el].sum()

    def fq():
        terms = [f"t{t}" for t in rng.choice(el, HY_TERMS, p=p)]
        return dict(clauses=[("should", terms)], msm=1,
                    qv=rng.randn(dim).astype(np.float32), kboost=1.0,
                    rc=HY_RC, wt=HY_WINDOW, wk=HY_WINDOW, k=K)

    batches = [[fq() for _ in range(HY_BATCH)]
               for _ in range(1 + n_batches)]
    return batches, el, p, dense


def fusion_lists(dev, B, W, seed=17):
    """Two ranked lists of W entries a query as the hybrid's reduces give
    them (text ids ``s · 2^22 + doc``, kNN ids of one shard, a third of
    the kNN list also in the text list, scores descending, ties, ids
    unique in a list) and the fuse_rank inputs around them."""
    import torch
    rng = np.random.RandomState(seed)
    n_pad = 1 << 22
    tv = -np.sort(-rng.choice(np.arange(1, 400, dtype=np.float32) / 8,
                              (B, W)), axis=1)
    kv = -np.sort(-rng.rand(B, W).astype(np.float32), axis=1)
    tg = np.stack([rng.choice(n_pad, W, replace=False)
                   for _ in range(B)]).astype(np.int32)
    kg = np.stack([rng.choice(n_pad, W, replace=False)
                   for _ in range(B)]).astype(np.int32)
    share = rng.rand(B, W) < 0.35
    for b in range(B):
        pick = rng.choice(tg[b], int(share[b].sum()), replace=False)
        kg[b, share[b]] = pick
        _, first = np.unique(kg[b], return_index=True)
        dup = np.setdiff1d(np.arange(W), first)
        fresh = np.setdiff1d(rng.choice(n_pad, 4 * W, replace=False),
                             np.concatenate([kg[b], tg[b]]))[:dup.size]
        kg[b, dup] = fresh
    t = (lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    args = (t(tv), t(tg), t(kv), t(kg), t(np.full(B, W, np.int32)),
            t(np.full(B, W, np.int32)), t(np.full(B, 60.0, np.float32)),
            t(np.ones(B, np.float32)))
    kw = dict(n_pad_t=n_pad, n_pad_k=n_pad, UP=n_pad, pad_id=n_pad,
              similarity="dot_product", k=2 * W)
    return args, kw


def k10_sort_path(tplane, kplane, fqs, el, p, reps, card):
    """K10's sorting path (n = na + nb past ``K10_COUNT_MAX``): the hybrid
    at rank windows of ``HY_SORT_WINDOW`` (lists of 512 + 512, the keys in
    shared memory), rrf and rescored (the payload in the launch), and
    synthetic lists at windows of ``HY_SORT_SYNTH`` (the keys in device
    memory), rrf, sum and rrf with a payload. Each call is one launch and
    bitwise its plain version; these launches count toward no path.
    Returns a row a call (n, launches, max abs err, ms)."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import (
        K10_COUNT_MAX, fuse_rank, fuse_rank_plain)
    from elasticsearch_tpu_torch.parallel.dist_search import (
        fused_search_device)
    rs = np.random.RandomState(4321)
    wide = [dict(f, wt=HY_SORT_WINDOW, wk=HY_SORT_WINDOW) for f in fqs]
    rescored = [dict(f, rescore=dict(RESCORE, terms=[
        f"t{t}" for t in rs.choice(el, RESCORE_TERMS, p=p)])) for f in wide]
    cases = []
    for what, batch, mode in (
            (f"hybrid rrf, windows {HY_SORT_WINDOW}", wide, None),
            (f"hybrid rescore (rrf, total), windows {HY_SORT_WINDOW}",
             rescored, "total")):
        calls = []
        with recording(calls, ("fuse_rank",)):
            fused_search_device(tplane, kplane, batch, fusion="rrf",
                                rescore_mode=mode)
        (_n, a, kw, _o), = of(calls, "fuse_rank")
        if mode is not None and kw.get("tsec") is None:
            fail(f"K10 ({what}): the payload did not ride in the launch")
        cases.append((what, a, kw))
    dev = torch.device("cuda")
    a, kw = fusion_lists(dev, HY_BATCH, HY_SORT_SYNTH)
    g = np.random.RandomState(7)
    B, W = a[0].shape
    payload = {n: torch.from_numpy(x).to(dev) for n, x in (
        ("tsec", g.rand(B, W).astype(np.float32)),
        ("tfnd", g.rand(B, W) < 0.5),
        ("ksec", g.rand(B, W).astype(np.float32)),
        ("kfnd", g.rand(B, W) < 0.5))}
    synth = f"windows {HY_SORT_SYNTH} (synthetic lists)"
    cases += [(f"rrf, {synth}", a, dict(kw, fusion="rrf")),
              (f"sum, {synth}", a, dict(kw, fusion="sum")),
              (f"rrf with the rescore payload, {synth}", a,
               dict(kw, fusion="rrf", **payload))]
    rows = []
    for what, a, kw in cases:
        n = a[0].shape[1] + a[2].shape[1]
        if n <= K10_COUNT_MAX:
            fail(f"K10 ({what}): n = {n} takes the counting path")
        n0 = kb.launches["fuse_rank"]
        got = fuse_rank(*a, **kw)
        torch.cuda.synchronize()
        if kb.launches["fuse_rank"] != n0 + 1:
            fail(f"K10 ({what}): not one launch a call")
        err = check_bitwise(got, fuse_rank_plain(*a, **kw),
                            f"K10 fuse_rank's sorting path ({what})")
        rows.append(dict(what=what, n=n, payload=kw.get("tsec") is not None,
                         launches=1, max_abs_err=err,
                         ms=timed(lambda: fuse_rank(*a, **kw), reps)))
        print(f"# fuse_rank's sorting path ({what}, n={n}): equal to its "
              f"plain version bitwise, {rows[-1]['ms']:.4f} ms [{card}]",
              flush=True)
    return rows


def k11_sort_path(tplane, kplane, fqs, el, p, reps, card):
    """K11's sorting path (n past ``K11_COUNT_MAX``): the hybrid rescored
    at rank windows of ``HY_SORT_WINDOW`` (a fused list of 512 + 512
    entries), in the five score modes. Each call is one launch and bitwise
    its plain version; these launches count toward no path. Returns a row
    a mode (n, launches, max abs err, ms; the card's ms for total)."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import (
        K11_COUNT_MAX, rescore_reorder, rescore_reorder_body)
    from elasticsearch_tpu_torch.parallel.dist_search import (
        fused_search_device)
    rs = np.random.RandomState(4322)
    rows = []
    for mode in RESCORE_MODES:
        batch = [dict(f, wt=HY_SORT_WINDOW, wk=HY_SORT_WINDOW,
                      rescore=dict(RESCORE, terms=[
                          f"t{t}" for t in rs.choice(el, RESCORE_TERMS,
                                                     p=p)])) for f in fqs]
        calls = []
        n0 = kb.launches["rescore_reorder"]
        with recording(calls, ("rescore_reorder",)):
            fused_search_device(tplane, kplane, batch, fusion="rrf",
                                rescore_mode=mode)
        torch.cuda.synchronize()
        (_n, a, kw, o), = of(calls, "rescore_reorder")
        n = a[0].shape[1]
        if n <= K11_COUNT_MAX:
            fail(f"K11 (windows {HY_SORT_WINDOW}, {mode}): n = {n} takes "
                 f"the counting path")
        if kb.launches["rescore_reorder"] != n0 + 1:
            fail(f"K11 (windows {HY_SORT_WINDOW}, {mode}): not one launch "
                 f"a call")
        err = check_bitwise(o, rescore_reorder_body(*a, **kw),
                            f"K11 rescore_reorder's sorting path ({mode})")
        row = dict(what=f"hybrid rescore (rrf, {mode}), windows "
                        f"{HY_SORT_WINDOW}", n=n, launches=1,
                   max_abs_err=err,
                   ms=timed(lambda: rescore_reorder(*a, **kw), reps))
        if mode == "total":
            row["device_ms"] = queued_ms(lambda: rescore_reorder(*a, **kw),
                                         reps)
        rows.append(row)
        print(f"# rescore_reorder's sorting path ({row['what']}, n={n}): "
              f"equal to its plain version bitwise, {row['ms']:.4f} ms "
              f"[{card}]", flush=True)
    return rows


def run_hybrid(card, *, n_docs=HY_DOCS, dim=HY_DIM, n_batches=HY_BATCHES,
               reps=20):
    """Phase 11: the one-dispatch hybrid (config #5) through
    ``fused_search_device``. Returns the K10 and K11 rows and the timing
    of K9, K6 and K3 at this shape, and the path's launch counts."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import (
        K11_COUNT_MAX, bisect_exact_scores, bisect_exact_scores_plain,
        bool_bm25_topk, fuse_rank, fuse_rank_plain, rescore_reorder,
        rescore_reorder_body)
    from elasticsearch_tpu_torch.ops.knn import (knn_scan_partials,
                                                 knn_shard_scan_plain)
    from elasticsearch_tpu_torch.ops.topk import topk_merge, topk_merge_plain
    from elasticsearch_tpu_torch.parallel.dist_search import (
        DistributedKnnPlane, DistributedSearchPlane, fused_search_device)
    from elasticsearch_tpu_torch.search.query_planner import rrf_fuse_rows

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rng = np.random.RandomState(1234)
    corpus = hybrid_corpus(rng, n_docs)
    gen_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    tplane = DistributedSearchPlane([corpus], "body", device=dev)
    torch.cuda.synchronize()
    print(f"# hybrid text: {n_docs} docs, {corpus['docs'].shape[0]} postings"
          f" ({gen_t:.1f} s); plane n_pad {tplane.n_pad}, dense threshold "
          f"{tplane.dense_threshold}, {tplane.n_dense} dense terms (pad "
          f"{tplane.T_pad}), L_cap {tplane.L_cap}, "
          f"{tplane.device_corpus_bytes() / 2**30:.3f} GiB on {dev} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    vecs = hybrid_vectors(n_docs, dim)
    gen_v = time.perf_counter() - t0
    t0 = time.perf_counter()
    kplane = DistributedKnnPlane([dict(vectors=vecs)],
                                 similarity="dot_product", device=dev)
    kplane._device_arrays()
    torch.cuda.synchronize()
    print(f"# hybrid vectors: {n_docs} x {dim} standard_normal ({gen_v:.1f} "
          f"s); plane n_pad {kplane.n_pad}, "
          f"{kplane.device_corpus_bytes() / 2**30:.3f} GiB on {dev} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    batches, el, p, dense = hybrid_traffic(rng, corpus, tplane, dim,
                                           n_batches)
    print(f"# hybrid traffic: {el.size} sparse-tier terms of df >= 2; "
          f"{HY_TERMS}-term should clauses, msm 1, rrf rc {HY_RC}, windows "
          f"{HY_WINDOW}, k {K}, batches of {HY_BATCH}", flush=True)

    # ---- one batch: every kernel of the step against its plain version -----
    names = ("bool_bm25_topk", "knn_shard_scan", "topk_merge", "fuse_rank",
             "rescore_reorder", "bisect_exact_scores")
    calls = []
    with recording(calls, names):
        rows, totals, text_rows, knn_rows = fused_search_device(
            tplane, kplane, batches[1], fusion="rrf")
    (_n, k9a, k9k, k9o), = of(calls, "bool_bm25_topk")
    _, k9_plain = check_k9(list(k9a), k9k, "hybrid", got=k9o)
    (_n, k6a, k6k, (k6v, k6i)), = of(calls, "knn_shard_scan")
    kk_k = k6k["kk"]
    wv, wi = knn_shard_scan_plain(*k6a, **dict(k6k, kk=kk_k + 1))
    q1 = np.stack([f["qv"] for f in batches[1]])
    vmax = float(np.sqrt(np.max(np.einsum("ij,ij->i", vecs, vecs))))
    tol = knn_tol(q1, vmax, "dot_product")
    k6_err = check_lists(k6v[:, 0], k6i[:, 0], wv[:, 0], wi[:, 0], tol,
                         f"K6 knn_scan (D={dim})")
    k3 = [(a, k) for _n, a, k, _o in of(calls, "topk_merge")]
    k3_err = check_recorded_k3(calls, "hybrid")
    (_n, k10a, k10k, k10o), = of(calls, "fuse_rank")
    check_bitwise(k10o, fuse_rank_plain(*k10a, **k10k),
                  "hybrid: K10 fuse_rank (rrf)")
    print(f"# hybrid (Q={k9a[2].shape[2]}, L={k9k['L']}, W={kk_k}): K9 == "
          f"plain (bitwise), K6 ~= plain (max abs err {k6_err:.3g}, tol "
          f"{tol:.3g}), K3 == plain ({len(k3)} calls), K10 == plain (rrf, "
          f"bitwise)", flush=True)

    # ---- sum fusion and the five rescore modes: K10, K5, K11 ---------------
    kb.reset_launches()
    n_extra, k11_rec, k10_sum, k5_rec, k10_rec = 0, {}, None, {}, {}
    for mode in (None,) + RESCORE_MODES:
        fqs = [dict(f, rescore=dict(RESCORE, terms=[
            f"t{t}" for t in rng.choice(el, RESCORE_TERMS, p=p)]))
            for f in batches[2]]
        calls = []
        with recording(calls, names):
            fused_search_device(tplane, kplane, fqs,
                                fusion="sum" if mode is None else "rrf",
                                rescore_mode=mode)
        n_extra += 1
        (_n, a, kw, o), = of(calls, "fuse_rank")
        check_bitwise(o, fuse_rank_plain(*a, **kw),
                      f"hybrid: K10 fuse_rank ({kw['fusion']})")
        if mode is None:
            k10_sum = (a, kw)
            continue
        if kw.get("tsec") is None:
            fail(f"hybrid rescore ({mode}): K10 did not carry the payload")
        k10_rec[mode] = (a, kw)
        # one launch scores both lists; against two plain calls
        (_n, a5, kw5, o5), = of(calls, "bisect_exact_scores")
        if kw5.get("cand_docs2") is None or len(o5) != 4:
            fail(f"hybrid rescore ({mode}): K5 did not take both lists")
        check_bitwise(o5, bisect_exact_scores_plain(*a5, **kw5),
                      f"hybrid rescore ({mode}): K5, both lists")
        k5_rec[mode] = (a5, kw5)
        (_n, a, kw, o), = of(calls, "rescore_reorder")
        if a[0].shape[1] > K11_COUNT_MAX:
            fail(f"hybrid rescore ({mode}): K11 took its sorting path")
        check_bitwise(o, rescore_reorder_body(*a, **kw),
                      f"hybrid rescore ({mode}): K11")
        k11_rec[mode] = (a, kw)
        check_recorded_k3(calls, f"hybrid ({mode})")
    c_extra = dict(kb.launches)
    n_rs = len(RESCORE_MODES)
    if c_extra["fuse_rank"] != n_extra or c_extra["rescore_reorder"] != \
            n_rs or c_extra["bisect_exact_scores"] != n_rs:
        fail(f"hybrid sum/rescore: launches {c_extra} over {n_extra} "
             f"dispatches")
    print(f"# hybrid: sum fusion and rescore ({', '.join(RESCORE_MODES)}; "
          f"window {RESCORE['window']}): K10 (with the rescore payload), K5 "
          f"(both lists, one launch), K3 and K11 (its counting path) == "
          f"plain (bitwise); "
          f"launches "
          f"{ {n: v for n, v in c_extra.items() if v} } over {n_extra} "
          f"dispatches", flush=True)

    # ---- a dense-tier term is refused ---------------------------------------
    if not dense.any():
        fail("hybrid: the text plane has no dense tier")
    head = f"t{int(np.flatnonzero(dense)[0])}"
    bad = [dict(batches[-1][0], clauses=[("should", [head, "t5000"])])] + \
        batches[-1][1:]
    try:
        fused_search_device(tplane, kplane, bad, fusion="rrf")
    except ValueError as e:
        print(f"# hybrid: a batch with a dense-tier term ({head}) raises "
              f"ValueError ({e})", flush=True)
    else:
        fail("hybrid: a dense-tier term was served by the sparse step")

    # ---- the route, counted alone -------------------------------------------
    def call(b, s):
        out = fused_search_device(tplane, kplane, b, fusion="rrf", stages=s)
        return out[0], out[2]

    lat, stg, counts, n_disp, _ = drive(
        tplane, batches, call, kb,
        required=("bool_bm25_topk", "knn_scan", "topk_merge", "fuse_rank"),
        stage_keys=("prep_ms", "dispatch_ms", "fetch_ms", "h2d_bytes",
                    "d2h_bytes"))
    if any(counts[n] != n_disp for n in ("bool_bm25_topk", "knn_scan",
                                         "fuse_rank")) or \
            counts["topk_merge"] != HY_K3_CALLS * n_disp or \
            len(k3) != HY_K3_CALLS or counts["rescore_reorder"] \
            or counts["sparse_candidates_topk"]:
        fail(f"hybrid: launches {counts} over {n_disp} dispatches")
    n_q = len(lat) * HY_BATCH
    print(f"# hybrid: {n_q / lat.sum():.1f} q/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms per {HY_BATCH}-query batch "
          f"over {len(lat)} batches [{card}]", flush=True)
    print("# hybrid stages (mean): " + ", ".join(
        f"{key} {v / len(lat):.3f}" for key, v in stg.items()))
    print(f"# hybrid launches over {n_disp} dispatches: "
          f"{ {n: v for n, v in counts.items() if v} }", flush=True)

    # ---- four queries against numpy ------------------------------------------
    qv = np.stack([f["qv"] for f in batches[1][:HY_EVAL]])
    sc = vecs @ qv.T
    for qi in range(HY_EVAL):
        bq = batches[1][qi]
        top, tsc, elig = exact_bool(corpus, bq, HY_WINDOW)
        n = min(HY_WINDOW, int(elig.sum()))
        if totals[qi] != int(elig.sum()):
            fail(f"hybrid query {qi}: total {totals[qi]} != exact "
                 f"{int(elig.sum())}")
        tr = text_rows[qi]
        if len(tr) != n:
            fail(f"hybrid query {qi}: {len(tr)} text hits, expected {n}")
        check_topk(np.asarray([[r[0] for r in tr]]),
                   np.asarray([[r[2] for r in tr]]), tsc[None, :n],
                   top[None, :n], tsc[n:n + 1], REF_RTOL, 0.0,
                   f"hybrid query {qi}: text against the exact reference")
        ktop = np.argpartition(-sc[:, qi], HY_WINDOW + 1)[:HY_WINDOW + 1]
        ktop = ktop[np.lexsort((ktop, -sc[ktop, qi]))]
        kr = knn_rows[qi]
        if len(kr) != HY_WINDOW:
            fail(f"hybrid query {qi}: {len(kr)} kNN hits")
        check_topk(np.asarray([[r[0] for r in kr]]),
                   np.asarray([[r[2] for r in kr]]),
                   sc[ktop[:HY_WINDOW], qi][None], ktop[None, :HY_WINDOW],
                   sc[ktop[HY_WINDOW:], qi], 0.0, tol,
                   f"hybrid query {qi}: kNN against numpy")
        want = rrf_fuse_rows([tr, kr], int(HY_RC))
        got = rows[qi]
        wn = min(K, len(want))
        if len(got) != wn:
            fail(f"hybrid query {qi}: {len(got)} fused hits, expected {wn}")
        check_topk(np.asarray([[r[0] for r in got]]),
                   np.asarray([[r[1] * kplane.n_pad + r[2] for r in got]]),
                   np.asarray([[r[0] for r in want[:wn]]]),
                   np.asarray([[r[1] * kplane.n_pad + r[2]
                                for r in want[:wn]]]),
                   [want[wn][0] if len(want) > wn else -np.inf], RRF_RTOL,
                   0.0, f"hybrid query {qi}: fused against rrf_fuse_rows")
    print(f"# hybrid: {HY_EVAL} queries agree with numpy (exact BM25 top-"
          f"{HY_WINDOW}, matmul + lexsort kNN top-{HY_WINDOW} within "
          f"{tol:.3g}, RRF of the two by rrf_fuse_rows within "
          f"{RRF_RTOL}, totals exact)", flush=True)
    del sc

    # ---- times ----------------------------------------------------------------
    out = {}
    k9_ms = timed(lambda: bool_bm25_topk(*k9a, **k9k), reps)
    nb, nf, n_post, n_owner = k9_work(tplane, list(k9a), k9k["k"])
    out["k9"] = dict(ms=k9_ms, bound=bound(nb, nf),
                     launch=k9_launch(k9a, k9k))
    print(f"# bool_bm25_topk (hybrid text side): {k9_ms:.4f} ms (bound "
          f"{out['k9']['bound'][0]:.5f} ms: {n_post} valid postings, "
          f"{n_owner} candidates), plain {k9_plain:.3f} ms; launch "
          f"{out['k9']['launch']} [{card}]", flush=True)
    vk, vn, ex, qq, qn = k6a
    k6_ms = timed(lambda: knn_scan_partials(vk, vn, ex, qq, qn, l2=False,
                                            kk=kk_k), reps)
    k6_plain = timed(lambda: knn_shard_scan_plain(*k6a, **k6k), 2)
    flat = vk[0, :kplane.n_docs_total]
    k6_lib = timed(lambda: torch.topk(qq @ flat.T, kk_k, dim=1), reps)
    B = qq.shape[0]
    live = int(ex.sum())
    nb = live * dim * 4 + ex.numel() + B * dim * 4 + B * 4 + B * kk_k * 8
    k6_b = bound(nb, 2 * B * live * dim)
    print(f"# knn_scan (D={dim}, {live} live rows): {k6_ms:.4f} ms (bound "
          f"{k6_b[0]:.4f} ms by {k6_b[1]}), plain {k6_plain:.3f} ms, library "
          f"(fp32 matmul + torch.topk) {k6_lib:.4f} ms [{card}]", flush=True)
    k6_c = knn_scan_partials(vk, vn, ex, qq, qn, l2=False,
                             kk=kk_k)[0].shape[2]
    per_sm, ring = (kb.query("knn_scan", f"es_knn_scan_{q}", B, dim, kk_k)
                    for q in ("blocks_per_sm", "ring"))
    print(f"# knn_scan (D={dim}) launch: {k6_c} chunks, {per_sm} blocks an "
          f"SM, a ring of {ring // 100} stages of {ring % 100} values",
          flush=True)
    out["k6"] = dict(ms=k6_ms, plain_ms=k6_plain, library_ms=k6_lib,
                     bound=k6_b, err=k6_err, chunks=k6_c,
                     blocks_per_sm=per_sm, ring_stages=ring // 100,
                     stage_values=ring % 100)
    k3_ms = timed(lambda: [topk_merge(*a, **kw) for a, kw in k3], reps)
    k3_plain = timed(lambda: [topk_merge_plain(*a, **kw) for a, kw in k3], 3)
    k3_b = bound(sum(8 * a[0].numel() + 8 * a[0].shape[0] * kw["k"]
                     for a, kw in k3), 0)

    def k3_library():
        # torch.topk over the same rows ([a | b] where a call merges two)
        for a, kw in k3:
            b = a[2] if len(a) > 2 else kw.get("b_vals")
            v = a[0] if b is None else torch.cat([a[0], b], 1)
            torch.topk(v, min(kw["k"], v.shape[1]), dim=1)
    k3_lib = timed(k3_library, reps)
    # the card's share of both (torch.profiler): the calls are short, so
    # back-to-back events measure their host side as well
    k3_dev = sum(device_ms_by_name(
        lambda: [topk_merge(*a, **kw) for a, kw in k3], reps).values())
    k3_lib_dev = sum(device_ms_by_name(k3_library, reps).values())
    print(f"# topk_merge, the hybrid step's {len(k3)} calls: {k3_ms:.4f} ms "
          f"(on the card {k3_dev:.4f}; bound {k3_b[0]:.5f} ms by "
          f"{k3_b[1]}), plain {k3_plain:.3f} ms, library (torch.topk) "
          f"{k3_lib:.4f} ms (on the card {k3_lib_dev:.4f}) [{card}]",
          flush=True)
    out["k3"] = dict(ms=k3_ms, err=k3_err, library_ms=k3_lib,
                     device_ms=k3_dev, library_device_ms=k3_lib_dev)
    kernels = []
    for name, (a, kw), src, repl, what in (
            ("fuse_rank", (k10a, k10k), "fuse_rank.cu",
             "elasticsearch_tpu/ops/fused_query.py:163", "rrf"),
            ("rescore_reorder", k11_rec["total"], "rescore_reorder.cu",
             "elasticsearch_tpu/ops/fused_query.py:245", "total")):
        f, fp = (fuse_rank, fuse_rank_plain) if name == "fuse_rank" else \
            (rescore_reorder, rescore_reorder_body)
        ms = timed(lambda: f(*a, **kw), reps)
        dev_ms = queued_ms(lambda: f(*a, **kw), reps)
        plain = timed(lambda: fp(*a, **kw), 3)
        if name == "fuse_rank":
            Bq, n_in = a[0].shape[0], a[0].shape[1] + a[2].shape[1]
            nb, nf = Bq * n_in * 8 + Bq * 16 + Bq * kw["k"] * 12, \
                3 * Bq * n_in
        else:
            n_in = a[0].shape[1]
            nb, nf = k11_work(a, kw["k"])
        bms, bby = bound(nb, nf)
        print(f"# {name} (hybrid, {what}, n={n_in}): {ms:.4f} ms (on the "
              f"card {fmt_ms(dev_ms)}; bound {bms:.6f} ms by {bby}), plain "
              f"{plain:.3f} ms [{card}]", flush=True)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"elasticsearch_tpu_torch/csrc/{src}", replaces=repl,
            max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain,
            bound_ms=bms,
            bound_by=bby, library_ms=None,
            library_none="no one PyTorch call fuses two rankings by rank"
            if name == "fuse_rank" else
            "no one PyTorch call re-sorts a window ahead of its tail"))
    a, kw = k10_sum
    ar, kwr = k10_rec["total"]
    kernels[0]["ms_by_fusion"] = {
        "rrf": kernels[0]["ms"],
        "sum": timed(lambda: fuse_rank(*a, **kw), reps),
        "rrf_rescore_payload": timed(lambda: fuse_rank(*ar, **kwr), reps)}
    print(f"# fuse_rank (hybrid): sum {kernels[0]['ms_by_fusion']['sum']:.4f}"
          f" ms, rrf with the rescore payload "
          f"{kernels[0]['ms_by_fusion']['rrf_rescore_payload']:.4f} ms "
          f"[{card}]", flush=True)
    kernels[0]["sort_path"] = k10_sort_path(tplane, kplane, batches[2], el,
                                            p, reps, card)
    kernels[1]["sort_path"] = k11_sort_path(tplane, kplane, batches[2], el,
                                            p, reps, card)
    a5, kw5 = k5_rec["total"]
    out["k5"] = dict(ms=timed(lambda: bisect_exact_scores(*a5, **kw5), reps),
                     plain_ms=timed(lambda: bisect_exact_scores_plain(
                         *a5, **kw5), 3))
    print(f"# bisect_exact_scores (hybrid rescore, total, both lists: "
          f"R={a5[5].shape[2]} + {kw5['cand_docs2'].shape[2]}, "
          f"Q={a5[2].shape[2]}): {out['k5']['ms']:.4f} ms, plain "
          f"{out['k5']['plain_ms']:.3f} ms [{card}]", flush=True)
    path = {n: counts[n] + c_extra[n] for n in counts}
    # K9's device time a dispatch over the timed batches, served again
    # under the profiler after every timing
    out["k9"]["device_ms"] = k9_device_ms(
        lambda: [fused_search_device(tplane, kplane, b, fusion="rrf")
                 for b in batches[1:]], len(batches) - 1)
    print(f"# hybrid: K9's device time {out['k9']['device_ms']:.4f} ms a "
          f"dispatch over the {len(batches) - 1} timed batches "
          f"(torch.profiler) [{card}]", flush=True)
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del vecs, kplane, tplane
    return kernels, out, path


#: config #3 (``bench.py:bench_terms_percentiles``) at the NYC-taxi rally
#: track's scale: Rally's ``nyc_taxis`` corpus holds 165,346,692 documents
#: (2015 yellow-cab trips); one pair a doc
AGG_DOCS = 165_346_692
AGG_V = 256                  # keyword ordinals, Zipf(1.1) frequencies
AGG_ZIPF = 1.1
AGG_DENSITY = 0.25           # filter mask density, fresh a agg
AGG_TOP = 10
AGG_QS = (50.0, 95.0, 99.0)  # Hazen
AGG_TIMED = 32               # timed aggs (one warm-up more)
AGG_CHECKED = 4              # aggs held against the numpy reference
AGG_OTHER = 3                # masks through the other kernels' calls
AGG_SPARSE = 0.001           # K13's fallbacks: a mask this sparse
#: the histogram over the fare column (lognormal(3, 1)): 573 buckets on
#: the full-size run, 1,024 padded, under MAX_DEVICE_BUCKETS
AGG_HIST_INTERVAL = 10.0


def agg_columns(rng, n, V):
    """Config #3's columns built directly in (ordinal, value) order: run
    lengths multinomial over Zipf(1.1) ordinal frequencies, lognormal(3, 1)
    f32 values sorted within each run, and a random permutation for the
    docs (pair i belongs to doc ``docs[i]``), the distribution of the
    bench's per-doc draws after its lexsort."""
    pmf = np.arange(1, V + 1, dtype=np.float64) ** -AGG_ZIPF
    pmf /= pmf.sum()
    lens = rng.multinomial(n, pmf)
    off = np.zeros(V + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    vals = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    for v in range(V):
        vals[off[v]:off[v + 1]].sort()
    docs = rng.permutation(n).astype(np.int32)
    return off, docs, vals


def agg_reference(mask_h, ords_doc, off, docs_s, vals_s, qs):
    """The terms top-k and exact percentiles of one mask, in numpy: counts
    by ``np.bincount``, top ordinals by a stable argsort (ties to the lower
    ordinal), and each run's masked values (ascending already) picked at
    the Hazen ranks and interpolated with the f32 FMA the port uses; also
    ``np.percentile(method="hazen")`` of the same values, in f64."""
    import torch
    from elasticsearch_tpu_torch.ops.blockmax import fma_f32
    n = ords_doc.shape[0]
    cnt = np.bincount(ords_doc[mask_h[:n]], minlength=off.shape[0] - 1)
    top = np.argsort(-cnt, kind="stable")[:AGG_TOP]
    qs = np.asarray(qs, np.float64)
    picked, hazen = [], []
    for o in top:
        sl = slice(off[o], off[o + 1])
        run = vals_s[sl][mask_h[docs_s[sl]]]
        k = run.size
        pos = np.clip(qs / 100.0 * k - 0.5, 0.0, max(k - 1.0, 0.0))
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, max(k - 1, 0))
        f = torch.from_numpy((pos - lo).astype(np.float32))
        a, b = torch.from_numpy(run[lo]), torch.from_numpy(run[hi])
        picked.append(fma_f32(f, b, (1.0 - f) * a).numpy())
        hazen.append(np.percentile(run.astype(np.float64), qs,
                                   method="hazen"))
    return top, cnt[top], np.asarray(picked, np.float64), np.asarray(hazen)


def k13_hi_searched(c, offsets, ordinals, lo, hi):
    """How many pick entries' hi lies 32 or more entries after lo's
    answer in c: past the 32 entries K13 reads first, so searched."""
    import torch
    o = ordinals.long().clamp(0, offsets.shape[0] - 1)
    base = c[offsets[o].long()][:, None]
    j_lo = torch.searchsorted(c, (base + lo + 1).to(torch.int32))
    j_hi = torch.searchsorted(c, (base + hi + 1).to(torch.int32))
    return int((j_hi >= j_lo + 32).sum())


def k13_window_missed(c, offsets):
    """How many runs with a masked pair have their last one before their
    last 32 pairs: K13's register pass searches those."""
    import torch
    a, b = offsets[:-1].long(), offsets[1:].long()
    st, en = c[a], c[b]
    return int(((en > st) & (torch.searchsorted(c, en) <= b - 31)
                & (b - 31 > a + 1)).sum())


def k13_pick_bytes(c, offsets, vals, ordinals, lo, hi, frac):
    """The bytes K13's pick must move at these inputs, each entry once:
    the ordinals, ranks, fractions and results; the offsets and c at the
    picked runs' ends; c on both sides of each answer j (c[j - 1] < t <=
    c[j] shows that j is the lower bound of target t) and the value
    picked at j - 1."""
    import torch
    V, n_c, M = offsets.shape[0] - 1, c.shape[0], vals.shape[0]
    o = ordinals.long().clamp(0, V)
    ends = torch.cat([o, o[o < V] + 1]).unique()
    base = c[offsets[o].long()][:, None]
    j = torch.searchsorted(c, torch.cat([base + lo + 1, base + hi + 1], 1)
                           .to(torch.int32).contiguous()).reshape(-1)
    near = torch.cat([j - 1, j])
    c_read = torch.cat([offsets[ends].long(),
                        near[(near >= 0) & (near < n_c)]]).unique()
    picked = (j - 1).clamp(0, M - 1).unique()
    n_in = ordinals.numel() + lo.numel() + hi.numel() + frac.numel()
    return 4 * (n_in + lo.numel() + ends.numel() + c_read.numel()
                + picked.numel())


def k13_register_bytes(c, offsets, rhos):
    """The bytes K13's register pass must move at these inputs, each entry
    once: the offsets, c at every run's ends, c on both sides of the last
    masked pair's answer j of each run that has one (c[j - 1] < c[b] <=
    c[j]), the rho at j - 1 and the registers written."""
    import torch
    V, M = offsets.shape[0] - 1, rhos.shape[0]
    a, b = offsets[:-1].long(), offsets[1:].long()
    en = c[b]
    live = en > c[a]
    j = torch.searchsorted(c, en[live])
    c_read = torch.cat([offsets.long(), j - 1, j]).unique()
    picked = (j - 1).clamp(0, M - 1).unique()
    return 4 * ((V + 1) + c_read.numel() + picked.numel() + V)


def k13_edge_checks(off_d, docs_d, vals_d, hll, n_docs, n_pad):
    """K13 bitwise against its plain versions, one launch a call, where
    each of its fallbacks runs: an ``AGG_SPARSE`` mask over the route's
    columns with run V // 2's docs masked out (no masked pair) and over
    the HLL pairs. The pick takes every ordinal's Hazen ranks (hi's answer
    mostly past the 32 entries after lo's), ordinals V and V + 7 (no run:
    clamped to V) and ranks at count − 1 of run V − 1; the register pass
    mostly misses the run's last 32 pairs. Returns how many entries and
    runs took each path."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import aggs
    dev = off_d.device
    rng = np.random.default_rng(4321)
    sparse = np.zeros(n_pad, bool)
    sparse[:n_docs] = rng.random(n_docs, dtype=np.float32) < AGG_SPARSE
    mask_s = torch.from_numpy(sparse).to(dev)
    del sparse
    off_h = off_d.cpu().numpy()
    V = off_h.shape[0] - 1
    empty = V // 2
    mask_s[docs_d[off_h[empty]:off_h[empty + 1]].long()] = False
    counts, c = aggs.masked_rank_prefix(off_d, docs_d, mask_s)
    cnt = counts.cpu().numpy()
    if cnt[empty] != 0:
        fail(f"aggs: K13 edges: run {empty} has {cnt[empty]} masked pairs")
    lo, hi, frac = aggs.hazen_ranks(cnt, AGG_QS)
    n_last = int(cnt[V - 1])
    edge_lo = np.array([[0, 1, 2], [0, 1, 2],
                        [n_last - 1, max(n_last - 2, 0), 0]], np.int32)
    edge_hi = np.array([[1, 2, 3], [1, 2, 3],
                        [n_last - 1, max(n_last - 1, 0), min(1, n_last)]],
                       np.int32)
    ords = np.concatenate([np.arange(V), [V, V + 7, V - 1]]).astype(np.int32)
    lo = np.concatenate([lo, edge_lo])
    hi = np.concatenate([hi, edge_hi])
    frac = np.concatenate([frac, np.full((3, lo.shape[1]), 0.375,
                                         np.float32)])
    args = (c, off_d, vals_d) + tuple(torch.from_numpy(x).to(dev)
                                      for x in (ords, lo, hi, frac))
    n0 = kb.launches["agg_rank_pick"]
    got = aggs.rank_pick(*args)
    if kb.launches["agg_rank_pick"] != n0 + 1:
        fail("aggs: K13 (pick) took more than one launch")
    if not same_bits(got, aggs.rank_pick_plain(*args)):
        fail(f"aggs: K13 (pick) differs from its plain version at a "
             f"{AGG_SPARSE:.1%} mask or an edge ordinal")
    hi_searched = k13_hi_searched(c, off_d, *args[3:6])
    h_off = hll["off_dev"]
    hc = aggs.masked_rank_prefix(h_off, hll["docs_dev"], mask_s)[1]
    n0 = kb.launches["agg_rank_pick"]
    regs = aggs.register_max(hc, h_off, hll["rhos_dev"])
    if kb.launches["agg_rank_pick"] != n0 + 1:
        fail("aggs: K13 (registers) took more than one launch")
    if not same_bits(regs, aggs.register_max_plain(hc, h_off,
                                                   hll["rhos_dev"])):
        fail(f"aggs: K13 (registers) differs from its plain version at a "
             f"{AGG_SPARSE:.1%} mask")
    missed = k13_window_missed(hc, h_off)
    if hi_searched == 0 or missed == 0:
        fail(f"aggs: K13 edges reached no fallback (hi {hi_searched}, "
             f"registers {missed})")
    return dict(pick=int(lo.size), empty=empty, hi_searched=hi_searched,
                registers=h_off.shape[0] - 1, window_missed=missed)


def agg_sum_tol(abs_mass):
    """Kernel and plain version each round an f64 sum to f32 once (the
    f64 sums' own error is below 2^-25 of the mass for < 2^28 terms)."""
    return 2.0 ** -22 * abs_mass


def run_aggs(card, *, n_docs=AGG_DOCS, n_timed=AGG_TIMED, reps=10):
    """Phase 12: aggregations (config #3) on the card. The terms +
    percentiles route (K12 → top_ordinals → K13) over the bench's columns,
    and K12–K15 through the port's per-segment caches on a stand-in
    segment of the same columns. Returns the K12–K15 rows and the path's
    launch counts."""
    import types

    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops import aggs
    from elasticsearch_tpu_torch.utils.shapes import round_up_pow2

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    t0 = time.perf_counter()
    off, docs_s, vals_s = agg_columns(rng, n_docs, AGG_V)
    n_pad = round_up_pow2(n_docs)
    ords_s = np.repeat(np.arange(AGG_V, dtype=np.int32), np.diff(off))
    ords_doc = np.empty(n_docs, np.int32)
    ords_doc[docs_s] = ords_s
    vals_doc = np.empty(n_docs, np.float32)
    vals_doc[docs_s] = vals_s
    del ords_s
    gen_s = time.perf_counter() - t0
    off_d, docs_d, vals_d = (torch.from_numpy(x).to(dev)
                             for x in (off, docs_s, vals_s))
    mask_h = np.zeros(n_pad, bool)

    def draw():
        mask_h[:n_docs] = rng.random(n_docs, dtype=np.float32) < AGG_DENSITY
        return mask_h

    print(f"# aggs (config #3): {n_docs} docs, one pair a doc, n_pad "
          f"{n_pad}, {AGG_V} Zipf({AGG_ZIPF}) ordinals (largest run "
          f"{int(np.diff(off).max())} pairs), lognormal(3, 1) values; "
          f"columns in {gen_s:.1f} s", flush=True)

    # ---- the route: mask upload, K12 → top_ordinals → K13 ---------------
    kb.reset_launches()
    lat, h2d, prefix_ms, pick_ms = [], [], [], []
    checked = 0
    route_in = None
    for i in range(1 + n_timed):
        draw()
        torch.cuda.synchronize()
        ta = time.perf_counter()
        mask_d = torch.from_numpy(mask_h).to(dev)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        counts, c = aggs.masked_rank_prefix(off_d, docs_d, mask_d)
        top_counts, top = aggs.top_ordinals(counts, AGG_TOP)
        tc = time.perf_counter()
        pct = aggs.prefix_percentiles(counts, c, off_d, vals_d, top, AGG_QS)
        td = time.perf_counter()
        if i:
            lat.append(td - ta)
            h2d.append(tb - ta)
            prefix_ms.append(tc - tb)
            pick_ms.append(td - tc)
        if checked < AGG_CHECKED:
            w_top, w_cnt, w_pct, w_hazen = agg_reference(
                mask_h, ords_doc, off, docs_s, vals_s, AGG_QS)
            if not (np.array_equal(top, w_top) and
                    np.array_equal(top_counts, w_cnt)):
                fail(f"aggs: top {AGG_TOP} {top.tolist()} "
                     f"{top_counts.tolist()} != numpy {w_top.tolist()} "
                     f"{w_cnt.tolist()}")
            if not np.array_equal(pct, w_pct):
                fail(f"aggs: percentiles {pct.tolist()} != numpy's picks "
                     f"{w_pct.tolist()}")
            if not np.allclose(pct, w_hazen, rtol=1e-6, atol=0.0):
                fail("aggs: percentiles off np.percentile(hazen) by more "
                     "than 1e-6")
            checked += 1
        if i == 0:
            route_in = (mask_d.clone(), counts, c, top)
    route_counts = dict(kb.launches)
    n_aggs = 1 + n_timed
    if route_counts["agg_masked_scan"] != n_aggs or \
            route_counts["agg_rank_pick"] != n_aggs:
        fail(f"aggs route: launches {route_counts} over {n_aggs} aggs")
    lat = np.asarray(lat)
    print(f"# aggs route: {len(lat) / lat.sum():.2f} aggs/s, p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms over {len(lat)} aggs "
          f"(top {AGG_TOP} terms + percentiles {list(AGG_QS)}, "
          f"{AGG_DENSITY:.0%} masks) [{card}]", flush=True)
    print(f"# aggs route stages (mean ms): h2d_ms "
          f"{np.mean(h2d) * 1e3:.3f} ({n_pad} mask bytes, pageable), "
          f"dispatch_ms {(np.mean(prefix_ms) + np.mean(pick_ms)) * 1e3:.3f}"
          f" (K12 + top_ordinals {np.mean(prefix_ms) * 1e3:.3f}, Hazen ranks"
          f" + K13 + the result {np.mean(pick_ms) * 1e3:.3f}); fetch_ms in "
          f"dispatch: the route synchronises on the {4 * AGG_V}-byte counts "
          f"and the {4 * AGG_TOP * len(AGG_QS)}-byte result", flush=True)
    print(f"# aggs route: top {AGG_TOP} and percentiles of {checked} aggs "
          f"equal to numpy (bincount + stable argsort; Hazen picks with the "
          f"f32 FMA, within 1e-6 of np.percentile)", flush=True)

    # ---- the other kernels through the caches of a stand-in segment -------
    t0 = time.perf_counter()
    seg = types.SimpleNamespace(
        n_docs=n_docs, n_pad=n_pad,
        keyword_fields={"vendor": types.SimpleNamespace(
            dv_docs_host=np.arange(n_docs, dtype=np.int32),
            dv_ords_host=ords_doc,
            ord_terms=[f"v{o:03d}" for o in range(AGG_V)])},
        numeric_fields={"fare": types.SimpleNamespace(
            docs_host=np.arange(n_docs, dtype=np.int32),
            vals_host=vals_doc.astype(np.float64))})
    k_off, k_docs, V = aggs.ordinal_csr(seg, "vendor")
    hll = aggs.hll_sketch_pairs(seg, "fare")
    h_ids, h_docs, n_buckets, _base = aggs.histogram_bucket_ids(
        seg, "fare", AGG_HIST_INTERVAL, 0.0)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if h_ids is None:
        fail(f"aggs: {n_buckets} histogram buckets past the device cap")
    nb = round_up_pow2(n_buckets)
    Mp = k_docs.shape[0]
    k_docs_h = k_docs.cpu().numpy()
    k_vals = np.zeros(Mp, np.float32)
    k_vals[:n_docs] = vals_doc[k_docs_h[:n_docs]]
    h_vals = np.zeros(Mp, np.float32)
    h_vals[:n_docs] = vals_doc
    k_vals_d, h_vals_d = (torch.from_numpy(x).to(dev)
                          for x in (k_vals, h_vals))
    print(f"# aggs caches (ordinal CSR of vendor, HLL pairs of fare at p = "
          f"{aggs.HLL_P}, histogram ids of fare at interval "
          f"{AGG_HIST_INTERVAL}: {n_buckets} buckets, {nb} padded): pack_s "
          f"{pack_s:.1f} ({Mp} padded pairs each)", flush=True)

    kb.reset_launches()
    other = []
    for _ in range(AGG_OTHER):
        mask_o = draw().copy()
        mask_d = torch.from_numpy(mask_o).to(dev)
        other.append(dict(
            mask=mask_d, mask_h=mask_o,
            counts=aggs.masked_ordinal_counts(k_off, k_docs, mask_d),
            sums=aggs.masked_ordinal_sums(k_off, k_docs, k_vals_d, mask_d),
            bcounts=aggs.masked_bucket_counts(h_ids, h_docs, mask_d,
                                              n_buckets=nb),
            bsums=aggs.masked_bucket_sums(h_ids, h_docs, h_vals_d, mask_d,
                                          n_buckets=nb),
            regs=aggs.masked_register_max(hll["off_dev"], hll["docs_dev"],
                                          hll["rhos_dev"], mask_d),
            metrics=torch.stack(aggs.masked_metrics(h_docs, h_vals_d,
                                                    mask_d))))
    torch.cuda.synchronize()
    other_counts = dict(kb.launches)
    want = {"agg_masked_scan": 3 * AGG_OTHER, "agg_rank_pick": AGG_OTHER,
            "agg_bucket_reduce": 2 * AGG_OTHER, "agg_metrics": AGG_OTHER}
    if any(other_counts[n] != v for n, v in want.items()):
        fail(f"aggs kernels: launches {other_counts}, expected {want}")
    path = {n: route_counts[n] + other_counts[n] for n in route_counts}

    # ---- each kernel against its plain version -----------------------------
    mask_d, counts, c, top = route_in
    p_counts, p_c = aggs.masked_scan_plain(off_d, docs_d, mask_d,
                                           mode="prefix")
    if not (same_bits(counts, p_counts) and same_bits(c, p_c)):
        fail("aggs: K12 (prefix) differs from its plain version")
    errs = {}
    for o in other:
        if not same_bits(o["counts"], aggs.masked_scan_plain(
                k_off, k_docs, o["mask"], mode="counts")):
            fail("aggs: K12 (counts) differs from its plain version")
        want_s = aggs.masked_scan_plain(k_off, k_docs, o["mask"], k_vals_d,
                                        mode="sums")
        mass = aggs.masked_scan_plain(k_off, k_docs, o["mask"],
                                      k_vals_d.abs(), mode="sums").double()
        err = (o["sums"].double() - want_s.double()).abs()
        if (err > agg_sum_tol(mass)).any():
            fail(f"aggs: K12 (sums) off its plain version by "
                 f"{float(err.max())}")
        errs["agg_masked_scan"] = max(errs.get("agg_masked_scan", 0.0),
                                      float(err.max()))
        hm = aggs.gather_mask(o["mask"], h_docs)
        if not same_bits(o["bcounts"], aggs.bucket_reduce_plain(
                h_ids, h_docs, o["mask"], n_buckets=nb)):
            fail("aggs: K14 (counts) differs from its plain version")
        want_b = aggs.bucket_reduce_plain(h_ids, h_docs, o["mask"], h_vals_d,
                                          n_buckets=nb)
        ok = hm & (h_ids >= 0) & (h_ids < nb)
        bmass = torch.zeros(nb + 1, dtype=torch.float64, device=dev) \
            .index_add_(0, torch.where(ok, h_ids.long(), nb),
                        torch.where(ok, h_vals_d.double().abs(), 0.0))[:nb]
        err = (o["bsums"].double() - want_b.double()).abs()
        if (err > agg_sum_tol(bmass)).any():
            fail(f"aggs: K14 (sums) off its plain version by "
                 f"{float(err.max())}")
        errs["agg_bucket_reduce"] = max(errs.get("agg_bucket_reduce", 0.0),
                                        float(err.max()))
        want_r = aggs.masked_scan_plain(hll["off_dev"], hll["docs_dev"],
                                        o["mask"], mode="prefix")[1]
        if not same_bits(o["regs"], aggs.register_max_plain(
                want_r, hll["off_dev"], hll["rhos_dev"])):
            fail("aggs: K13 (registers) differs from its plain version")
        regs_h = o["regs"].cpu().numpy()
        if not np.array_equal(regs_h[:hll["m"]],
                              aggs.host_register_max(hll, o["mask_h"])) or \
                regs_h[hll["m"]:].any():
            fail("aggs: HLL registers differ from host_register_max")
        want_m = aggs.metrics_plain(h_docs, h_vals_d, o["mask"])
        if not same_bits(o["metrics"][[0, 2, 3]], want_m[[0, 2, 3]]):
            fail("aggs: K15 count/min/max differ from its plain version")
        err = abs(float(o["metrics"][1]) - float(want_m[1]))
        if err > agg_sum_tol(float(torch.where(
                hm, h_vals_d.double().abs(), 0.0).sum())):
            fail(f"aggs: K15 sum off its plain version by {err}")
        errs["agg_metrics"] = max(errs.get("agg_metrics", 0.0), err)
    lo, hi, frac = aggs.hazen_ranks(counts.cpu().numpy()[top], AGG_QS)
    k13_args = (c, off_d, vals_d, torch.from_numpy(top).to(dev),
                torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
                torch.from_numpy(frac).to(dev))
    if not same_bits(aggs.rank_pick(*k13_args),
                     aggs.rank_pick_plain(*k13_args)):
        fail("aggs: K13 (pick) differs from its plain version")
    k13_edges = k13_edge_checks(off_d, docs_d, vals_d, hll, n_docs, n_pad)
    print(f"# aggs kernels == plain: K12 prefix/counts, K13 pick/registers, "
          f"K14 counts, K15 count/min/max bitwise (registers == "
          f"host_register_max); f32 sums within 2^-22 of their |v| mass: "
          f"K12 {errs['agg_masked_scan']:.3g}, K14 "
          f"{errs['agg_bucket_reduce']:.3g}, K15 {errs['agg_metrics']:.3g} "
          f"(largest |kernel - plain|); launches on the path "
          f"{ {n: v for n, v in path.items() if v} }", flush=True)
    print(f"# agg_rank_pick fallbacks == plain at a "
          f"{AGG_SPARSE:.1%} mask: pick {k13_edges['pick']} entries "
          f"(ordinal {k13_edges['empty']} with no masked pair, ordinals V "
          f"and V + 7, ranks at count - 1 of run V - 1), "
          f"{k13_edges['hi_searched']} of them hi past the 32-entry "
          f"window; registers {k13_edges['registers']} runs, "
          f"{k13_edges['window_missed']} past the run's last 32 pairs; "
          f"one launch a call", flush=True)

    # ---- times -------------------------------------------------------------
    o = other[0]
    md = o["mask"]

    def lib_k12():
        cc = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(mask_d[docs_d.long()], 0,
                                     dtype=torch.int32)])
        return cc[off_d[1:].long()] - cc[off_d[:-1].long()], cc

    def lib_k13():
        st = c[off_d[k13_args[3].long()].long()][:, None]
        tgt = torch.cat([st + k13_args[4] + 1, st + k13_args[5] + 1], 1)
        idx = torch.searchsorted(c, tgt.contiguous()) - 1
        idx = idx.clamp(0, n_docs - 1)
        return vals_d[idx]

    # the library calls take the real pairs (the padded ones add nothing)
    r_ids, r_docs, r_vals = (x[:n_docs] for x in (h_ids, h_docs, h_vals_d))

    def lib_k14():
        mm = md[r_docs.long()] & (r_ids >= 0) & (r_ids < nb)
        return torch.bincount(torch.where(mm, r_ids, nb), minlength=nb + 1)

    def lib_k15():
        mm = md[r_docs.long()]
        return (torch.aminmax(torch.where(mm, r_vals, float("inf"))),
                torch.where(mm, r_vals, 0.0).sum(), mm.sum())

    B, R = lo.shape
    # bounds count what this run's data needs: every pair's doc (and id),
    # each mask byte a real doc touches once (one pair a doc: n_docs of the
    # n_pad), values only of the pairs the kernel keeps
    n_in = int(((h_ids >= 0) & (h_ids < nb)).sum())
    n_match = int(aggs.gather_mask(md, h_docs).sum())
    rows = []
    specs = [
        ("agg_masked_scan", "csrc/agg_masked_scan.cu",
         "elasticsearch_tpu/ops/aggs.py:113",
         lambda: aggs.masked_rank_prefix(off_d, docs_d, mask_d),
         lambda: aggs.masked_scan_plain(off_d, docs_d, mask_d, mode="prefix"),
         lib_k12, "torch.cumsum + gather",
         # offsets, pair docs, mask bytes, counts, prefix
         (AGG_V + 1) * 4 + n_docs * 4 + n_docs + AGG_V * 4
         + (n_docs + 1) * 4, n_docs, {
             f"counts (CSR, {Mp} pairs)": lambda: aggs.masked_ordinal_counts(
                 k_off, k_docs, md),
             f"sums (CSR, {Mp} pairs)": lambda: aggs.masked_ordinal_sums(
                 k_off, k_docs, k_vals_d, md)}),
        ("agg_rank_pick", "csrc/agg_rank_pick.cu",
         "elasticsearch_tpu/ops/aggs.py:138",
         lambda: aggs.rank_pick(*k13_args),
         lambda: aggs.rank_pick_plain(*k13_args),
         lib_k13, "torch.searchsorted + gather",
         # ordinals, lo/hi/frac, the runs' ends, c around each answer,
         # the values picked, the result; a lerp an entry
         k13_pick_bytes(*k13_args), 3 * B * R, {
             f"registers ({hll['m']}, K12 prefix first)": lambda:
             aggs.masked_register_max(hll["off_dev"], hll["docs_dev"],
                                      hll["rhos_dev"], md)}),
        ("agg_bucket_reduce", "csrc/agg_bucket_reduce.cu",
         "elasticsearch_tpu/ops/aggs.py:73",
         lambda: aggs.masked_bucket_counts(h_ids, h_docs, md, n_buckets=nb),
         lambda: aggs.bucket_reduce_plain(h_ids, h_docs, md, n_buckets=nb),
         lib_k14, "torch.bincount (after the mask gather)",
         # ids, docs of in-range pairs, mask bytes, counts
         Mp * 4 + n_in * 4 + n_docs + nb * 4, Mp, {
             "sums": lambda: aggs.masked_bucket_sums(
                 h_ids, h_docs, h_vals_d, md, n_buckets=nb)}),
        ("agg_metrics", "csrc/agg_metrics.cu",
         "elasticsearch_tpu/ops/aggs.py:100",
         lambda: aggs.masked_metrics(h_docs, h_vals_d, md),
         lambda: aggs.metrics_plain(h_docs, h_vals_d, md),
         lib_k15, "torch.aminmax + sum (after the mask gather)",
         # docs, mask bytes, values of matched pairs, the four results
         Mp * 4 + n_docs + n_match * 4 + 16, Mp + 3 * n_match, {}),
    ]
    for (name, src, replaces, kern, plain, lib, lib_name, nbytes, nops,
         modes) in specs:
        ms = timed(kern, reps)
        plain_ms = timed(plain, 2)
        lib_ms = timed(lib, reps)
        bms, bby = bound(nbytes, nops)
        by_mode = {key: timed(fn, reps) for key, fn in modes.items()}
        rows.append(dict(
            name=name, route="cuda", source=f"elasticsearch_tpu_torch/{src}",
            replaces=replaces, max_abs_err=errs.get(name, 0.0), ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=lib_ms,
            library_call=lib_name, ms_by_mode=by_mode))
        # the route's pairs reach their docs in random order: a gathered
        # byte costs a 32-byte sector of a mask larger than L2 (the
        # histogram pairs walk the mask in doc order)
        sector = "" if name != "agg_masked_scan" else (
            f"; a 32-byte sector a gathered pair would make it "
            f"{(nbytes - n_docs + 32 * n_docs) / HBM_BPS * 1e3:.4f} ms")
        print(f"# {name}: {ms:.4f} ms (bound {bms:.5f} ms by {bby}, "
              f"{nbytes} bytes{sector}), plain {plain_ms:.3f} ms, library "
              f"({lib_name}) "
              f"{lib_ms:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in by_mode.items())
              + f" [{card}]", flush=True)
    # K14's sums mode beside its counts: its own bound (the counts' bytes
    # and the value of each pair it adds; also with 32 bytes for each
    # sector of values such pairs touch) and library call
    k14 = next(r for r in rows if r["name"] == "agg_bucket_reduce")
    hit = aggs.gather_mask(md, h_docs) & (h_ids >= 0) & (h_ids < nb)
    sectors = torch.zeros((Mp + 7) // 8, dtype=torch.bool, device=dev)
    sectors[hit.nonzero().squeeze(1) // 8] = True
    k14_bytes = Mp * 4 + n_in * 4 + n_docs + nb * 4
    n_hit, n_sectors = int(hit.sum()), int(sectors.sum())
    del hit, sectors

    def lib_k14_sums():
        mm = md[r_docs.long()] & (r_ids >= 0) & (r_ids < nb)
        return torch.bincount(torch.where(mm, r_ids, nb),
                              weights=torch.where(mm, r_vals, 0.0),
                              minlength=nb + 1)
    k14.update(
        sums_ms=k14["ms_by_mode"]["sums"],
        sums_bound_ms=bound(k14_bytes + 4 * n_hit, 0)[0],
        sums_bound_by="bytes",
        sums_bound_sector_ms=bound(k14_bytes + 32 * n_sectors, 0)[0],
        sums_library_ms=timed(lib_k14_sums, reps),
        sums_library_call="torch.bincount(weights=) after the gather "
                          "(float atomics: not the same bits run to run)")
    # K13's register mode alone on the HLL prefix, beside its bound (the
    # offsets, c at the runs' ends and around each last masked pair, its
    # rho and the registers), the library calls computing the
    # same pass (searchsorted of the runs' ends, the gather, the where)
    # and the whole masked register max (scatter_reduce_ amax after the
    # gather, K12's part too)
    k13 = next(r for r in rows if r["name"] == "agg_rank_pick")
    hc = aggs.masked_rank_prefix(hll["off_dev"], hll["docs_dev"], md)[1]
    V = hll["off_dev"].shape[0] - 1
    n_real = hll["n_pairs"]
    reg_d = torch.from_numpy(hll["reg"].astype(np.int64)).to(dev)
    hd, hr = hll["docs_dev"][:n_real], hll["rhos_dev"][:n_real]

    def lib_regs():
        return torch.zeros(hll["m"], dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, reg_d, torch.where(md[hd.long()], hr, 0),
                             "amax")
    h_off = hll["off_dev"].long()
    h_rhos = hll["rhos_dev"]

    def lib_regs_pass():
        st, en = hc[h_off[:-1]], hc[h_off[1:]]
        idx = (torch.searchsorted(hc, en) - 1).clamp(0, h_rhos.shape[0] - 1)
        return torch.where(en > st, h_rhos[idx], 0)
    k13.update(
        registers_ms=timed(lambda: aggs.register_max(hc, hll["off_dev"],
                                                     h_rhos), reps),
        registers_bound_bytes=k13_register_bytes(hc, hll["off_dev"], h_rhos),
        registers_bound_by="bytes",
        registers_library_ms=timed(lib_regs_pass, reps),
        registers_library_call="torch.searchsorted of the runs' ends + "
                               "gather + where (the same pass)",
        registers_masked_max_library_ms=timed(lib_regs, reps),
        registers_masked_max_library_call="scatter_reduce_ amax after the "
                                          "gather (the whole masked "
                                          "register max, K12's part too)")
    k13["registers_bound_ms"] = bound(k13["registers_bound_bytes"], 0)[0]
    print(f"# agg_rank_pick registers: {k13['registers_ms']:.4f} ms alone "
          f"({V} runs over the HLL prefix; bound "
          f"{k13['registers_bound_ms']:.7f} ms by bytes, "
          f"{k13['registers_bound_bytes']} bytes), library "
          f"(searchsorted + gather + where, the same pass) "
          f"{k13['registers_library_ms']:.4f} ms, the whole masked max "
          f"(scatter_reduce_ amax after the gather, K12's part too) "
          f"{k13['registers_masked_max_library_ms']:.4f} ms [{card}]",
          flush=True)
    del hc, reg_d
    print(f"# agg_bucket_reduce sums: {k14['sums_ms']:.4f} ms (bound "
          f"{k14['sums_bound_ms']:.5f} ms by bytes: the counts' "
          f"{k14_bytes} and {n_hit} values; "
          f"{k14['sums_bound_sector_ms']:.5f} ms at the {n_sectors} 32-byte "
          f"value sectors they touch), library (torch.bincount with "
          f"weights) {k14['sums_library_ms']:.4f} ms [{card}]", flush=True)
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return rows, path


# ---------------------------------------------------------------------------
# the per-segment search path (K16–K19)
# ---------------------------------------------------------------------------

#: config #1's corpus as one force-merged segment, plus a ``tag`` keyword
#: (256 ordinals, Zipf(1.1) frequencies) and a ``price`` double
#: (lognormal(3, 1)), one value a doc, numpy seed 1234
SEG_TAGS = 256
SEG_TAG_ZIPF = 1.1
SEG_TIMED = 256              # timed requests a mix (one warm-up more)
SEG_REF = 3                  # requests of a mix held against numpy
SEG_PAGES = (990, 9990)      # deep pages of (e), size 10
SEG_DEEP_K = 20_000          # a k past K19's one-launch limit (16,384)
SEG_PLANE_RTOL = 1e-6        # (e) against the f32 plane: ties within this
SEG_PROFILED = 64            # requests a mix under torch.profiler
#: the kernels redesigned since their first port, with their CUDA-event
#: means before the redesign (ms, NVIDIA H100 80GB HBM3 at 700 W) as
#: PERF.md's kernel table records them: printed as a comment, never in the
#: kernels line, which holds only this run's readings
EARLIER_MS = {"K16 bm25_scatter at (e)": 0.3892,
              "K6 knn_scan at D = 100": 1.0125,
              "K6 knn_scan at D = 768": 14.9037,
              "K9 bool_bm25_topk at (c)": 140.4444,
              "K9 bool_bm25_topk at (d)": 163.8216,
              "K9 bool_bm25_topk on the hybrid": 7.5450,
              "K8 ivf_rerank at its first port": 0.0396,
              "K8 ivf_rerank in the last run before its redesign": 0.0414,
              "K1 sparse_candidates_topk at mix (a)'s fallback": 39.454,
              "K1 sparse_candidates_topk at the headline": 0.7447,
              "K4 blockmax_scan at (a)": 6.9981,
              "K4 blockmax_scan at (b)": 0.7226,
              "K3 topk_merge, the hybrid step's four calls": 0.7350,
              "K3 topk_merge, exact kNN's three calls": 0.4367,
              "K21 knn_outlier at (l)": 39.1531,
              "K2 dense_stream_topk at the headline": 3.8095,
              "K12 agg_masked_scan, the route's prefix": 4.9246,
              "K12 agg_masked_scan, the caches' counts": 2.4039,
              "K12 agg_masked_scan, the caches' sums": 2.4962,
              "K22 logreg_train, (m)'s 500 steps": 10.156,
              "K14 agg_bucket_reduce, the caches' sums": 3.8224,
              "K19 segment_topk at (e), k = 10": 0.2376,
              "K19 segment_topk at (i), k = 1,000": 0.2503,
              "K19 segment_topk at (i), k = 10,000": 0.4100,
              "K7 ivf_scan, its chunk lists alone": 0.1012,
              "K5 bisect_exact_scores at (a)": 0.0411,
              "K5 bisect_exact_scores at (b)": 0.0325,
              "K10 fuse_rank (rrf, windows 100)": 0.0522,
              "K10 fuse_rank (sum, windows 100)": 0.0371,
              "K11 rescore_reorder on the hybrid rescore": 0.0483,
              "K11 rescore_reorder on the bool rescore": 0.0511,
              "K20 tree_eval at (j)": 0.0419}
#: the K16–K19 wrappers the per-segment path calls, by their kernel entry
SEG_KERNELS = {"bm25_score": "bm25_scatter",
               "postings_match": "postings_match",
               "range_mask": "range_mask", "masked_topk": "segment_topk"}


def timed_requests(call, n):
    """Requests 1..n of ``call``, one at a time (each ends with its result
    on the host): (host-clock seconds each, the outputs)."""
    lat, out = np.zeros(n), []
    for i in range(n):
        t1 = time.perf_counter()
        out.append(call(i + 1))
        lat[i] = time.perf_counter() - t1
    return lat, out


def latency_stats(lat, n_req):
    """Requests/s (``n_req`` requests a call), mean, p50, p99 and max."""
    return dict(
        qps=n_req * lat.size / float(lat.sum()),
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        mean_ms=float(lat.mean()) * 1e3, max_ms=float(lat.max()) * 1e3,
        requests=int(lat.size))


def device_busy(call, first, n):
    """(ms the card was busy, wall ms, device events) over requests
    first..first+n-1 of ``call`` under ``torch.profiler``: busy is the
    union of the device events' intervals, None when the profiler recorded
    no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            call(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, wall, 0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3, wall, len(spans)


def device_ms_by_name(call, n):
    """Device ms a call of ``call``, by kernel (or memset, copy) name, over
    ``n`` calls under ``torch.profiler``; empty when the profiler recorded
    no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0]
            by[name] = by.get(name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3 / n
    return by


def device_events_a_call(call, n):
    """Device events (kernels, memsets, copies) ``torch.profiler`` records
    a call of ``call``, over ``n`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events()) / n


def segment_plain(name, args, kw):
    """The plain version of a recorded K16–K19 wrapper call, on the same
    inputs."""
    from elasticsearch_tpu_torch.ops.bm25 import bm25_score_plain
    from elasticsearch_tpu_torch.ops.masks import (postings_match_plain,
                                                   range_mask_plain)
    from elasticsearch_tpu_torch.ops.topk import masked_topk_plain
    if name == "bm25_score":
        return bm25_score_plain(*args, **kw)
    if name == "postings_match":
        return (postings_match_plain(*args, **kw),)
    if name == "range_mask":
        v, d, lo, hi = args
        conv = float if v.is_floating_point() else int
        return (range_mask_plain(v, d, conv(lo), conv(hi), **kw),)
    return masked_topk_plain(*args, **kw)


def segment_columns(n_docs):
    """The ``tag`` ordinals and ``price`` values, one a doc (seed 1234)."""
    rng = np.random.RandomState(1234)
    p = np.arange(1, SEG_TAGS + 1, dtype=np.float64) ** -SEG_TAG_ZIPF
    tag = rng.choice(SEG_TAGS, n_docs, p=p / p.sum()).astype(np.int32)
    price = rng.lognormal(3.0, 1.0, n_docs)
    return tag, price


def body_field_state(corpus):
    """A CSR corpus as the host state of a segment's ``body`` text field
    (terms ``w{tid}``, which the standard analyzer keeps). Positions are
    zero placeholders (no positional query runs)."""
    P = corpus["docs"].shape[0]
    dl = corpus["doc_len"]
    return dict(
        term_ids={f"w{t}": t for t in range(VOCAB)}, df=corpus["df"],
        offsets=corpus["offsets"], docs_host=corpus["docs"],
        tf_host=corpus["tf"], doc_len_host=dl, sum_dl=float(dl.sum()),
        field_doc_count=int(np.count_nonzero(dl)),
        total_term_freq=np.zeros(VOCAB, np.int64),
        pos_offsets=np.zeros(P + 1, np.int64),
        pos_flat=np.zeros(0, np.int32))


def segment_index(corpus, tag, price, dev):
    """Config #1's CSR as the ``body`` field of one segment (terms
    ``w{tid}``, which the standard analyzer keeps), with the ``tag`` and
    ``price`` columns, built directly as a host state. Positions are zero
    placeholders (no positional query runs)."""
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import segment_from_host_state
    n = corpus["doc_len"].shape[0]
    body = body_field_state(corpus)
    df = np.bincount(tag, minlength=SEG_TAGS).astype(np.int32)
    offsets = np.zeros(SEG_TAGS + 1, np.int64)
    np.cumsum(df, out=offsets[1:])
    names = [f"tag{o:03d}" for o in range(SEG_TAGS)]
    kw = dict(
        ord_terms=names, term_ords={t: o for o, t in enumerate(names)},
        df=df, offsets=offsets,
        docs_host=np.argsort(tag, kind="stable").astype(np.int32),
        dv_ords_host=tag, dv_docs_host=np.arange(n, dtype=np.int32))
    num = dict(base=float(price.min()), vals_host=price,
               docs_host=np.arange(n, dtype=np.int32))
    seg = segment_from_host_state(dict(
        seg_id="_0", n_docs=n, doc_uids=[str(i) for i in range(n)],
        sources=[None] * n, seq_nos=np.arange(n, dtype=np.int64),
        text_fields={"body": body}, keyword_fields={"tag": kw},
        numeric_fields={"price": num}), device=dev)
    mapper = MapperService({"properties": {
        "body": {"type": "text"}, "tag": {"type": "keyword"},
        "price": {"type": "double"}}})
    return seg, mapper


def check_page(res, ref, start, size, what, rtol=REF_RTOL):
    """A page of hits against the reference's ranking ``ref`` (as
    ``exact_bm25`` gives it, ranked past ``start + size``) from ``start``:
    the number of hits and the total exact, then ``check_topk``; the
    reference's hit before the page rides along, so that the page's first
    hit is judged separated against it."""
    top, sc, total = ref
    n = max(0, min(size, total - start))
    if res.total != total or res.total_relation != "eq":
        fail(f"{what}: total {res.total} ({res.total_relation}) != {total}")
    if len(res.hits) != n:
        fail(f"{what}: {len(res.hits)} hits, expected {n}")
    if not n:
        return
    lo = max(start - 1, 0)
    got_d = np.asarray(list(top[lo:start]) + [h.local_doc for h in res.hits])
    got_s = np.asarray(list(sc[lo:start]) + [h.score for h in res.hits])
    check_topk(got_s[None], got_d[None], sc[None, lo:start + n],
               top[None, lo:start + n], sc[start + n:start + n + 1], rtol,
               0.0, what)


def run_segment(card, corpus, *, n_timed=SEG_TIMED, reps=10):
    """Phase 5: the per-segment search path (``ShardSearcher.search`` on one
    force-merged segment of config #1's corpus) with K16–K19. Returns their
    rows and the path's launch counts."""
    import torch
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.bm25 import (bm25_score,
                                                  bm25_score_plain)
    from elasticsearch_tpu_torch.ops.masks import (
        postings_match, postings_match_plain, range_mask, range_mask_plain)
    from elasticsearch_tpu_torch.ops.topk import (masked_topk,
                                                  masked_topk_plain)
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher

    dev = torch.device("cuda")
    n_docs = corpus["doc_len"].shape[0]
    t0 = time.perf_counter()
    tag, price = segment_columns(n_docs)
    seg, mapper = segment_index(corpus, tag, price, dev)
    searcher = ShardSearcher([seg], mapper)
    torch.cuda.synchronize()
    seg_bytes = sum(t.nbytes for f in (*seg.text_fields.values(),
                                       *seg.keyword_fields.values(),
                                       *seg.numeric_fields.values())
                    for t in vars(f).values()
                    if isinstance(t, torch.Tensor)) + seg.live_dev.nbytes
    print(f"# segment (config #1 force-merged): {n_docs} docs, n_pad "
          f"{seg.n_pad}, {corpus['docs'].shape[0]} postings, tag "
          f"{SEG_TAGS} Zipf({SEG_TAG_ZIPF}) ordinals, price lognormal(3, 1);"
          f" {seg_bytes / 2**30:.3f} GiB on {dev} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- traffic: four terms ∝ df (phase 1's sampler) and the filters ---
    rng = np.random.RandomState(4321)
    bags = [[f"w{t[1:]}" for t in q] for q in
            sample_queries(rng, corpus, 1, batch=n_timed + 1)[0]]
    p25, p75 = (float(x) for x in np.percentile(price, [25, 75]))
    top_tags = np.argsort(-np.bincount(tag, minlength=SEG_TAGS))[:32]
    names = [f"tag{o:03d}" for o in range(SEG_TAGS)]

    def bool_parts(i):
        r = np.random.RandomState(100 + i)
        three = [int(x) for x in r.choice(top_tags, 3, replace=False)]
        return three, three[2]

    def match(i, **opts):
        return {"match": {"body": dict(query=" ".join(bags[i]), **opts)}}

    def bool_body(i):
        three, excl = bool_parts(i)
        return {"bool": {
            "must": match(i),
            "filter": [{"terms": {"tag": [names[o] for o in three]}},
                       {"range": {"price": {"gte": p25, "lt": p75}}}],
            "must_not": {"term": {"tag": names[excl]}}}}

    def tag_range(i):
        r = np.random.RandomState(200 + i)
        lo = int(r.randint(0, SEG_TAGS - 40))
        return lo, lo + int(r.randint(1, 40))

    def bool_mask(i):
        three, excl = bool_parts(i)
        return (np.isin(tag, three) & (tag != excl) & (price >= p25)
                & (price < p75))

    mixes = {
        "e": lambda i: searcher.search({"query": match(i), "size": 10}),
        "f": lambda i: searcher.search(
            {"query": match(i, operator="and"), "size": 10}),
        "g": lambda i: searcher.search({"query": bool_body(i), "size": 10}),
        "h": lambda i: (searcher.search({"query": {"range": {"tag": {
            "gte": names[tag_range(i)[0]], "lt": names[tag_range(i)[1]]}}},
            "size": 10}), searcher.count({"query": bool_body(i)})),
        "i": lambda i: (
            searcher.search({"query": match(i), "from": SEG_PAGES[0],
                             "size": 10}),
            searcher.search({"query": match(i), "from": SEG_PAGES[1],
                             "size": 10})),
    }
    seg_k = tuple(SEG_KERNELS.values())
    required = {"e": ("bm25_scatter", "segment_topk"),
                "f": ("bm25_scatter", "segment_topk"),
                "g": seg_k, "h": seg_k,
                "i": ("bm25_scatter", "segment_topk")}
    from elasticsearch_tpu_torch.ops import bm25 as bm25_mod
    from elasticsearch_tpu_torch.ops import masks as masks_mod
    from elasticsearch_tpu_torch.ops import topk as topk_mod
    seg_mods = (bm25_mod, masks_mod, topk_mod)
    n_req = {name: 2 if name in ("h", "i") else 1 for name in mixes}
    counts, results, calls, stats = {}, {}, {}, {}
    for name, call in mixes.items():
        kb.reset_launches()
        rec = []
        with recording(rec, SEG_KERNELS, seg_mods):
            call(0)                                   # warm-up, recorded
        torch.cuda.synchronize()
        lat, out = timed_requests(call, n_timed)
        c = {k: v for k, v in kb.launches.items() if v}
        missing = [k for k in required[name] if not c.get(k)]
        if missing:
            fail(f"segment mix ({name}): {missing} never launched: {c}")
        counts[name], results[name], calls[name] = c, out, rec
        st = latency_stats(lat, n_req[name])
        st["launches_per_request"] = {
            k: v / ((n_timed + 1) * n_req[name]) for k, v in c.items()}
        stats[name] = st
        unit = "request pairs" if n_req[name] == 2 else "requests"
        print(f"# segment ({name}): {st['qps']:.1f} q/s, p50 "
              f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms, max "
              f"{st['max_ms']:.3f} ms over {st['requests']} {unit}; "
              f"launches a request {st['launches_per_request']} [{card}]",
              flush=True)

    # ---- where a request's time goes --------------------------------------
    for name, call in mixes.items():
        busy, wall, events = device_busy(call, 1, SEG_PROFILED)
        stats[name]["profiled"] = dict(
            requests=SEG_PROFILED, device_busy_ms=busy, wall_ms=wall,
            device_events=events)
        if busy is None:
            share = "not measured"
        else:
            unprof = SEG_PROFILED * stats[name]["mean_ms"]
            share = (f"{busy:.3f} ms busy over {SEG_PROFILED} requests; "
                     f"busy share {busy / wall:.3f} of the profiled wall, "
                     f"{busy / unprof:.3f} of {SEG_PROFILED} x the "
                     f"unprofiled mean; device events a request "
                     f"{events / SEG_PROFILED:.1f}")
        print(f"# segment ({name}): {share} (torch.profiler) [{card}]",
              flush=True)
    uniq = seg.numeric_fields["price"].uniq_vals
    t1 = time.perf_counter()
    for _ in range(5):
        int(np.isnan(uniq).sum())
    nan_ms = (time.perf_counter() - t1) / 5 * 1e3
    print(f"# segment host: a numeric range's NaN count over the "
          f"{uniq.size} distinct prices {nan_ms:.3f} ms a request",
          flush=True)
    stats["host"] = dict(range_nan_count_ms=nan_ms)

    # ---- each recorded kernel call against its plain version -------------
    errs = {k: 0.0 for k in seg_k}
    n_checked = {k: 0 for k in seg_k}
    for name, rec in calls.items():
        for wrapper, args, kw, out in rec:
            entry = SEG_KERNELS[wrapper]
            got = out if isinstance(out, tuple) else (out,)
            want = segment_plain(wrapper, args, kw)
            errs[entry] = max(errs[entry], check_bitwise(
                got, want, f"segment ({name}): {entry}"))
            n_checked[entry] += 1
    if not all(n_checked.values()):
        fail(f"a segment kernel was never checked: {n_checked}")
    print(f"# segment kernels equal their plain versions on every call of "
          f"each mix's first request: {n_checked} (K16 scores bitwise and "
          f"counts exact, K17 and K18 exact, K19 bitwise)", flush=True)

    # ---- the hits against numpy, (e) against the f32 plane ---------------
    dl = corpus["doc_len"]
    avgdl = float(dl.sum()) / int(np.count_nonzero(dl))
    for name in "efghi":
        for i in range(1, SEG_REF + 1):
            res = results[name][i - 1]
            what = f"segment ({name}) request {i}"
            if name == "h":
                lo, hi = tag_range(i)
                hit = (tag >= lo) & (tag < hi)
                # constant scores: the first docs in order
                docs = np.flatnonzero(hit)[:11]
                sc = np.where(np.arange(11) < docs.size, 1.0, -np.inf)
                docs = np.concatenate([docs, np.zeros(11 - docs.size, int)])
                check_page(res[0], (docs, sc, int(hit.sum())), 0, 10, what)
                if [h.local_doc for h in res[0].hits] != \
                        docs[:len(res[0].hits)].tolist():
                    fail(f"{what}: equal scores not in doc order")
                _, _, n_b = exact_bm25(corpus, bags[i], 10, avgdl=avgdl,
                                       mask=bool_mask(i))
                if res[1] != n_b:
                    fail(f"{what}: count {res[1]} != {n_b}")
                continue
            deep = SEG_PAGES[-1] + 10 if name == "i" else 10
            ref = exact_bm25(corpus, bags[i], deep, and_=name == "f",
                             mask=bool_mask(i) if name == "g" else None,
                             avgdl=avgdl)
            if name == "i":
                for page, start in zip(res, SEG_PAGES):
                    check_page(page, ref, start, 10, f"{what} from {start}")
            else:
                check_page(res, ref, 0, 10, what)
    print(f"# segment: {SEG_REF} requests of each mix agree with the numpy "
          f"exact reference (scores within {REF_RTOL:.0%}, docs at "
          f"separated ranks, totals and counts exact)", flush=True)

    t1 = time.perf_counter()
    plane = DistributedSearchPlane([corpus], "body", device=dev,
                                   dense_threshold=n_docs + 1)
    if plane.T_pad:
        fail("the f32 plane has a dense tier")
    pv, ph = [], []
    for b0 in range(1, n_timed + 1, BATCH):
        v, h = plane.search([[f"t{t[1:]}" for t in b]
                             for b in bags[b0:min(b0 + BATCH, n_timed + 1)]],
                            k=11)
        pv += list(v)
        ph += list(h)
    for i, res in enumerate(results["e"]):
        n = min(10, len(ph[i]))
        d2 = np.asarray([d for _, d in ph[i]])
        v2 = np.asarray(pv[i][:len(ph[i])], np.float64)
        if len(res.hits) != n:
            fail(f"segment (e) request {i + 1}: {len(res.hits)} hits, the "
                 f"plane's {n}")
        check_topk(np.asarray([[h.score for h in res.hits]]),
                   np.asarray([[h.local_doc for h in res.hits]]),
                   v2[None, :n], d2[None, :n],
                   v2[n:n + 1] if v2.size > n else [-np.inf], 1e-5, 0.0,
                   f"segment (e) request {i + 1} against the plane",
                   sep_rtol=SEG_PLANE_RTOL)
    del plane
    torch.cuda.empty_cache()
    print(f"# segment (e): {n_timed} requests' top 10 equal the f32 plane's "
          f"search (no dense tier) where scores are separated by more than "
          f"{SEG_PLANE_RTOL:g} ({time.perf_counter() - t1:.1f} s)",
          flush=True)

    # ---- times -------------------------------------------------------------
    def first(name, wrapper, pick=None):
        for w, args, kw, out in calls[name]:
            if w == wrapper and (pick is None or pick(kw, args)):
                return kw, args, out
        fail(f"no {wrapper} call recorded in mix ({name})")

    n_pad = seg.n_pad
    rows = []
    # K16: (e)'s match (text field)
    kw, a, out = first("e", "bm25_score")
    lens = np.minimum(np.asarray(a[4]), kw["L"])
    V = int(lens.sum())
    D = int(torch.count_nonzero(out[1]))
    st = np.asarray(a[3])
    flat = torch.cat([a[0][int(s):int(s) + int(n)]
                      for s, n in zip(st, lens)]).long()
    contrib = torch.rand(V, device=dev)
    acc = torch.zeros(n_pad, device=dev)

    def lib_k16():
        acc.index_add_(0, flat, contrib)
    # docs, tf and a doc length a valid posting; the doc lengths of the
    # docs touched; scores and counts written once
    specs = [("bm25_scatter", "csrc/bm25_scatter.cu",
              "elasticsearch_tpu/ops/bm25.py:40",
              lambda a=a, kw=kw: bm25_score(*a, **kw),
              lambda a=a, kw=kw: bm25_score_plain(*a, **kw), lib_k16,
              "index_add_ of precomputed contributions into one array: no "
              "counts, no zeroing, no contribution arithmetic",
              8 * V + 4 * D + 8 * n_pad, 10 * V, {})]
    # K17: (g)'s terms filter
    kw, a, out = first("g", "postings_match")
    lens = np.minimum(np.asarray(a[2]), kw["L"])
    V17 = int(lens.sum())
    flat17 = torch.cat([a[0][int(s):int(s) + int(n)]
                        for s, n in zip(np.asarray(a[1]), lens)]).long()
    # one prefix run: the postings from the first of (g)'s runs to the end
    # of its last, as a prefix query passes them
    st17 = np.asarray(a[1], np.int64)
    span = int((st17 + lens).max() - st17.min())
    prefix_run = (a[0], np.asarray([st17.min()], np.int32),
                  np.asarray([span], np.int32))
    prefix_kw = dict(segment_pad=n_pad, L=1 << max(span - 1, 0).bit_length())
    specs.append(("postings_match", "csrc/postings_match.cu",
                  "elasticsearch_tpu/ops/masks.py:16",
                  lambda a=a, kw=kw: postings_match(*a, **kw),
                  lambda a=a, kw=kw: postings_match_plain(*a, **kw),
                  lambda: torch.bincount(flat17, minlength=n_pad),
                  "torch.bincount", 4 * V17 + 4 * n_pad, V17,
                  {f"one prefix run of {span}": lambda: postings_match(
                      *prefix_run, **prefix_kw)}))
    # K18: (g)'s price range (i32 ranks); (h)'s tag range (f32 ordinals)
    kw, a, out = first("g", "range_mask")
    kwh, ah, _ = first("h", "range_mask",
                       lambda k, x: x[0].is_floating_point())
    M = a[0].shape[0]
    hit18 = (a[0] >= int(a[2])) & (a[0] <= int(a[3]))
    m18 = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    d18 = a[1].long()

    def lib_k18():
        m18.scatter_reduce_(0, d18, hit18.to(torch.uint8), "amax")
    specs.append(("range_mask", "csrc/range_mask.cu",
                  "elasticsearch_tpu/ops/masks.py:34",
                  lambda a=a, kw=kw: range_mask(*a, **kw),
                  lambda a=a, kw=kw: range_mask_plain(
                      a[0], a[1], int(a[2]), int(a[3]), **kw),
                  lib_k18, "scatter_reduce_ amax (after the compare)",
                  8 * M + n_pad, 2 * M,
                  {"keyword f32 (h)": lambda: range_mask(*ah, **kwh)}))
    # K19: (e)'s k = 10; the deep pages' k = 1,000 and 10,000
    _, a, out = first("e", "masked_topk")
    k = a[2]
    by_k = {}
    for start in SEG_PAGES:
        _, ak, _ = first("i", "masked_topk",
                         lambda kw, x, kk=start + 10: x[2] == kk)
        by_k[f"k={start + 10}"] = lambda x=ak: masked_topk(*x)
    specs.append(("segment_topk", "csrc/segment_topk.cu",
                  "elasticsearch_tpu/ops/topk.py:23",
                  lambda a=a: masked_topk(*a),
                  lambda a=a: masked_topk_plain(*a),
                  lambda a=a: torch.topk(torch.where(
                      a[1], a[0], torch.full_like(a[0], -np.inf)), a[2]),
                  "torch.topk (after the where)",
                  5 * n_pad + 8 * k, n_pad, by_k))
    for (name, src, replaces, kern, plain, lib, lib_name, nbytes, nops,
         modes) in specs:
        ms = timed(kern, reps)
        plain_ms = timed(plain, 2)
        lib_ms = timed(lib, reps)
        bms, bby = bound(nbytes, nops)
        by_mode = {key: timed(f, reps) for key, f in modes.items()}
        rows.append(dict(
            name=name, route="cuda", source=f"elasticsearch_tpu_torch/{src}",
            replaces=replaces, max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=lib_ms,
            library_call=lib_name, ms_by_mode=by_mode))
        if name == "bm25_scatter":
            # the pre-pass's and the tile kernel's device time a call
            rows[-1]["ms_by_launch"] = device_ms_by_name(kern, reps)
        if name == "postings_match":
            # one cooperative launch a call: its device time and events
            rows[-1]["device_ms"] = sum(device_ms_by_name(kern,
                                                          reps).values())
            rows[-1]["device_events_a_call"] = device_events_a_call(kern,
                                                                    reps)
        if name == "segment_topk":
            # device time and device events (launches) a call, by k
            by_k = {f"k={a[2]}": kern, **modes}
            rows[-1]["device_ms_by_k"] = {
                key: sum(device_ms_by_name(f, reps).values())
                for key, f in by_k.items()}
            rows[-1]["device_events_a_call_by_k"] = {
                key: device_events_a_call(f, reps)
                for key, f in by_k.items()}
            # the multi-launch path (k > 16,384) on (e)'s scores and mask
            deep = (a[0], a[1], SEG_DEEP_K)
            n0 = kb.launches["segment_topk"]
            got = masked_topk(*deep)
            torch.cuda.synchronize()
            if kb.launches["segment_topk"] != n0 + 1:
                fail("K19 at k > 16,384: not one launch a call")
            deep_err = check_bitwise(got, masked_topk_plain(*deep),
                                     f"K19 segment_topk at k={SEG_DEEP_K}")
            rows[-1]["deep_k"] = dict(
                k=SEG_DEEP_K, launches=1, max_abs_err=deep_err,
                ms=timed(lambda: masked_topk(*deep), reps),
                device_ms=sum(device_ms_by_name(
                    lambda: masked_topk(*deep), reps).values()))
            print(f"# segment_topk at k={SEG_DEEP_K} (the multi-launch "
                  f"path): equal to its plain version bitwise, "
                  f"{rows[-1]['deep_k']['ms']:.4f} ms, on the card "
                  f"{rows[-1]['deep_k']['device_ms']:.4f} ms", flush=True)
        print(f"# {name}: {ms:.4f} ms (bound {bms:.5f} ms by {bby}, "
              f"{nbytes} bytes), plain {plain_ms:.3f} ms, library "
              f"({lib_name}) {lib_ms:.4f} ms"
              + "".join(f", {k} {v:.4f} ms" for k, v in by_mode.items())
              + "".join(f", {k} {v:.4f} ms" for k, v in
                        rows[-1].get("ms_by_launch", {}).items())
              + "".join(f", on the card at {k} {v:.4f} ms" for k, v in
                        rows[-1].get("device_ms_by_k", {}).items())
              + (f", on the card {rows[-1]['device_ms']:.4f} ms, device "
                 f"events a call {rows[-1]['device_events_a_call']:.2f}"
                 if name == "postings_match" else "")
              + "".join(f", device events a call at {k} {v:.2f}" for k, v in
                        rows[-1].get("device_events_a_call_by_k",
                                     {}).items())
              + f" [{card}]", flush=True)
    print(f"# K16 inputs: {V} valid postings over {D} docs; K17: {V17} "
          f"postings; K18: {M} pairs")
    print(f"# segment mixes: {json.dumps(stats)}")
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    path = {k: 0 for k in kb.launches}
    for c in counts.values():
        for k, v in c.items():
            path[k] += v
    return rows, path, (seg, mapper)


#: the serving route (config #1 through ``ShardSearcher`` with a
#: ``ServingPlaneCache``): ``bench.py:bench_serving``'s 32 client threads
SRV_CLIENTS = 32
SRV_REQUESTS = 2048          # requests a mix (64 a client)
SRV_WARM = 32                # untimed requests a mix first (one a client)
SRV_PROFILED = 512           # requests of mix (s1) under torch.profiler
SRV_DELTA_DOCS = 1 << 16     # the appended segment (seed 1235): 0.8 %
SRV_DELTA_REQUESTS = 512
SRV_KERNELS = ("blockmax_scan", "bisect_exact_scores", "topk_merge")


def check_response(res, ref, offsets, exact_total, what):
    """One response's top 10 against the numpy reference (``ref`` as
    ``exact_bm25`` gives it): min(10, matches) hits, scores within
    REF_RTOL, docs equal at separated ranks; the total exact when the
    response says ``eq``, and never above the exact count."""
    top, sc, n_match = ref
    n = min(K, n_match)
    if len(res.hits) != n:
        fail(f"{what}: {len(res.hits)} hits, expected {n}")
    got_d = np.asarray([offsets[h.seg_idx] + h.local_doc for h in res.hits])
    got_s = np.asarray([h.score for h in res.hits])
    check_topk(got_s[None], got_d[None], sc[None, :n], top[None, :n],
               sc[n:n + 1], REF_RTOL, 0.0, what)
    if res.total > n_match or (res.total_relation == "eq"
                               and res.total != n_match):
        fail(f"{what}: total {res.total} ({res.total_relation}), exact "
             f"{n_match}")
    if exact_total and (res.total, res.total_relation) != (n_match, "eq"):
        fail(f"{what}: total {res.total} ({res.total_relation}) is not "
             f"the exact {n_match}")


def client_traffic(search, bodies, n_clients=SRV_CLIENTS):
    """``bodies`` through ``search`` from ``n_clients`` threads, client c
    sending bodies c, c + n_clients, ... one at a time: (host-clock
    seconds a request, the responses in body order, wall seconds, each
    request's start in seconds after the window's). The first error fails
    the run."""
    import threading
    lat = np.zeros(len(bodies))
    began = np.zeros(len(bodies))
    out = [None] * len(bodies)
    errors = []
    start = threading.Barrier(n_clients + 1)

    def client(c):
        try:
            start.wait()
            for i in range(c, len(bodies), n_clients):
                t1 = time.perf_counter()
                out[i] = search(bodies[i])
                lat[i] = time.perf_counter() - t1
                began[i] = t1
        except BaseException as e:   # noqa: BLE001 — failed below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"a serving request raised: {errors[0]!r}")
    return lat, out, wall, began - t0


@contextlib.contextmanager
def gc_pauses(out):
    """The garbage collector's pauses while the block runs, in seconds by
    generation, into ``out`` (a full collection walks every container the
    process holds, the segment's 2^23 doc ids among them, with the GIL
    held)."""
    import gc
    start = [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            out.setdefault(info["generation"], []).append(
                time.perf_counter() - start[0])

    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def run_serving(card, corpus, seg, mapper, *, reps=10):
    """Phase 6: config #1's text serving route as users reach it:
    ``ShardSearcher.search`` with a ``ServingPlaneCache``'s ``plane_for``
    as its ``plane_provider``, 32 client threads, the micro-batcher's
    dispatches into ``DistributedSearchPlane.serve``. Returns the route's
    launch counts and its numbers."""
    import torch
    from elasticsearch_tpu_torch.common.breakers import DEFAULT as breakers
    from elasticsearch_tpu_torch.index.segment import segment_from_host_state
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.blockmax import blockmax_scan_plain
    from elasticsearch_tpu_torch.ops.fused_query import \
        bisect_exact_scores_plain
    from elasticsearch_tpu_torch.parallel import dist_search as ds_mod
    from elasticsearch_tpu_torch.search.plane_route import ServingPlaneCache
    from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast

    dev = torch.device("cuda")
    n0 = seg.n_docs
    acct = breakers.breaker("accounting")
    used0 = acct.stats()["estimated_size_in_bytes"]

    # ---- cold build: the breakers at their defaults, which a cache on the
    # card widens by the card's memory ------------------------------------
    cache = ServingPlaneCache(device=dev)
    if acct.limit < torch.cuda.mem_get_info()[1]:
        fail(f"serving: the accounting breaker's limit {acct.limit} B is "
             f"below the card's memory")
    t0 = time.perf_counter()
    gen = cache.plane_for([seg], mapper, "body")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if gen is None or gen.base.blockmax is None or not gen.base.T_pad:
        fail("serving: the cold build gave no generation with a block-max "
             "and a dense tier")
    plane = gen.base
    reserved = acct.stats()["estimated_size_in_bytes"] - used0
    out = dict(build_s=build_s, plane_bytes=plane.device_corpus_bytes(),
               breaker_reserved_bytes=reserved,
               blockmax_blocks=plane.blockmax.n_blocks,
               dense_rows=plane.T_pad, avgdl=gen.avgdl)
    print(f"# serving cold build: plane_for([_0]) {build_s:.1f} s, plane "
          f"{out['plane_bytes'] / 2**30:.3f} GiB on {dev} (dense tier "
          f"{plane.T_pad} rows, block-max tier {plane.blockmax.n_blocks} "
          f"blocks of {plane.blockmax.block}), accounting breaker reserved "
          f"{reserved} B of its {acct.limit} B limit, avgdl frozen at "
          f"{gen.avgdl:.4f} [{card}]", flush=True)

    # ---- traffic: four terms ∝ df (s1, s2) and uniform tail terms (s3) ---
    rng = np.random.RandomState(4322)
    n_all = SRV_WARM + SRV_REQUESTS
    heavy = [[f"w{t[1:]}" for t in q]
             for q in sample_queries(rng, corpus, 1, batch=n_all)[0]]
    tail = [[f"w{t[1:]}" for t in q]
            for q in sample_queries(rng, corpus, 1, batch=n_all,
                                    weighted=False)[0]]

    def body(terms, **kw):
        return dict({"query": {"match": {"body": " ".join(terms)}},
                     "size": K}, **kw)

    # (s1), (s3): Elasticsearch's default bounded total tracking, under
    # which the route prunes; (s2): exact totals (the searcher's own
    # default), which serve eagerly
    mixes = {"s1": [body(q, track_total_hits=10000) for q in heavy],
             "s2": [body(q, track_total_hits=True) for q in heavy],
             "s3": [body(q, track_total_hits=10000) for q in tail]}
    bags = {"s1": heavy, "s2": heavy, "s3": tail}
    searcher = ShardSearcher([seg], mapper,
                             plane_provider=lambda s, f: cache.plane_for(
                                 s, mapper, f), device=dev)
    if searcher.search(mixes["s1"][0]).hits == []:
        fail("serving: the first request found nothing")
    batcher = gen._microbatcher

    # every dispatch's batch and output, for the replay check
    dispatched = []
    serve_view = gen.serve_view

    def recorded_view(queries, k=10, **kw):
        res = serve_view(queries, k=k, **kw)
        # the pruned step reports its block counts in the stages
        st = kw.get("stages") or {}
        pruned = "lex_blocks_total" in st
        dispatched.append((list(queries), k, kw.get("prune"), res, pruned,
                           st.get("unsafe", 0)))
        return res

    gen.serve_view = recorded_view
    counts, stats, responses, calls = {}, {}, {}, []
    for name, bodies in mixes.items():
        b0 = batcher.stats_doc()
        t_stage0 = dict(batcher.stage_totals_ms)
        n_disp0 = len(dispatched)
        kb.reset_launches()
        rec = []
        gcs = {}
        with recording(rec, SRV_KERNELS, (ds_mod,)):
            client_traffic(searcher.search, bodies[:SRV_WARM])
            with gc_pauses(gcs):
                lat, res, wall, began = client_traffic(searcher.search,
                                                       bodies[SRV_WARM:])
        torch.cuda.synchronize()
        c = {k: v for k, v in kb.launches.items() if v}
        b1 = batcher.stats_doc()
        n_d = b1["dispatches"] - b0["dispatches"]
        n_q = b1["queries"] - b0["queries"]
        st = latency_stats(lat, 1)
        st.update(
            qps=len(bodies[SRV_WARM:]) / wall, wall_s=wall, dispatches=n_d,
            mean_batch=n_q / max(n_d, 1), max_batch=batcher.max_seen_batch,
            stage_mean_ms={s: (batcher.stage_totals_ms[s] - t_stage0[s])
                           / max(n_q, 1) for s in batcher.stage_totals_ms},
            stage_p50_ms={s: float(np.percentile(
                list(batcher.stage_samples[s])[-n_q:], 50))
                for s in batcher.stage_samples},
            launches_per_dispatch={k: v / max(n_d, 1) for k, v in c.items()},
            pruned_dispatches=sum(d[4] for d in dispatched[n_disp0:]),
            # queries a pruned dispatch could not certify (re-served by
            # the eager step inside the same dispatch)
            unsafe_queries=sum(d[5] for d in dispatched[n_disp0:]),
            # where the slowest 1 % of requests started in the window
            slowest_start_s=float(np.median(
                began[lat >= np.percentile(lat, 99)])),
            # collections in the timed window: count, total and longest
            # ms by generation
            gc_pauses={g: dict(n=len(v), total_ms=1e3 * sum(v),
                               max_ms=1e3 * max(v))
                       for g, v in sorted(gcs.items())},
            relations={r: sum(x.total_relation == r for x in res)
                       for r in ("eq", "gte")})
        counts[name], stats[name], responses[name] = c, st, res
        calls.append((name, rec, dispatched[n_disp0:]))
        print(f"# serving ({name}): {st['qps']:.1f} requests/s, p50 "
              f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms, max "
              f"{st['max_ms']:.3f} ms over {st['requests']} requests from "
              f"{SRV_CLIENTS} clients; {n_d} dispatches, mean batch "
              f"{st['mean_batch']:.2f}, largest {st['max_batch']}; "
              f"{st['pruned_dispatches']} pruned ({st['unsafe_queries']} "
              f"queries re-served eagerly in them); totals "
              f"{st['relations']}; the slowest 1 % started at a median "
              f"{st['slowest_start_s']:.3f} s of the {wall:.3f} s window; "
              f"garbage collections (generation: count, total / longest ms) "
              + ", ".join(f"{g}: {v['n']}, {v['total_ms']:.1f} / "
                          f"{v['max_ms']:.1f}"
                          for g, v in st["gc_pauses"].items())
              + f" [{card}]", flush=True)
        print(f"# serving ({name}) stages (mean ms a request): " + ", ".join(
            f"{s} {v:.3f}" for s, v in st["stage_mean_ms"].items())
            + "; launches a dispatch " + json.dumps(
                {k: round(v, 3) for k, v in
                 st["launches_per_dispatch"].items()}), flush=True)
    path = {k: 0 for k in kb.launches}
    for c in counts.values():
        for k, v in c.items():
            path[k] += v
    missing = [k for k in EAGER_KERNELS + PRUNED_KERNELS if not path[k]]
    if missing:
        fail(f"serving: {missing} never launched on the route: {path}")

    # ---- the card's busy share under (s1) traffic ------------------------
    busy, wall_ms, events = device_busy(
        lambda i: client_traffic(searcher.search,
                                 mixes["s1"][:SRV_PROFILED]), 0, 1)
    stats["s1"]["profiled"] = dict(requests=SRV_PROFILED,
                                   device_busy_ms=busy, wall_ms=wall_ms,
                                   device_events=events)
    print(f"# serving (s1): "
          + ("busy share not measured" if busy is None else
             f"{busy:.3f} ms busy over {SRV_PROFILED} requests, busy share "
             f"{busy / wall_ms:.3f} of the profiled wall "
             f"{wall_ms:.1f} ms, {events} device events")
          + f" (torch.profiler) [{card}]", flush=True)
    gen.serve_view = serve_view

    # ---- the recorded K4, K5 and K3 calls --------------------------------
    first_k4 = None
    k3_err, n_k3 = 0.0, 0
    for name, rec, _ in calls:
        k3_err = max(k3_err, check_recorded_k3(rec, f"serving ({name})"))
        n_k3 += len(of(rec, "topk_merge"))
        if first_k4 is None and of(rec, "blockmax_scan"):
            first_k4 = (name, of(rec, "blockmax_scan")[0],
                        of(rec, "bisect_exact_scores")[0])
    if first_k4 is None or not n_k3:
        fail("serving: no K4 or K3 call recorded on the route")
    name, (_n, args, kw, got), (_n5, a5, kw5, got5) = first_k4
    kw = {k: v for k, v in kw.items() if k != "acc"}
    t1 = time.perf_counter()
    want = blockmax_scan_plain(*args, **kw)
    k4_plain_s = time.perf_counter() - t1
    for x, y in zip(got, want):
        if not same_bits(x, y):
            fail(f"serving ({name}): K4 blockmax_scan differs from its "
                 f"plain version")
    check_bitwise(got5, bisect_exact_scores_plain(*a5, **kw5),
                  f"serving ({name}): K5 bisect_exact_scores")
    print(f"# serving: the first pruned dispatch's K4 == plain (every "
          f"output; plain {k4_plain_s:.1f} s) and K5 == plain (bitwise) in "
          f"mix ({name}); {n_k3} recorded K3 calls == plain (bitwise)",
          flush=True)

    # ---- every dispatch replayed through serve alone; every response ----
    t1 = time.perf_counter()
    n_disp = 0
    for name, _rec, disp in calls:
        seen = {}
        for queries, k, prune, (vals, hits, totals), _p, _u in disp:
            v2, h2, t2 = plane.serve(queries, k=k, with_totals=True,
                                     prune=prune)
            for qi, q in enumerate(queries):
                if not q:
                    continue
                if not np.array_equal(
                        np.asarray(vals[qi], np.float32).view(np.int32),
                        np.asarray(v2[qi], np.float32).view(np.int32)) \
                        or hits[qi] != h2[qi] or totals[qi] != t2[qi]:
                    fail(f"serving ({name}): a dispatch differs from serve "
                         f"alone on its batch (query {qi})")
                n_hit = min(K, len(hits[qi]))
                seen.setdefault(tuple(q), []).append(
                    ([(int(s), int(d)) for s, d in hits[qi][:n_hit]],
                     np.asarray(vals[qi][:n_hit], np.float32).tobytes()))
            n_disp += 1
        for i, r in enumerate(responses[name]):
            got = ([(h.seg_idx, h.local_doc) for h in r.hits],
                   np.asarray([h.score for h in r.hits],
                              np.float32).tobytes())
            if got not in seen.get(tuple(bags[name][SRV_WARM + i]), []):
                fail(f"serving ({name}) request {i}: its hits are not its "
                     f"dispatch's")
    print(f"# serving: {n_disp} dispatches equal serve() alone on their "
          f"batches (values bitwise, hits, totals), and every response's "
          f"hits and scores are its dispatch's "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)

    # ---- the numpy reference at the frozen avgdl ---------------------------
    for name in mixes:
        for i in range(REF_QUERIES):
            terms = bags[name][SRV_WARM + i]
            check_response(responses[name][i],
                           exact_bm25(corpus, terms, K, avgdl=gen.avgdl),
                           [0], name == "s2",
                           f"serving ({name}) request {i}")
    print(f"# serving: {REF_QUERIES} requests of each mix agree with the "
          f"numpy exact reference (scores within {REF_RTOL:.0%}, docs at "
          f"separated ranks; totals exact in (s2), at most the exact count "
          f"and exact where eq in (s1), (s3))", flush=True)

    # ---- delta: an appended segment, no rebuild ---------------------------
    t1 = time.perf_counter()
    dcorpus = synthetic_csr_corpus_fast(np.random.RandomState(1235),
                                        SRV_DELTA_DOCS, VOCAB, AVG_DL,
                                        zipf_s=1.2)
    nd = SRV_DELTA_DOCS
    seg1 = segment_from_host_state(dict(
        seg_id="_1", n_docs=nd, doc_uids=[str(n0 + i) for i in range(nd)],
        sources=[None] * nd, seq_nos=np.arange(n0, n0 + nd, dtype=np.int64),
        text_fields={"body": body_field_state(dcorpus)}), device=dev)
    segs = [seg, seg1]
    rb0 = cache.rebuild_stats()
    gen2 = cache.plane_for(segs, mapper, "body")
    delta_pack_s = time.perf_counter() - t1
    rb1 = cache.rebuild_stats()
    if gen2 is not gen or gen.delta_docs() != nd or \
            (rb1["cold"], rb1["threshold"], rb1["structure"]) != \
            (rb0["cold"], rb0["threshold"], rb0["structure"]):
        fail(f"serving delta: the append rebuilt or missed the delta: "
             f"{rb0} -> {rb1}")
    dsearcher = ShardSearcher(segs, mapper,
                              plane_provider=lambda s, f: cache.plane_for(
                                  s, mapper, f), device=dev)
    b0 = batcher.stats_doc()
    delta_ms0, n_dq0 = batcher.delta_ms, batcher.n_delta_queries
    kb.reset_launches()
    client_traffic(dsearcher.search, mixes["s1"][:SRV_WARM])
    lat, dres, wall, _began = client_traffic(
        dsearcher.search,
        mixes["s1"][SRV_WARM:SRV_WARM + SRV_DELTA_REQUESTS])
    torch.cuda.synchronize()
    dcounts = {k: v for k, v in kb.launches.items() if v}
    b1 = batcher.stats_doc()
    n_d = b1["dispatches"] - b0["dispatches"]
    st = latency_stats(lat, 1)
    st.update(qps=SRV_DELTA_REQUESTS / wall, dispatches=n_d,
              mean_batch=(b1["queries"] - b0["queries"]) / max(n_d, 1),
              delta_ms_per_dispatch=(batcher.delta_ms - delta_ms0)
              / max(n_d, 1),
              delta_queries=batcher.n_delta_queries - n_dq0,
              delta_pack_s=delta_pack_s,
              launches_per_dispatch={k: v / max(n_d, 1)
                                     for k, v in dcounts.items()})
    stats["delta"] = st
    if st["delta_queries"] < SRV_DELTA_REQUESTS:
        fail("serving delta: requests served without the delta tier")
    for k, v in dcounts.items():
        path[k] += v
    print(f"# serving delta (+{nd} docs, {nd / n0:.2%} of the base, under "
          f"the {cache.REPACK_DELTA_FRACTION:.1%} repack threshold): no "
          f"rebuild ({rb1}); delta pack {delta_pack_s:.2f} s; "
          f"{st['qps']:.1f} requests/s, p50 {st['p50_ms']:.3f} ms, p99 "
          f"{st['p99_ms']:.3f} ms; {n_d} dispatches, mean batch "
          f"{st['mean_batch']:.2f}; delta scan "
          f"{st['delta_ms_per_dispatch']:.3f} ms a dispatch (host) "
          f"[{card}]", flush=True)
    for i in range(REF_QUERIES):
        terms = bags["s1"][SRV_WARM + i]
        check_response(dres[i],
                       exact_bm25(corpus, terms, K, avgdl=gen.avgdl,
                                  extra=[dcorpus]), [0, n0], False,
                       f"serving delta request {i}")
    print(f"# serving delta: {REF_QUERIES} requests agree with numpy BM25 "
          f"over both segments at the generation's frozen avgdl and the "
          f"combined idf (scores within {REF_RTOL:.0%}, docs at separated "
          f"ranks, totals at most exact)", flush=True)
    cache.release()
    print(f"# serving mixes: {json.dumps(dict(stats, build=out))}")
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return path, stats


ML_TREES = 500
ML_TREE_LEVELS = 8           # split levels: 511 nodes, the reference's depth 9
ML_FEATURES = 32
ML_MISSING = 0.1             # features absent from a doc
ML_DEFAULT_RIGHT = 0.2       # splits with default_left: false
ML_INFER_DOCS = 1024         # docs a _infer call
ML_INFER_CALLS = 20          # timed calls (one warm-up more)
ML_INGEST_DOCS = 256         # docs through the ingest pipeline, one a time
ML_DEEP_TREES = 8            # a model past 2,457 nodes a tree:
ML_DEEP_LEVELS = 12          # 8,191 nodes
#: kibana_sample_data_flights' 13,059 docs, times ten
ML_FRAME_DOCS = 131_072
ML_STEPS = 500               # _train_logreg's default
ML_SAMPLED_ROWS = 1024       # rows whose dk is held against f64
ML_PLAIN_ROWS = 2048         # rows a chunk of K21's plain version
ML_LIB_ROWS = 8192           # rows a chunk of the library yardstick
#: K22 against its plain version and a numpy f64 run of the same steps:
#: |ΔW| within this share of max(1, max |W|); predictions equal where the
#: top-two logits differ by more than ML_MARGIN. An f32 run lands near 2e-7
#: of the f64 one on (m)'s frame, a run whose products take TF32 operands
#: near 1e-4: the phase plants that TF32 run and fails if the bar cannot
#: tell it from the kernel's
ML_W_TOL = 1e-5
ML_MARGIN = 1e-3
ML_FLIGHT_FIELDS = ("AvgTicketPrice", "DistanceKilometers", "DistanceMiles",
                    "FlightDelayMin", "FlightTimeHour", "FlightTimeMin",
                    "dayOfWeek", "hour_of_day")
ML_CARRIERS = ("Kibana Airlines", "Logstash Airways", "JetBeats", "ES-Air")


def ml_model(rng, n_trees=ML_TREES, levels=ML_TREE_LEVELS):
    """A ``weighted_sum`` regression ensemble in the trained-model
    definition format (``Ensemble.java``/``Tree.java``): ``n_trees`` full
    binary trees of ``levels`` split levels over ML_FEATURES features,
    thresholds and leaves drawn from ``rng``, a fifth of the splits with
    ``default_left: false``."""
    names = [f"f{j:02d}" for j in range(ML_FEATURES)]
    n_split = 2 ** levels - 1
    n_nodes = 2 * n_split + 1
    feat = rng.randint(0, ML_FEATURES, (n_trees, n_split))
    thr = rng.randn(n_trees, n_split)
    right = rng.rand(n_trees, n_split) < ML_DEFAULT_RIGHT
    leaf = rng.randn(n_trees, n_nodes - n_split) * 0.1
    trees = []
    for t in range(n_trees):
        nodes = []
        for i in range(n_split):
            node = {"node_index": i, "split_feature": int(feat[t, i]),
                    "threshold": float(thr[t, i]),
                    "left_child": 2 * i + 1, "right_child": 2 * i + 2}
            if right[t, i]:
                node["default_left"] = False
            nodes.append(node)
        nodes += [{"node_index": n_split + i, "leaf_value": float(v)}
                  for i, v in enumerate(leaf[t])]
        trees.append({"tree": {"feature_names": names,
                               "tree_structure": nodes}})
    return {"inference_config": {"regression": {}},
            "input": {"field_names": names},
            "definition": {"trained_model": {"ensemble": {
                "feature_names": names,
                "aggregate_output": {"weighted_sum": {
                    "weights": [float(w) for w in
                                rng.uniform(0.5, 1.5, n_trees)]}},
                "trained_models": trees}}}}


def ml_docs(rng, n):
    """n docs of the model's features, ML_MISSING of them absent."""
    vals = rng.randn(n, ML_FEATURES)
    keep = rng.rand(n, ML_FEATURES) >= ML_MISSING
    names = [f"f{j:02d}" for j in range(ML_FEATURES)]
    return [{names[j]: float(vals[i, j]) for j in np.flatnonzero(keep[i])}
            for i in range(n)]


def flights_frame(rng, n):
    """``kibana_sample_data_flights``' schema at n docs: the eight numeric
    fields, the boolean ``FlightDelay`` (its log-odds rise with the hour
    and the distance, and at weekends, so late evening long flights are
    mostly late and a linear model predicts both classes) and a
    ``Carrier`` keyword."""
    price = rng.uniform(100.0, 1200.0, n)
    km = np.minimum(rng.lognormal(8.3, 0.75, n), 19_900.0)
    hour = rng.randint(0, 24, n)
    day = rng.randint(0, 7, n)
    z = -4.0 + 0.15 * hour + 0.25 * km / 1000.0 + 0.4 * (day >= 5)
    late = rng.rand(n) < 1.0 / (1.0 + np.exp(-z))
    delay = np.where(late, 15 * rng.randint(1, 25, n), 0)
    tmin = km / rng.uniform(650.0, 900.0, n) * 60.0 + rng.uniform(
        20.0, 60.0, n)
    carrier = rng.randint(0, len(ML_CARRIERS), n)
    return [{"AvgTicketPrice": float(price[i]),
             "DistanceKilometers": float(km[i]),
             "DistanceMiles": float(km[i] * 0.621371),
             "FlightDelayMin": int(delay[i]), "FlightDelay": bool(late[i]),
             "FlightTimeHour": float(tmin[i] / 60.0),
             "FlightTimeMin": float(tmin[i]), "dayOfWeek": int(day[i]),
             "hour_of_day": int(hour[i]),
             "Carrier": ML_CARRIERS[carrier[i]]} for i in range(n)]


def frame_search(docs):
    """The frame as an index: pages the list by the body ``_load_frame``
    sends (``size``, ``sort`` ``_shard_doc``, ``search_after``)."""
    def search(index, body):
        if body["sort"][-1] != {"_shard_doc": "asc"}:
            fail(f"unexpected frame sort {body['sort']}")
        start = (body.get("search_after") or [-1])[0] + 1
        page = docs[start:start + body["size"]]
        return {"hits": {"hits": [
            {"_id": f"flight-{start + i}", "_source": d,
             "sort": [start + i]} for i, d in enumerate(page)]}}
    return search


def numpy_walk(X, feats, thresh, left, right, dleft, depth):
    """The reference's tree walk on the flattened arrays, in numpy."""
    T, N = feats.shape
    n, F = X.shape
    rows = np.arange(n)[None, :]
    idx = np.zeros((T, n), np.int64)
    for _ in range(depth):
        j = np.clip(np.where(idx < 0, idx + N, idx), 0, N - 1)
        f = np.take_along_axis(feats, j, 1)
        xv = np.where((f >= 0) & (f < F), X[rows, np.clip(f, 0, F - 1)],
                      np.nan)
        go = np.where(np.isnan(xv), np.take_along_axis(dleft, j, 1) != 0,
                      xv < np.take_along_axis(thresh, j, 1))
        nxt = np.where(go, np.take_along_axis(left, j, 1),
                       np.take_along_axis(right, j, 1))
        idx = np.where(f < 0, idx, nxt)
    return idx.astype(np.int32)


def check_k20_call(ml, model, arrs, args, out, what):
    """A recorded K20 call of ``model``'s inference: over the model's own
    pack, equal to the plain version and to the numpy walk; returns the
    walk."""
    import torch
    X, pack, depth = args
    if pack is not model._pack:
        fail(f"{what}: K20 walked another pack than the model's")
    if not torch.equal(out, ml._eval_trees_plain(X, *pack.arrays, depth)):
        fail(f"{what}: K20 differs from its plain version")
    walk = numpy_walk(X.cpu().numpy(), *arrs, depth)
    if not np.array_equal(out.cpu().numpy(), walk):
        fail(f"{what}: K20 differs from the numpy walk")
    return walk


def k20_deep_model(svc, ml, kb, card):
    """A model of deep trees: ``ML_DEEP_TREES`` trees of
    ``ML_DEEP_LEVELS`` split levels (8,191 nodes, past the 3,000 or so
    16-byte records a few-docs block stages in 48 KB, so both calls take
    the batch shape), through ``infer`` at (j)'s batch of docs and at one
    doc: each call one launch, equal to the plain version and the numpy
    walk (seed 77). Its launches count toward no path."""
    rng = np.random.RandomState(77)
    svc.put_trained_model("deep", ml_model(rng, ML_DEEP_TREES,
                                           ML_DEEP_LEVELS))
    model = svc.models["deep"]
    T, N = model._arrays[0].shape
    arrs = [a.cpu().numpy() for a in model._dev_arrays]
    calls = []
    n0 = kb.launches["tree_eval"]
    with recording(calls, ["eval_tree_pack"], (ml,)):
        for n in (ML_INFER_DOCS, 1):
            svc.infer("deep", {"docs": ml_docs(rng, n)})
    if kb.launches["tree_eval"] != n0 + 2 or len(calls) != 2:
        fail(f"deep model: K20 launched {kb.launches['tree_eval'] - n0} "
             f"times in 2 calls")
    for (_n, args, _kw, out), n in zip(calls, (ML_INFER_DOCS, 1)):
        check_k20_call(ml, model, arrs, args, out, f"deep model, n = {n}")
    print(f"# ml: a model of {T} trees x {N} nodes (depth {model._depth}): "
          f"K20 at {ML_INFER_DOCS} docs and at one, one launch each, equal "
          f"to its plain version and the numpy walk [{card}]", flush=True)
    return dict(trees=T, nodes=N, depth=model._depth,
                docs=[ML_INFER_DOCS, 1], launches=2, max_abs_err=0.0)


def run_ml(card, *, reps=10):
    """Phase 13: the ML path (``xpack/ml.py``) with K20–K22: (j) ``_infer``
    on a 500-tree ensemble, (k) the ``inference`` ingest processor, (l)
    outlier detection and (m) classification (and regression) analytics
    over a flights-schema frame. Returns the kernels' rows and each path's
    launch counts."""
    import torch
    from elasticsearch_tpu_torch.ingest.pipeline import (IngestDocument,
                                                         Pipeline)
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.xpack import ml

    rng = np.random.RandomState(1234)
    t0 = time.perf_counter()
    written = {}
    frame = flights_frame(rng, ML_FRAME_DOCS)
    svc = ml.MlService(frame_search(frame),
                       lambda index, lines: written.__setitem__(index,
                                                                lines))
    dev = svc.device
    if dev.type != "cuda":
        fail(f"MlService() resolved to {dev}")
    body = ml_model(rng)
    t1 = time.perf_counter()
    svc.put_trained_model("flights-ens", body)
    model = svc.models["flights-ens"]
    T, N = model._arrays[0].shape
    if (T, N, model._depth) != (ML_TREES, 2 ** (ML_TREE_LEVELS + 1) - 1,
                                ML_TREE_LEVELS + 1):
        fail(f"model flattened to {(T, N, model._depth)}")
    print(f"# ml: frame {ML_FRAME_DOCS} flights docs, model {T} trees x "
          f"{N} nodes (depth {model._depth}) over {ML_FEATURES} features; "
          f"put_trained_model {time.perf_counter() - t1:.2f} s, set-up "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    paths = {}

    # ---- (j) _infer ---------------------------------------------------------
    calls = []
    docs = [ml_docs(rng, ML_INFER_DOCS) for _ in range(ML_INFER_CALLS + 1)]
    with recording(calls, ["eval_tree_pack", "pack_tree_nodes"], (ml,)):
        svc.infer("flights-ens", {"docs": docs[0]})          # warm-up
        torch.cuda.synchronize()
        kb.reset_launches()
        lat = np.zeros(ML_INFER_CALLS)
        results = []
        for i in range(ML_INFER_CALLS):
            t1 = time.perf_counter()
            results.append(svc.infer("flights-ens", {"docs": docs[i + 1]}))
            lat[i] = time.perf_counter() - t1
        paths["ml_infer"] = dict(kb.launches)
    if paths["ml_infer"]["tree_eval"] != ML_INFER_CALLS:
        fail(f"(j): K20 launched {paths['ml_infer']['tree_eval']} times "
             f"in {ML_INFER_CALLS} _infer calls")
    if of(calls, "pack_tree_nodes"):
        fail("(j): the model's trees were packed again at inference")
    st_j = latency_stats(lat, ML_INFER_DOCS)
    print(f"# ml (j) _infer: {st_j['qps']:.1f} docs/s, p50 "
          f"{st_j['p50_ms']:.3f} ms, p99 {st_j['p99_ms']:.3f} ms a call of "
          f"{ML_INFER_DOCS} docs over {ML_INFER_CALLS} calls; K20 "
          f"{paths['ml_infer']['tree_eval']} launches [{card}]", flush=True)
    arrs = [a.cpu().numpy() for a in model._dev_arrays]
    leaves = model._arrays[5]
    w = np.asarray(model.weights, dtype=np.float32)[:, None, None]
    for ci, (_n, args, kw, out) in enumerate(calls[1:]):
        walk = check_k20_call(ml, model, arrs, args, out, f"(j) call {ci}")
        vals = (leaves[np.arange(T)[:, None], walk][:, :, 0]
                * w[:, :, 0]).sum(axis=0)
        got = [r["predicted_value"] for r in results[ci]["inference_results"]]
        if got != [float(v) for v in vals]:
            fail(f"(j) call {ci}: predicted values differ from the numpy "
                 f"walk's weighted sums")
    print(f"# ml (j): K20 (the batch shape) equal to its plain version and "
          f"to the numpy walk on all {ML_INFER_CALLS} calls, over the pack "
          f"built once at put_trained_model; predicted values equal",
          flush=True)

    # ---- (k) the inference ingest processor ----------------------------------
    ml.registry_bind(svc)
    pipe = Pipeline("flights-delay", {"processors": [{"inference": {
        "model_id": "flights-ens", "target_field": "ml.inference"}}]})
    ing = ml_docs(rng, ML_INGEST_DOCS + 1)
    calls_k = []
    with recording(calls_k, ["eval_tree_pack", "pack_tree_nodes"], (ml,)):
        pipe.execute(IngestDocument("flights", "w", dict(ing[0])))
        torch.cuda.synchronize()
        kb.reset_launches()
        lat = np.zeros(ML_INGEST_DOCS)
        outs = []
        for i in range(ML_INGEST_DOCS):
            t1 = time.perf_counter()
            outs.append(pipe.execute(IngestDocument(
                "flights", str(i), dict(ing[i + 1]))))
            lat[i] = time.perf_counter() - t1
        paths["ml_ingest"] = dict(kb.launches)
    if paths["ml_ingest"]["tree_eval"] != ML_INGEST_DOCS:
        fail(f"(k): K20 launched {paths['ml_ingest']['tree_eval']} times "
             f"for {ML_INGEST_DOCS} docs")
    if of(calls_k, "pack_tree_nodes"):
        fail("(k): the model's trees were packed again at inference")
    st_k = latency_stats(lat, 1)
    for i, ((_n, args, kw, out), doc) in enumerate(zip(calls_k[1:], outs)):
        walk = check_k20_call(ml, model, arrs, args, out, f"(k) doc {i}")
        val = float((leaves[np.arange(T), walk[:, 0], 0] * w[:, 0, 0]).sum())
        res = doc.source["ml"]["inference"]
        if res != {"predicted_value": val, "model_id": "flights-ens"}:
            fail(f"(k) doc {i}: {res} != {val}")
    print(f"# ml (k) ingest: {st_k['qps']:.1f} docs/s, p50 "
          f"{st_k['p50_ms']:.3f} ms, p99 {st_k['p99_ms']:.3f} ms a doc over "
          f"{ML_INGEST_DOCS} docs; K20 (the few-docs shape) once a doc, "
          f"equal to its plain version and the numpy walk [{card}]",
          flush=True)
    deep = k20_deep_model(svc, ml, kb, card)

    # ---- the analytics' stages ----------------------------------------------
    marks = {}
    load = svc._load_frame

    def timed_load(cfg):
        out = load(cfg)
        marks["load_end"] = time.perf_counter()
        return out
    svc._load_frame = timed_load

    def stage(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            marks[name + "_start"] = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            marks[name + "_end"] = time.perf_counter()
            marks[name + "_io"] = (args, kw, out)
            return out
        return call

    def run_analytics(aid, analysis, excludes, path, kernel, entry_point):
        cfg = {"source": {"index": "kibana_sample_data_flights"},
               "dest": {"index": aid}, "analysis": analysis}
        if excludes:
            cfg["analyzed_fields"] = {"excludes": excludes}
        svc.put_analytics(aid, cfg)
        saved = {n: getattr(ml, n) for n in (kernel, entry_point)}
        ml.__dict__[kernel] = stage("kernel", saved[kernel])
        ml.__dict__[entry_point] = stage("entry", saved[entry_point])
        marks.clear()
        torch.cuda.synchronize()
        kb.reset_launches()
        t1 = time.perf_counter()
        try:
            svc.start_analytics(aid)
        finally:
            ml.__dict__.update(saved)
        wall = time.perf_counter() - t1
        paths[path] = dict(kb.launches)
        split = dict(
            frame_load_s=marks["load_end"] - t1,
            standardise_s=marks["kernel_start"] - marks["load_end"],
            kernel_s=marks["kernel_end"] - marks["kernel_start"],
            tail_s=marks["entry_end"] - marks["kernel_end"],
            write_s=t1 + wall - marks["entry_end"], wall_s=wall)
        return split, marks["kernel_io"]

    # ---- (l) outlier detection ---------------------------------------------
    split_l, (args, kw, dk) = run_analytics(
        "flights-outliers", {"outlier_detection": {}}, None, "ml_outliers",
        "knn_kdist", "_knn_outlier_scores")
    c = paths["ml_outliers"]
    if c["knn_outlier"] != 1 or any(v for k, v in c.items()
                                    if k != "knn_outlier"):
        fail(f"(l): launches {c}")
    Xd, kk = args
    n, f = Xd.shape
    if (n, f, kk) != (ML_FRAME_DOCS, len(ML_FLIGHT_FIELDS), 5):
        fail(f"(l): K21 ran on {(n, f, kk)}")
    print(f"# ml (l) outlier detection over {n} docs x {f} fields, "
          f"n_neighbors {kk}: {json.dumps(split_l)} [{card}]", flush=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for lo in range(0, n, ML_PLAIN_ROWS):
        hi = min(lo + ML_PLAIN_ROWS, n)
        want = ml.knn_kdist_plain(Xd, kk, rows=(lo, hi))
        if not same_bits(dk[lo:hi], want):
            fail(f"(l): K21 differs from its plain version in rows "
                 f"[{lo}, {hi})")
    torch.cuda.synchronize()
    k21_plain_ms = (time.perf_counter() - t1) * 1e3
    # dk of sampled rows against f64 over all rows
    X64 = Xd.double()
    sample = torch.from_numpy(np.sort(np.random.RandomState(4321).choice(
        n, ML_SAMPLED_ROWS, replace=False))).to(dev)
    ratio = 0.0
    eps = float(np.finfo(np.float32).eps)
    for b0 in range(0, ML_SAMPLED_ROWS, 128):
        rows = sample[b0:b0 + 128]
        d2 = ((X64[rows, None, :] - X64[None, :, :]) ** 2).sum(-1)
        d2[torch.arange(rows.numel(), device=dev), rows] = float("inf")
        nn = torch.topk(d2, kk, dim=1, largest=False).values
        mean64 = nn.mean(1)
        sq_i = (X64[rows] ** 2).sum(1)
        # |Δ(sum of squares)| of a neighbour pair scales with |x_i|^2 +
        # |x_j|^2, and |x_j| <= |x_i| + d_ij
        sq_j = (sq_i.sqrt() + nn[:, -1].sqrt()) ** 2
        bar = 4 * (f + 3) * eps * (sq_i + sq_j) + 4 * eps * mean64
        err = (dk[rows].double() ** 2 - mean64).abs()
        ratio = max(ratio, float((err / bar).max()))
    if ratio > 1.0:
        fail(f"(l): dk off the f64 reference by {ratio:.3f} x the bar")
    scores = ml.outlier_scores_from_kdist(dk).cpu().numpy()
    dk64 = dk.double().cpu().numpy()
    z = (dk64 - dk64.mean()) / (dk64.std() + 1e-9) * 2.0 - 2.0
    s64 = 1.0 / (1.0 + np.exp(-z))
    lines = written["flights-outliers"]
    got = np.asarray([ln["ml"]["outlier_score"] for ln in lines[1::2]])
    if len(lines) != 2 * n or not np.array_equal(got, scores.astype(
            np.float64)) or np.abs(got - s64).max() > 1e-5:
        fail("(l): written outlier scores differ from the gated dk's")
    if [ln["index"]["_id"] for ln in lines[::2]] != \
            [f"flight-{i}" for i in range(n)]:
        fail("(l): written ids out of order")
    print(f"# ml (l): K21 bitwise equal to its plain version over all {n} "
          f"rows ({k21_plain_ms:.1f} ms for the plain pass); dk of "
          f"{ML_SAMPLED_ROWS} sampled rows within {ratio:.4f} of the f64 "
          f"bar 4(f+3)eps(|x_i|^2+|x_j|^2); written scores equal the "
          f"gated dk's (f64 within 1e-5); std(dk) {dk64.std():.4f}, "
          f"top score {got.max():.4f} [{card}]", flush=True)
    rows = []
    sq = ml.knn_sq_norms_plain(Xd)

    def lib_k21():
        for lo in range(0, n, ML_LIB_ROWS):
            hi = min(lo + ML_LIB_ROWS, n)
            d2 = (sq[lo:hi, None] + sq[None, :]) - 2.0 * (Xd[lo:hi] @ Xd.T)
            d2.clamp_min_(0.0)
            r = torch.arange(hi - lo, device=dev)
            d2[r, r + lo] = float("inf")
            torch.topk(d2, kk, dim=1, largest=False)
    k21_ms = timed(lambda: ml.knn_kdist(Xd, kk), 3)
    k21_lib = timed(lib_k21, 2)
    bms, bby = bound(4 * n * f + 4 * n, 2 * n * n * f)
    rows.append(dict(
        name="knn_outlier", route="cuda",
        source="elasticsearch_tpu_torch/csrc/knn_outlier.cu",
        replaces="elasticsearch_tpu/xpack/ml.py:627", max_abs_err=0.0,
        ms=k21_ms, plain_ms=k21_plain_ms, bound_ms=bms, bound_by=bby,
        library_ms=k21_lib,
        library_call="fp32 torch.matmul (TF32 off) + torch.topk "
                     "(largest=False) in row chunks",
        stages_s=split_l))
    print(f"# knn_outlier: {k21_ms:.4f} ms (bound {bms:.4f} ms by {bby}), "
          f"plain {k21_plain_ms:.1f} ms, library {k21_lib:.4f} ms "
          f"[{card}]", flush=True)
    del X64, sq
    torch.cuda.empty_cache()

    # ---- (m) classification, then regression --------------------------------
    split_m, (args, kw, W) = run_analytics(
        "flights-delay", {"classification": {
            "dependent_variable": "FlightDelay"}}, ["FlightDelayMin"],
        "ml_classification", "logreg_train", "_train_logreg")
    c = paths["ml_classification"]
    if c["logreg_train"] != 1 or any(
            v for k, v in c.items() if k != "logreg_train"):
        fail(f"(m): launches {c}")
    Xb, yd, C = args[0], args[1], args[2]
    if (C, Xb.shape[1]) != (2, len(ML_FLIGHT_FIELDS)):
        fail(f"(m): K22 ran with {C} classes, {Xb.shape[1]} columns")
    metrics = svc.analytics["flights-delay"]["metrics"]
    print(f"# ml (m) classification over {Xb.shape[0]} rows x "
          f"{Xb.shape[1] - 1} features, {C} classes, {ML_STEPS} steps: "
          f"{json.dumps(split_m)}, accuracy {metrics['accuracy']:.4f}, K22 "
          f"{c['logreg_train']} launches [{card}]", flush=True)
    Wp = ml.logreg_train_plain(Xb, yd, C, ML_STEPS)
    Xh = Xb.double().cpu().numpy()
    Y = np.eye(C)[yd.cpu().numpy()]
    W64 = np.zeros((Xh.shape[1], C))
    for _ in range(ML_STEPS):
        zz = Xh @ W64
        e = np.exp(zz - zz.max(1, keepdims=True))
        W64 -= 0.5 * (Xh.T @ (e / e.sum(1, keepdims=True) - Y)
                      / Xh.shape[0] + 1e-4 * W64)
    scale = max(1.0, float(np.abs(W64).max()))
    err_p = float((W - Wp).abs().max()) / scale
    err_64 = float(np.abs(W.double().cpu().numpy() - W64).max()) / scale
    if err_p > ML_W_TOL or err_64 > ML_W_TOL:
        fail(f"(m): W off by {err_p:.3g} (plain) / {err_64:.3g} (f64) of "
             f"max(1, |W|), bar {ML_W_TOL}")
    # a planted run whose products take TF32 operands (10 mantissa bits,
    # rounded to nearest) must land outside the bar
    def tf32(t):
        b = t.contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)
    Yd = torch.from_numpy(Y.astype(np.float32)).to(dev)
    Xt, Wt = tf32(Xb), torch.zeros_like(W)
    for _ in range(ML_STEPS):
        p = torch.softmax(Xt @ tf32(Wt), dim=1)
        Wt = Wt - 0.5 * (Xt.T @ tf32(p - Yd) / Xb.shape[0] + 1e-4 * Wt)
    err_tf32 = float(np.abs(Wt.double().cpu().numpy() - W64).max()) / scale
    if err_tf32 <= ML_W_TOL:
        fail(f"(m): a TF32 run lands {err_tf32:.3g} from the f64 run, "
             f"inside the bar {ML_W_TOL}: the gate cannot see TF32")
    lg = (Xh @ W.double().cpu().numpy())
    l64 = Xh @ W64
    top2 = -np.sort(-l64, axis=1)[:, :2]
    sep = top2[:, 0] - top2[:, 1] > ML_MARGIN
    if not np.array_equal(lg.argmax(1)[sep], l64.argmax(1)[sep]):
        fail("(m): predictions differ from the f64 run's where separated")
    # the written results from the gated W, as _run_analytics forms them
    lines = written["flights-delay"]
    Wh = W.cpu().numpy()
    feats = [k for k in ML_FLIGHT_FIELDS if k != "FlightDelayMin"]
    Xf = np.asarray([[d[k] for k in feats] for d in frame], np.float32)
    mu, sd = Xf.mean(axis=0), Xf.std(axis=0) + 1e-9
    Xn = np.concatenate([(Xf - mu) / sd, np.ones((len(frame), 1),
                                                  np.float32)], axis=1)
    logits = Xn @ Wh
    ee = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = ee / ee.sum(axis=1, keepdims=True)
    classes = ["False", "True"]
    pred = [ln["ml"]["FlightDelay_prediction"] for ln in lines[1::2]]
    prob = np.asarray([ln["ml"]["prediction_probability"]
                       for ln in lines[1::2]])
    if pred != [classes[int(i)] for i in np.argmax(probs, 1)] or \
            not np.array_equal(prob, probs.max(1).astype(np.float64)):
        fail("(m): written predictions differ from the gated W's")
    n_true = int(np.sum(np.asarray(pred) == "True"))
    if not 0 < n_true < len(pred):
        fail(f"(m): every row predicted the same ({n_true} True): the "
             f"check of the written predictions would see one value")
    truth = np.asarray([str(d["FlightDelay"]) for d in frame])
    acc = float(np.mean(np.asarray(pred) == truth))
    if abs(acc - metrics["accuracy"]) > 1e-12:
        fail(f"(m): accuracy {metrics['accuracy']} != {acc}")
    print(f"# ml (m): K22 within {err_p:.3g} of its plain version and "
          f"{err_64:.3g} of a numpy f64 run of {ML_STEPS} steps (bar "
          f"{ML_W_TOL} of max(1, |W|) = {scale:.4f}; a planted TF32 run "
          f"lands {err_tf32:.3g}); predictions equal the f64 run's on "
          f"{int(sep.sum())} separated rows ({n_true} predicted True); "
          f"written results equal the gated W's", flush=True)
    k22_ms = timed(lambda: ml.logreg_train(Xb, yd, C, ML_STEPS), 5)
    k22_plain = timed(lambda: ml.logreg_train_plain(Xb, yd, C, ML_STEPS), 2)

    def lib_k22():
        Wl = torch.zeros_like(W)
        for _ in range(ML_STEPS):
            p = torch.softmax(Xb @ Wl, dim=1)
            Wl = Wl - 0.5 * (Xb.T @ (p - Yd) / Xb.shape[0] + 1e-4 * Wl)
        return Wl
    k22_lib = timed(lib_k22, 2)
    nb, F1 = Xb.shape
    # a run reads Xb and y once and writes W; every step does its FMAs
    # (two products of 2 n F1 C) and its softmax and residuals (6 n C)
    bms, bby = bound(4 * nb * F1 + 4 * nb + 4 * F1 * C,
                     ML_STEPS * (4 * nb * F1 * C + 6 * nb * C))
    # the one-launch-a-step kernel's bound: Xb and y again every step
    step_bytes = bound(4 * nb * F1 + 4 * nb + 8 * F1 * C, 0)[0]
    rows.append(dict(
        name="logreg_train", route="cuda",
        source="elasticsearch_tpu_torch/csrc/logreg_train.cu",
        replaces="elasticsearch_tpu/xpack/ml.py:660",
        max_abs_err=float((W - Wp).abs().max()), ms=k22_ms,
        ms_step=k22_ms / ML_STEPS, steps=ML_STEPS, plain_ms=k22_plain,
        bound_ms=bms, bound_by=bby,
        bound_ms_rereading=ML_STEPS * step_bytes, library_ms=k22_lib,
        library_call=f"torch.matmul x2 + torch.softmax a step, "
                     f"{ML_STEPS} steps",
        stages_s=split_m, accuracy=metrics["accuracy"]))
    print(f"# logreg_train: {k22_ms:.4f} ms for {ML_STEPS} steps, "
          f"{k22_ms / ML_STEPS:.5f} ms a step, one launch (bound "
          f"{bms:.5f} ms a run by {bby}; {ML_STEPS * step_bytes:.4f} ms if "
          f"every step read Xb again), plain {k22_plain:.3f} ms, library "
          f"{k22_lib:.4f} ms a run [{card}]", flush=True)
    t1 = time.perf_counter()
    kb.reset_launches()
    svc.put_analytics("flights-delay-min", {
        "source": {"index": "kibana_sample_data_flights"},
        "dest": {"index": "flights-delay-min"},
        "analysis": {"regression": {"dependent_variable": "FlightDelayMin"}},
        "analyzed_fields": {"excludes": ["FlightDelay"]}})
    svc.start_analytics("flights-delay-min")
    if any(kb.launches.values()):
        fail(f"regression launched kernels: {kb.launches}")
    print(f"# ml regression (host lstsq) over {ML_FRAME_DOCS} docs: "
          f"{time.perf_counter() - t1:.2f} s, r_squared "
          f"{svc.analytics['flights-delay-min']['metrics']['r_squared']:.4f}"
          f" [{card}]", flush=True)

    # ---- K20's times: (j)'s call shape, and (k)'s ------------------------------
    shapes = {}
    for what, (_n, args, kw, out) in (("batch_j", calls[1]),
                                      ("single_doc_k", calls_k[1])):
        X, pack, depth = args
        nx, Fx = X.shape
        ms = timed(lambda: ml.eval_tree_pack(*args, **kw), reps)
        plain = timed(lambda: ml._eval_trees_plain(X, *pack.arrays, depth),
                      2)
        dev_ms = queued_ms(lambda: ml.eval_tree_pack(*args, **kw), reps)
        if nx == 1:
            # one doc: X's row, the records its walks read (the trees are
            # full: depth - 1 splits of 16 bytes and a leaf's mark of 4
            # a tree) and the output
            nb = 4 * Fx + T * (16 * (depth - 1) + 4) + 4 * T
        else:
            # X once, 16 bytes of each split node and the mark of each
            # leaf, and the output
            n_split = int((pack.arrays[0] >= 0).sum())
            nb = 4 * nx * Fx + 16 * n_split + 4 * (T * N - n_split) \
                + 4 * T * nx
        bms, bby = bound(nb, T * nx * depth)
        shapes[what] = dict(n=nx, ms=ms, device_ms=dev_ms, plain_ms=plain,
                            bound_ms=bms, bound_by=bby)
        print(f"# tree_eval ({what}: {T} trees x {nx} docs, depth {depth}):"
              f" {ms:.4f} ms (on the card {fmt_ms(dev_ms)}; bound {bms:.6f} ms "
              f"by {bby}), plain {plain:.3f} ms, no library call walks "
              f"trees [{card}]", flush=True)
    j = shapes["batch_j"]
    rows.insert(0, dict(
        name="tree_eval", route="cuda",
        source="elasticsearch_tpu_torch/csrc/tree_eval.cu",
        replaces="elasticsearch_tpu/xpack/ml.py:380", max_abs_err=0.0,
        ms=j["ms"], plain_ms=j["plain_ms"], bound_ms=j["bound_ms"],
        bound_by=j["bound_by"], library_ms=None, library_call=None,
        shapes=shapes, deep_model=deep, infer=st_j, ingest=st_k))
    print(f"# peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return rows, paths


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
    kernels, card, corpus = run()
    torch.cuda.empty_cache()
    print(f"# eager phases {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    seg_rows, seg_counts, (seg, mapper) = run_segment(card, corpus)
    torch.cuda.empty_cache()
    print(f"# segment phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    srv_counts, _srv_stats = run_serving(card, corpus, seg, mapper)
    del corpus, seg, mapper
    torch.cuda.empty_cache()
    print(f"# serving phase {time.perf_counter() - t1:.1f} s [{card}]",
          flush=True)
    pruned_rows, pruned_counts, k1_fallback, errs, (pplane, pcorpus) = \
        run_pruned(card)
    kernels += pruned_rows
    t1 = time.perf_counter()
    k9_row, k11_bool, bool_counts = run_bool(card, pplane, pcorpus)
    del pplane, pcorpus
    torch.cuda.empty_cache()
    print(f"# bool phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    knn_row, knn_counts, k3_knn = run_knn_exact(card)
    torch.cuda.empty_cache()
    print(f"# knn_exact phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    ivf_rows, ivf_counts, k3_ivf = run_knn_ivf(card)
    torch.cuda.empty_cache()
    print(f"# knn_ivf phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    hy_rows, hy_times, hy_counts = run_hybrid(card)
    torch.cuda.empty_cache()
    print(f"# hybrid phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    agg_rows, agg_counts = run_aggs(card)
    torch.cuda.empty_cache()
    print(f"# aggs phase {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    ml_rows, ml_counts = run_ml(card)
    torch.cuda.empty_cache()
    print(f"# ml phase {time.perf_counter() - t1:.1f} s [{card}]",
          flush=True)
    k9_row["ms_by_path"]["hybrid"] = hy_times["k9"]["ms"]
    k9_row["device_ms_per_dispatch"]["hybrid"] = hy_times["k9"]["device_ms"]
    k9_row["launch"]["hybrid"] = hy_times["k9"]["launch"]
    hy_rows[1]["ms_by_path"] = {"hybrid": hy_rows[1]["ms"],
                                "bool": k11_bool["ms"]}
    hy_rows[1]["device_ms_by_path"] = {"hybrid": hy_rows[1]["device_ms"],
                                       "bool": k11_bool["device_ms"]}
    for kd in kernels:
        if kd["name"] == "bisect_exact_scores":
            kd["ms_by_path"] = dict(
                {f"pruned_{m}": v for m, v in kd["ms_by_mix"].items()},
                bool_rescore=k11_bool["k5_ms"],
                hybrid_rescore=hy_times["k5"]["ms"])
            kd["plain_ms_by_path"] = dict(
                bool_rescore=k11_bool["k5_plain_ms"],
                hybrid_rescore=hy_times["k5"]["plain_ms"])
    kernels += [knn_row] + ivf_rows + [k9_row] + hy_rows + agg_rows \
        + seg_rows + ml_rows
    path_counts = dict(pruned_counts, knn_exact=knn_counts,
                       knn_ivf=ivf_counts, bool=bool_counts,
                       hybrid=hy_counts, aggs=agg_counts,
                       segment=seg_counts, serving=srv_counts,
                       **ml_counts)
    for kd in kernels:
        if kd["name"] == "topk_merge":
            kd["max_abs_err"] = max(kd["max_abs_err"], errs["k3_err"],
                                    k3_knn, k3_ivf, hy_times["k3"]["err"])
            kd["ms_by_path"] = {"search": kd["ms"],
                                "hybrid": hy_times["k3"]["ms"]}
            kd["library_ms_by_path"] = {
                "search": kd["library_ms"],
                "hybrid": hy_times["k3"]["library_ms"]}
            kd["device_ms_by_path"] = {
                "hybrid": hy_times["k3"]["device_ms"],
                "hybrid_library": hy_times["k3"]["library_device_ms"]}
        if kd["name"] == "knn_scan":
            kd["max_abs_err"] = max(kd["max_abs_err"], hy_times["k6"]["err"])
            kd["hybrid"] = dict(ms=hy_times["k6"]["ms"],
                                plain_ms=hy_times["k6"]["plain_ms"],
                                library_ms=hy_times["k6"]["library_ms"],
                                bound_ms=hy_times["k6"]["bound"][0],
                                bound_by=hy_times["k6"]["bound"][1],
                                chunks=hy_times["k6"]["chunks"],
                                blocks_per_sm=hy_times["k6"]["blocks_per_sm"],
                                ring_stages=hy_times["k6"]["ring_stages"],
                                stage_values=hy_times["k6"]["stage_values"])
        if kd["name"] == "sparse_candidates_topk":
            kd["max_abs_err"] = max(kd["max_abs_err"], errs["k1_err"])
        by_path = kd.setdefault("launches_by_path", {})
        for path, c in path_counts.items():
            by_path[path] = c[kd["name"]]
        by_path.setdefault("search", 0)
        by_path.setdefault("serve", 0)
        kd["launches"] = sum(by_path.values())
        if kd["name"] == "sparse_candidates_topk" and k1_fallback:
            kd["fallback"] = {key: k1_fallback[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "postings",
                "candidates")}
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print("# before the redesign (PERF.md's kernel table, not measured in "
          "this run): " + ", ".join(f"{k} {v} ms"
                                    for k, v in EARLIER_MS.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
