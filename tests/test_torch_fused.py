"""The port's rank fusion, rescore reorder and one-dispatch hybrid
(``fused_search_device``) against the JAX package, on the CPU.

The plain fusion and reorder bodies meet the reference's on random ranked
lists with overlaps, pads, exact RRF ties and windows of every size:
values and ids bitwise, ``sel`` equal at finite slots (the reference
leaves the order of −inf slots open).

The hybrid runs on two planes of one corpus. The port's planes load the
reference planes' packed state (``from_packed`` of ``export_packed``), so
both sides serve the same bytes. The main matrix uses integer-valued
vectors: their dot products are exact in f32 in any order, so kNN scores,
and with them RRF and sum fusion, are bitwise on both sides. A randn
cosine corpus checks the parity bar of inexact products: kNN scores
within ``torch_cases.knn_tol``, and the fused rows equal where the
reference's kNN ranking is separated by more than that (a near-tie swap
there would move RRF ranks, which the bar allows).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fused_query as rfq
from elasticsearch_tpu.parallel import dist_search as ref
from elasticsearch_tpu.parallel import make_search_mesh
from elasticsearch_tpu.search import query_planner as rqp
from elasticsearch_tpu_torch.ops import fused_query as tfq
from elasticsearch_tpu_torch.parallel import dist_search as port
from elasticsearch_tpu_torch.search import query_planner as tqp
from elasticsearch_tpu_torch.utils.synth import (split_csr_shards,
                                                 synthetic_csr_corpus_fast)
from torch_cases import knn_tol

VOCAB = 128
DIM = 12
MODES = ("total", "multiply", "avg", "max", "min")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same_fused(got, want):
    """(vals, ids, sel) of the port against the reference's: values and
    ids bitwise, sel equal where the value is finite."""
    gv, gi, gs = (np.asarray(x) for x in got)
    wv, wi, ws = (np.asarray(x) for x in want)
    assert np.array_equal(_bits(gv), _bits(wv))
    assert np.array_equal(gi, wi)
    fin = np.isfinite(wv)
    assert np.array_equal(gs[fin], ws[fin])


# ---------------------------------------------------------------------------
# the plain fusion and reorder bodies against the reference's
# ---------------------------------------------------------------------------


def _lists(seed, B, na, nb, pad_id):
    """Two ranked id lists per row: unique ids within a list, about a third
    of list b in list a, pad slots at the tails, scores descending."""
    rng = np.random.RandomState(seed)
    ids_a = np.full((B, na), pad_id, np.int32)
    ids_b = np.full((B, nb), pad_id, np.int32)
    vals_a = np.full((B, na), -np.inf, np.float32)
    vals_b = np.full((B, nb), -np.inf, np.float32)
    for b in range(B):
        n1, n2 = rng.randint(0, na + 1), rng.randint(0, nb + 1)
        a = rng.choice(pad_id, n1, replace=False)
        pool = np.setdiff1d(np.arange(pad_id), a)
        bb = rng.choice(pool, n2, replace=False)
        share = rng.rand(n2) < 0.35
        if n1:
            bb[share] = rng.choice(a, share.sum()) if share.sum() <= n1 \
                else bb[share]
        _, first = np.unique(bb, return_index=True)
        bb = bb[np.sort(first)]
        ids_a[b, :n1] = a
        ids_b[b, :bb.size] = bb
        vals_a[b, :n1] = -np.sort(-rng.choice(
            np.array([0.0, 0.5, 1.0, 2.5, 3.0], np.float32), n1))
        vals_b[b, :bb.size] = -np.sort(-rng.rand(bb.size).astype(
            np.float32))
    return ids_a, vals_a, ids_b, vals_b


@pytest.mark.parametrize("seed,na,nb", [(0, 16, 16), (1, 32, 8), (2, 5, 40),
                                        (3, 1, 1)])
def test_rrf_fuse_body_matches_reference(seed, na, nb):
    pad = 300
    ids_a, _va, ids_b, _vb = _lists(seed, 9, na, nb, pad)
    rc = np.array([60, 1, 0.5, 60, 2, 60, 10, 60, 0], np.float32)
    for k in (na + nb, 7):
        f = jax.jit(jax.vmap(functools.partial(rfq.rrf_fuse_body, k=k,
                                               pad_id=pad)))
        want = f(ids_a, ids_b, rc)
        got = tfq.rrf_fuse_body(_t(ids_a), _t(ids_b), _t(rc), k=k,
                                pad_id=pad)
        _same_fused(got, want)
    v = np.asarray(want[0])
    if min(na, nb) > 1:                              # exact RRF ties
        assert (v[:, 1:] == v[:, :-1])[np.isfinite(v[:, 1:])].any()


@pytest.mark.parametrize("seed,na,nb", [(4, 16, 16), (5, 8, 32), (6, 3, 3)])
def test_sum_fuse_body_matches_reference(seed, na, nb):
    pad = 300
    ids_a, va, ids_b, vb = _lists(seed, 9, na, nb, pad)
    for k in (na + nb, 5):
        f = jax.jit(jax.vmap(functools.partial(rfq.sum_fuse_body, k=k,
                                               pad_id=pad)))
        want = f(ids_a, va, ids_b, vb)
        got = tfq.sum_fuse_body(_t(ids_a), _t(va), _t(ids_b), _t(vb), k=k,
                                pad_id=pad)
        _same_fused(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_rescore_reorder_body_matches_reference(mode):
    rng = np.random.RandomState(7)
    B, n, pad = 8, 24, 1000
    vals = -np.sort(-rng.choice(np.array([0.0, 1.0, 1.5, 2.0, 4.0],
                                         np.float32), (B, n)), axis=1)
    for b in range(B):
        vals[b, rng.randint(0, n + 1):] = -np.inf
    ids = np.stack([rng.choice(pad, n, replace=False) for _ in range(B)])
    ids = np.where(vals > -np.inf, ids, pad).astype(np.int32)
    sec = rng.choice(np.array([0.0, 0.25, 1.0, 3.0], np.float32), (B, n))
    matched = rng.rand(B, n) < 0.6
    qw = rng.choice(np.array([0.7, 1.0, 2.0], np.float32), B)
    rw = rng.choice(np.array([1.3, 0.5, 1.0], np.float32), B)
    window = np.array([0, 5, n, n + 9, 1, 12, 24, 3], np.int32)
    for k in (n, 10, n + 4):
        f = jax.jit(jax.vmap(functools.partial(
            rfq.rescore_reorder_body, mode=mode, k=k, pad_id=pad)))
        wv, wi = (np.asarray(x) for x in f(vals, ids, sec, matched, qw, rw,
                                           window))
        gv, gi = tfq.rescore_reorder_body(
            _t(vals), _t(ids), _t(sec), _t(matched), _t(qw), _t(rw),
            _t(window), mode=mode, k=k, pad_id=pad)
        assert np.array_equal(_bits(gv.numpy()), _bits(wv))
        assert np.array_equal(gi.numpy(), wi)


def test_rescore_combine_rejects_unknown_mode():
    x = torch.zeros(1, 2)
    with pytest.raises(ValueError, match="score_mode"):
        tfq.rescore_combine("sum", x, x, x > 0, x > 0, torch.ones(1),
                            torch.ones(1))


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm",
                                 "max_inner_product"])
def test_knn_raw_to_score_matches_reference(sim):
    raw = np.random.RandomState(3).randn(257).astype(np.float32) * 3
    want = np.asarray(jax.jit(lambda r: rfq.knn_raw_to_score(sim, r))(raw))
    got = tfq.knn_raw_to_score(sim, _t(raw)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    for r in raw[:8].tolist():
        assert tqp.knn_raw_to_score_host(sim, r) == \
            rqp.knn_raw_to_score_host(sim, r)


def test_host_fusion_twins_match_reference():
    rng = np.random.RandomState(4)
    lists = [[(float(rng.rand()), int(rng.randint(3)), int(rng.randint(40)))
              for _ in range(25)] for _ in range(3)]
    lists = [list({(r[1], r[2]): r for r in lst}.values()) for lst in lists]
    assert tqp.rrf_fuse_rows(lists, 60) == rqp.rrf_fuse_rows(lists, 60)
    assert tqp.sum_fuse_rows(lists) == rqp.sum_fuse_rows(lists)
    assert issubclass(tqp.FusedFallback, Exception)


# ---------------------------------------------------------------------------
# fused_search_device against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    c = synthetic_csr_corpus_fast(np.random.RandomState(11), 600, VOCAB, 12)
    c["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    return c


def _int_vectors(rng, n):
    """Integer-valued rows: every dot product with an integer query is
    exact in f32, whatever the order of the sum."""
    return rng.randint(-3, 4, size=(n, DIM)).astype(np.float32)


def _build(corpus, S, vecs, similarity):
    """Reference text and kNN planes on one mesh, and the port's planes
    loaded from their packed state. One shard holds 500 of its 600 docs'
    vectors (so the kNN pad differs from the text pad)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    mesh = make_search_mesh(n_shards=S, devices=jax.devices()[:S])
    jt = ref.DistributedSearchPlane(mesh, shards, "body",
                                    dense_threshold=1 << 30)
    if S == 1:
        kshards = [dict(vectors=vecs[:500])]
    else:
        per = -(-corpus["doc_len"].shape[0] // S)
        kshards = [dict(vectors=vecs[i * per:(i + 1) * per])
                   for i in range(S)]
    jk = ref.DistributedKnnPlane(mesh, kshards, similarity=similarity)
    mp.undo()
    assert jt._host_csr is None and jk._host_pack is None
    tt = port.DistributedSearchPlane.from_packed(jt.export_packed(),
                                                 device="cpu")
    tk = port.DistributedKnnPlane.from_packed(jk.export_packed(),
                                              device="cpu")
    return jt, jk, tt, tk


@pytest.fixture(scope="module", params=[1, 2], ids=["S1", "S2"])
def planes(request, corpus):
    rng = np.random.RandomState(31)
    return _build(corpus, request.param, _int_vectors(rng, 600),
                  "dot_product")


def fused_queries(corpus, seed, *, dim=DIM, integer=True, rescore=False):
    """Hybrid requests: lowered bool trees over terms drawn ∝ df, a query
    vector, and per-query windows, k, rc and kboost (a few partial and
    empty windows among the 16/16 defaults)."""
    rng = np.random.RandomState(seed)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    p = df[el] / df[el].sum()

    def terms(m):
        return [f"t{t}" for t in rng.choice(el, m, p=p)]

    trees = [
        {"clauses": [("should", terms(9))], "msm": 1},
        {"clauses": [("must", terms(1)), ("should", terms(3)),
                     ("filter", terms(1)), ("must_not", terms(1))],
         "msm": 0},
        {"clauses": [("should", terms(2)), ("should", terms(2)),
                     ("should", terms(2))], "msm": 2},
        {"clauses": [("filter", terms(2))], "msm": 0},
        {"clauses": [("should", terms(4))], "msm": 1},
        {"clauses": [("must", ["nope"])], "msm": 0},
    ]
    wins = [(16, 16, 10), (10, 7, 5), (16, 0, 10), (0, 16, 8), (3, 16, 20),
            (16, 16, 0)]
    out = []
    for i, (tree, (wt, wk, k)) in enumerate(zip(trees, wins)):
        qv = rng.randint(-3, 4, size=dim).astype(np.float32) if integer \
            else rng.randn(dim).astype(np.float32)
        fq = dict(tree, qv=qv, kboost=[1.0, 2.0, 0.5][i % 3],
                  rc=[60.0, 1.0, 60.0, 7.0, 60.0, 60.0][i], wt=wt, wk=wk,
                  k=k)
        if rescore:
            fq["rescore"] = {"terms": terms(2), "qw": 0.7, "rw": 1.3,
                             "window": [10, 0, 5, 32, 1, 12][i]}
        out.append(fq)
    return out


def _same_rows(got, want):
    for g, w in zip(got, want):
        assert [(r[1], r[2]) for r in g] == [(r[1], r[2]) for r in w]
        assert np.array_equal(_bits([r[0] for r in g]),
                              _bits([r[0] for r in w]))


@pytest.mark.parametrize("fusion", ["rrf", "sum"])
@pytest.mark.parametrize("mode", [None, *MODES])
def test_fused_search_device_matches_reference(planes, corpus, fusion,
                                                 mode):
    jt, jk, tt, tk = planes
    fqs = fused_queries(corpus, 17, rescore=mode is not None)
    st = {}
    got = port.fused_search_device(tt, tk, fqs, fusion=fusion,
                                   rescore_mode=mode, stages=st)
    want = ref.fused_search_device(jt, jk, fqs, fusion=fusion,
                                   rescore_mode=mode)
    for g, w in zip(got, want):
        if isinstance(g[0], list):
            _same_rows(g, w)
        else:
            assert g == w                            # totals
    assert any(len(r) for r in got[0]) and any(got[1])
    assert {"prep_ms", "dispatch_ms", "fetch_ms", "h2d_bytes", "d2h_bytes",
            "docs_scanned"} <= set(st)
    assert tt.n_dispatches >= 1 and tk.n_dispatches >= 1


@pytest.mark.parametrize("fusion", ["rrf", "sum"])
def test_fused_float_vectors_within_the_bar(corpus, fusion):
    rng = np.random.RandomState(5)
    vecs = rng.randn(600, DIM).astype(np.float32)
    jt, jk, tt, tk = _build(corpus, 1, vecs, "cosine")
    fqs = fused_queries(corpus, 23, integer=False)
    got = port.fused_search_device(tt, tk, fqs, fusion=fusion)
    want = ref.fused_search_device(jt, jk, fqs, fusion=fusion)
    q = np.stack([fq["qv"] for fq in fqs])
    tol = knn_tol(q, vecs, "cosine")
    assert got[1] == want[1]
    _same_rows(got[2], want[2])                      # text: bitwise
    separated = True
    for g, w in zip(got[3], want[3]):                # kNN: within the bar
        gv, wv = np.asarray([r[0] for r in g]), np.asarray([r[0] for r in w])
        assert gv.shape == wv.shape
        assert np.allclose(gv, wv, rtol=0, atol=tol)
        gaps = np.abs(np.diff(wv)) > tol
        assert all(gr[1:] == wr[1:] for gr, wr, ok in
                   zip(g, w, np.r_[True, gaps] & np.r_[gaps, True]) if ok)
        separated &= bool(gaps.all())
    assert separated, "the test corpus should separate the kNN ranks"
    for g, w in zip(got[0], want[0]):                # fused rows
        assert [(r[1], r[2]) for r in g] == [(r[1], r[2]) for r in w]
        gv, wv = np.asarray([r[0] for r in g]), np.asarray([r[0] for r in w])
        if fusion == "rrf":
            assert np.array_equal(_bits(gv), _bits(wv))
        else:
            assert np.allclose(gv, wv, rtol=0, atol=tol)


def test_fused_dense_terms_and_plane_mismatch_raise(corpus):
    rng = np.random.RandomState(9)
    vecs = _int_vectors(rng, 600)
    tp = port.DistributedSearchPlane([corpus], "body", device="cpu",
                                     dense_threshold=40)
    kp = port.DistributedKnnPlane([dict(vectors=vecs)],
                                  similarity="dot_product", device="cpu")
    head = f"t{int(np.argmax(corpus['df']))}"
    fq = dict(clauses=[("should", [head, "t100"])], msm=1, qv=vecs[0],
              wt=8, wk=8, k=5)
    with pytest.raises(ValueError, match="dense-tier"):
        port.fused_search_device(tp, kp, [fq], fusion="rrf")
    kp2 = port.DistributedKnnPlane([dict(vectors=vecs[:300]),
                                    dict(vectors=vecs[300:])],
                                   similarity="dot_product", device="cpu")
    with pytest.raises(ValueError, match="shard counts"):
        port.fused_search_device(tp, kp2, [fq], fusion="rrf")
    with pytest.raises(ValueError, match="unknown fusion"):
        port.fused_search_device(
            port.DistributedSearchPlane([corpus], "body", device="cpu",
                                        dense_threshold=1 << 30),
            kp, [fq], fusion="max")
