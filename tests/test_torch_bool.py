"""The port's bool-tree step (K9's plain version, the plane's
``search_bool`` and ``bool_rescore_device``) against the JAX package, on
the CPU.

Both sides pack the same seeded corpora. The JAX plane runs its jitted
bool step (host serving off), the port its plain PyTorch versions
(``device="cpu"``). BM25 sums follow one f32 order on both sides, so
scores are bitwise equal, and hits, their order and totals are equal.
The rescore stage's combine is bitwise too: both compute what XLA:CPU
compiles (``fma(rw, secondary, qw·primary)`` for total and avg).
"""

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.fused_query import bool_bm25_topk_body
from elasticsearch_tpu.ops.sorted_merge import \
    bm25_merge_candidates as ref_merge_candidates
from elasticsearch_tpu.parallel import DistributedSearchPlane as JaxPlane
from elasticsearch_tpu.parallel import make_search_mesh
from elasticsearch_tpu.parallel import dist_search as ref
from elasticsearch_tpu_torch.ops.fused_query import (
    MAX_BOOL_CLAUSES, bool_bm25_topk, bool_bm25_topk_plain)
from elasticsearch_tpu_torch.ops.sorted_merge import bm25_merge_candidates
from elasticsearch_tpu_torch.parallel.dist_search import (
    DistributedSearchPlane, bool_clause_rows, bool_role_masks)
from elasticsearch_tpu_torch.search.query_planner import bool_rescore_device
from elasticsearch_tpu_torch.utils.synth import (split_csr_shards,
                                                 synthetic_csr_corpus_fast)
from torch_cases import bool_case

VOCAB = 128
MODES = ("total", "multiply", "avg", "max", "min")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# K9's plain version against bool_bm25_topk_body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,S", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("k", [10, 200])
def test_bool_plain_matches_reference_body(seed, S, k):
    c, bq = bool_case(seed, S=S)
    n_pad, L = c["n_pad"], c["L"]
    body = jax.jit(jax.vmap(jax.vmap(
        lambda pd, pi, st, ln, iw, cb, rq, ng, sh, ms: bool_bm25_topk_body(
            pd, pi, st, ln, iw, cb, rq, ng, sh, ms, n_pad=n_pad, L=L, k=k,
            with_count=True, nc=MAX_BOOL_CLAUSES),
        in_axes=(0, 0, 0, 0, None, None, None, None, None, None)),
        in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0)))
    rv, rd, rn = (np.asarray(x) for x in body(
        c["docs"], c["imps"], c["starts"], c["lengths"], bq["idfw"],
        bq["cbits"], bq["req"], bq["neg"], bq["shd"], bq["msm"]))
    args = [_t(c["docs"]), _t(c["imps"]), _t(c["starts"]),
            _t(c["lengths"])] + [_t(bq[n]) for n in
                                 ("idfw", "cbits", "req", "neg", "shd",
                                  "msm")]
    v, d, n = bool_bm25_topk_plain(*args, n_pad=n_pad, L=L, k=k)
    assert np.array_equal(_bits(v.numpy()), _bits(rv))
    assert np.array_equal(d.numpy(), rd)
    assert np.array_equal(n.numpy(), rn)
    # the wrapper takes the plain version for CPU tensors
    w = bool_bm25_topk(*args, n_pad=n_pad, L=L, k=k)
    assert all(torch.equal(x, y) for x, y in zip(w, (v, d, n)))
    v = v.numpy()
    fin = np.isfinite(v)
    assert fin[0].any() and (v[0][fin[0]] == 0.0).all()   # filter-only
    assert (v[4][fin[4]] == 0.0).any()                     # 0.0 kept
    assert not fin[3].any() and (n.numpy()[3] == 0).all()  # no slot
    assert fin[2].any()


def test_merge_carries_the_clause_bits_as_the_reference():
    """The plain merge's ``slot_bits`` channel: each group's OR of the
    bits of the slots holding its doc, at its last slot."""
    c, bq = bool_case(4, S=1)
    n_pad, L = c["n_pad"], c["L"]
    fn = jax.jit(lambda st, ln, iw, cb: ref_merge_candidates(
        c["docs"][0], c["imps"][0], st, ln, iw, n_pad=n_pad, L=L,
        slot_bits=cb))
    for b in range(c["starts"].shape[0]):
        args = (c["starts"][b, 0], c["lengths"][b, 0], bq["idfw"][b],
                bq["cbits"][b])
        want = [np.asarray(x) for x in fn(*args)]
        got = bm25_merge_candidates(_t(c["docs"][0]), _t(c["imps"][0]),
                                    *map(_t, args[:3]), n_pad=n_pad, L=L,
                                    slot_bits=_t(args[3]))
        assert len(got) == 5
        for g, w in zip(got, want):
            g = g.numpy()
            if w.dtype == np.float32:
                g, w = _bits(g), _bits(w)
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the plane: search_bool / serve_bool against the reference plane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    c = synthetic_csr_corpus_fast(np.random.RandomState(11), 600, VOCAB, 12)
    c["term_ids"] = {f"t{t}": t for t in range(VOCAB)}
    return c


def _shards(corpus, S):
    shards = split_csr_shards(corpus, S) if S > 1 else [corpus]
    for s in shards:
        s["term_ids"] = corpus["term_ids"]
    return shards


@pytest.fixture(scope="module", params=[1, 3], ids=["S1", "S3"])
def planes(request, corpus):
    S = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    shards = _shards(corpus, S)
    jp = JaxPlane(make_search_mesh(n_shards=S), shards, "body",
                  dense_threshold=1 << 30)
    tp = DistributedSearchPlane(shards, "body", device="cpu",
                                dense_threshold=1 << 30)
    mp.undo()
    assert jp._host_csr is None and tp.T_pad == 0
    return jp, tp


def bool_queries(corpus, seed, n=6):
    """Lowered bool trees over terms drawn ∝ df: a disjunction (msm 1),
    must + should + filter + must_not (msm 0), three should clauses with
    a shared term (msm 2), a filter-only tree, one with an unknown term in
    a must clause, and one with a term repeated in a clause."""
    rng = np.random.RandomState(seed)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    p = df[el] / df[el].sum()

    def terms(m):
        return [f"t{t}" for t in rng.choice(el, m, p=p)]

    out = []
    for i in range(n):
        a, b, c, d = terms(1), terms(3), terms(1), terms(1)
        out += [
            {"clauses": [("should", terms(8))], "msm": 1},
            {"clauses": [("must", a), ("should", b), ("filter", c),
                         ("must_not", d)], "msm": 0},
            {"clauses": [("should", b[:2]), ("should", b[1:]),
                         ("should", terms(2))], "msm": 2},
            {"clauses": [("filter", c + a)], "msm": 0},
            {"clauses": [("must", ["nope"]), ("should", b)], "msm": 0},
            {"clauses": [("must", a + a), ("should", b + b[:1])],
             "msm": 0},
        ][i % 6:i % 6 + 1]
    return out


def _same(got, want):
    assert got[1] == want[1]                       # hits
    assert got[2] == want[2]                       # totals
    gv, wv = np.asarray(got[0]), np.asarray(want[0])
    assert gv.shape == wv.shape
    assert np.array_equal(_bits(gv), _bits(wv))


@pytest.mark.parametrize("k", [10, 1000])
def test_search_bool_matches_reference(planes, corpus, k):
    jp, tp = planes
    qs = bool_queries(corpus, 5, n=12)
    st = {}
    got = tp.search_bool(qs, k=k, with_totals=True, stages=st)
    want = jp.search_bool(qs, k=k, with_totals=True)
    _same(got, want)
    assert any(t > 0 for t in got[2]) and got[2][4] == 0
    assert any(0.0 in [float(x) for x in row] for row in got[0])
    assert {"prep_ms", "dispatch_ms", "fetch_ms", "h2d_bytes",
            "d2h_bytes"} <= set(st)
    _same(tp.serve_bool(qs, k=k, with_totals=True), want)
    v, h = tp.search_bool(qs[:3], k=k)
    assert h == want[1][:3]


def test_search_bool_with_delta_stats_matches_reference(planes, corpus):
    jp, tp = planes
    qs = bool_queries(corpus, 8, n=6)
    kw = dict(extra_docs=57, extra_df={"t3": 9, "t10": 2})
    _same(tp.search_bool(qs, k=10, with_totals=True, **kw),
          jp.search_bool(qs, k=10, with_totals=True, **kw))


def test_bool_helpers_match_reference(planes, corpus):
    jp, tp = planes
    qs = bool_queries(corpus, 6, n=12)
    assert tp.bool_slot_count(qs) == jp.bool_slot_count(qs)
    Q = 16
    for a, b in zip(tp.bool_inputs(qs, Q), jp.bool_inputs(qs, Q)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for q in qs:
        cl = q["clauses"]
        assert bool_role_masks(cl) == ref.bool_role_masks(cl)
        assert bool_clause_rows(cl, lambda t: len(t) * 0.5) == \
            ref.bool_clause_rows(cl, lambda t: len(t) * 0.5)
        assert tp._bool_clause_idfw(cl, 3, {"t1": 4}) == \
            jp._bool_clause_idfw(cl, 3, {"t1": 4})


def test_dense_term_batch_raises_on_both_sides(corpus):
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_PLANE_HOST_SERVE", "0")
    jp = JaxPlane(make_search_mesh(n_shards=1), [corpus], "body",
                  dense_threshold=40)
    tp = DistributedSearchPlane([corpus], "body", device="cpu",
                                dense_threshold=40)
    mp.undo()
    head = f"t{int(np.argmax(corpus['df']))}"
    assert tp.has_dense_terms([head]) and jp.has_dense_terms([head])
    assert not tp.has_dense_terms(["t120"])
    assert not jp.has_dense_terms(["t120"])
    qs = [{"clauses": [("must", [head]), ("should", ["t120"])], "msm": 0}]
    with pytest.raises(ValueError, match="dense-tier"):
        jp.search_bool(qs, k=10)
    with pytest.raises(ValueError, match="dense-tier"):
        tp.search_bool(qs, k=10)


# ---------------------------------------------------------------------------
# bool_rescore_device against the reference's bool step with Q2 > 0
# ---------------------------------------------------------------------------


def _ref_bool_rescore(jp, bqs, items, wt, mode):
    """The reference's ``FusedPlanRunner._bool_rescore_device`` on a plane
    (``build_bool_bm25_step`` with ``Q2 > 0`` fed the plane's inputs)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from elasticsearch_tpu.parallel.mesh import AXIS_REPLICA, AXIS_SHARD
    from elasticsearch_tpu.utils.shapes import round_up_pow2
    mesh = jp.mesh
    pad_rs = {"terms": [], "qw": 1.0, "rw": 1.0, "window": 0}
    rss = [it.get("rescore") or pad_rs for it in items]
    Q = max(jp.SERVING_Q_MIN, round_up_pow2(jp.bool_slot_count(bqs)))
    (starts, lengths, idfw, cbits, req, neg, shd, msm, max_len,
     _d) = jp.bool_inputs(bqs, Q)
    L = min(jp.ladder_L(max_len), jp.L_cap)
    np.minimum(lengths, L, out=lengths)
    bags2 = [list(rs["terms"]) for rs in rss]
    Q2 = max(8, round_up_pow2(max(max(len(set(b)) for b in bags2), 1)))
    st2, ln2, iw2 = jp._lookup(bags2, Q2)[:3]
    qw = np.asarray([rs["qw"] for rs in rss], np.float32)
    rw = np.asarray([rs["rw"] for rs in rss], np.float32)
    rwin = np.asarray([rs["window"] for rs in rss], np.int32)
    step = ref.build_bool_bm25_step(
        mesh, n_pad=jp.n_pad, Q=Q, L=L, k=wt, nc=MAX_BOOL_CLAUSES,
        n_shards=jp.n_shards, with_count=True, Q2=Q2, rescore_mode=mode)
    r1 = NamedSharding(mesh, P(AXIS_REPLICA))
    r2 = NamedSharding(mesh, P(AXIS_REPLICA, None))
    r3 = NamedSharding(mesh, P(AXIS_REPLICA, AXIS_SHARD, None))
    put = jax.device_put
    out = step(jp.docs_dev, jp.impacts_dev, put(starts, r3),
               put(lengths, r3), put(idfw, r2), put(cbits, r2),
               put(req, r1), put(neg, r1), put(shd, r1), put(msm, r1),
               put(st2, r3), put(ln2, r3), put(iw2, r2), put(qw, r1),
               put(rw, r1), put(rwin, r1))
    vals, gdocs, counts = (np.asarray(o) for o in out)
    hits = []
    for b in range(len(bqs)):
        row = []
        for v, g in zip(vals[b], gdocs[b]):
            if v == -np.inf:
                break
            row.append((int(g) // jp.n_pad, int(g) % jp.n_pad))
        hits.append(row)
    return vals, hits, [int(c) for c in counts]


@pytest.mark.parametrize("mode", MODES)
def test_bool_rescore_device_matches_reference(planes, corpus, mode):
    jp, tp = planes
    rng = np.random.RandomState(21)
    bqs = bool_queries(corpus, 9, n=6)
    el = np.flatnonzero(corpus["df"] >= 2)
    items = []
    for i in range(len(bqs)):
        terms = [f"t{t}" for t in rng.choice(el, 2)]
        items.append({"rescore": None if i == 3 else {
            "terms": terms, "qw": 0.7, "rw": 1.3,
            "window": [50, 0, 5, 0, 3, 1000][i]}})
    got = bool_rescore_device(tp, bqs, items, 64, mode, stages={})
    want = _ref_bool_rescore(jp, bqs, items, 64, mode)
    _same(got, want)
    assert any(len(h) > 1 for h in got[1])
