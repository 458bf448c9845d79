"""K10's count limit (``csrc/fuse_rank.cu``), which its wrapper shares,
and K5's sizes (``csrc/bisect_exact_scores.cu``), read from the sources,
and models of the two kernels' algorithms held against
the plain versions and the JAX package, on the CPU.

K10 ranks a query of at most ``K10_COUNT_MAX`` entries by counting: each
id's first position and first kNN position from a table keyed by id, a key
of (the score's ordered bits, the id) an entry, its output position the
count of entries with a smaller (key, position). K5 searches each (slot,
candidate) in a pivot table of every ceil(len / T)-th doc of the slot's
run, then the segment between two pivots by a (g + 1)-ary search of g
lanes, and sums the found impacts from the highest slot down. The models
below follow those steps in numpy; the card tests
(``tests/test_torch_cuda.py``) hold the kernels to the plain versions.
"""

import functools
import inspect
import re

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fused_query as rfq
from elasticsearch_tpu_torch.kernels.build import CSRC_DIR
from elasticsearch_tpu_torch.ops import fused_query as fq
from elasticsearch_tpu_torch.ops.topk import H100_SHARED_OPTIN
from elasticsearch_tpu_torch.parallel import dist_search
from elasticsearch_tpu_torch.parallel.dist_search import (
    DistributedKnnPlane, DistributedSearchPlane, fused_search_device)
from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
from torch_cases import fusion_case, runs_case

K10_SRC = (CSRC_DIR / "fuse_rank.cu").read_text()
K5_SRC = (CSRC_DIR / "bisect_exact_scores.cu").read_text()


def _defines(src, prefix):
    return {m[1]: int(m[2], 0) for m in
            re.finditer(rf"^#define {prefix}_(\w+) (0x[0-9A-Fa-f]+|\d+)",
                        src, re.M)}


K10 = _defines(K10_SRC, "K10")
K5 = _defines(K5_SRC, "K5")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the sizes
# ---------------------------------------------------------------------------


def test_k10_count_limit_is_the_sources():
    """The wrapper's K10_COUNT_MAX is the source's; the counting path's
    static arrays (five of K10_COUNT_MAX entries, a key of 8 bytes, and a
    table of three words a slot) fit the 48 KB a block has without opting
    in; the table has twice the entries' slots, a power of two."""
    assert fq.K10_COUNT_MAX == K10["COUNT_MAX"] == 512
    assert "#define K10_HASH (2 * K10_COUNT_MAX)" in K10_SRC
    n, h = K10["COUNT_MAX"], 2 * K10["COUNT_MAX"]
    assert h & (h - 1) == 0
    assert ">> 22) & (K10_HASH - 1)" in K10_SRC and h == 1 << 10
    assert n * (8 + 4 * 4) + h * 12 <= 48 * 1024
    assert K10["COUNT_THREADS"] >= K10["COUNT_MAX"]


def test_k10_workspace_is_asked_of_the_source_past_the_count_limit():
    """The counting path needs no workspace, so the wrapper asks the C
    entry for one only past K10_COUNT_MAX; the C query gives none up to
    it either, and past it the sort's (es_sort_workspace_bytes)."""
    assert "return n <= K10_COUNT_MAX ? 0 : es_sort_workspace_bytes(n, B);" \
        in K10_SRC
    assert "na + nb <= K10_COUNT_MAX" in inspect.getsource(fq.fuse_rank)


def _k5_shared_bytes(Qc, RC):
    """``k5_shared_bytes`` of the source."""
    return 4 * (Qc * K5["PIVOTS"] + 5 * Qc + 3 * RC + 4 * RC * Qc + 1)


def test_k5_sizes_are_the_sources():
    """T is a power of two; a chunk of slots is the pivot table's cells
    over T; the largest block (a full chunk, K5_ITEMS / chunk candidates)
    fits an H100's shared memory, so no Q is refused; the shared-memory
    rule is the source's."""
    T = K5["PIVOTS"]
    assert T == 128 and T & (T - 1) == 0
    assert "#define K5_SLOTS (K5_PIVOT_CELLS / K5_PIVOTS)" in K5_SRC
    slots = K5["PIVOT_CELLS"] // T
    assert slots == 256
    assert _k5_shared_bytes(slots, K5["ITEMS"] // slots) <= H100_SHARED_OPTIN
    assert "return 4 * ((size_t)Qc * K5_PIVOTS + 5 * (size_t)Qc + " \
           "3 * (size_t)RC +\n              4 * (size_t)RC * Qc + 1);" \
        in K5_SRC
    # the wrapper holds none of K5's sizes: the C entry plans the launch
    assert not any(n.startswith("K5_") for n in vars(fq))


# ---------------------------------------------------------------------------
# K10: the counting fusion's model
# ---------------------------------------------------------------------------

F = np.float32


def _knn_score(sim, raw):
    raw = F(raw)
    if sim in ("cosine", "dot_product"):
        return F(F(F(1) + raw) / F(2))
    if sim == "max_inner_product":
        return F(F(1) / F(F(1) - raw)) if raw < 0 else F(raw + F(1))
    return F(F(1) / F(F(1) + F(max(F(0), -raw))))


def count_fuse_model(tv, tg, kv, kg, wt, wk, rc, kboost, *, n_pad_t,
                     n_pad_k, UP, pad_id, fusion, similarity, k,
                     payload=None):
    """K10's counting path in numpy, query by query."""
    B, na = tv.shape
    nb = kv.shape[1]
    n = na + nb
    vals = np.full((B, k), -np.inf, F)
    ids = np.full((B, k), pad_id, np.int32)
    sel = np.zeros((B, k), np.int32)
    sec = np.zeros((B, k), F)
    fnd = np.zeros((B, k), bool)
    for b in range(B):
        uid = np.full(n, pad_id, np.int64)
        for j in range(n):
            v, g, w, p, npd = ((tv[b, j], tg[b, j], wt[b], j, n_pad_t)
                               if j < na else
                               (kv[b, j - na], kg[b, j - na], wk[b], j - na,
                                n_pad_k))
            if v > -np.inf and p < w:
                uid[j] = (int(g) // npd) * UP + int(g) % npd
        first, knn_first = {}, {}
        for j in range(n):
            if uid[j] != pad_id:
                first.setdefault(uid[j], j)
                if j >= na:
                    knn_first.setdefault(uid[j], j)
        k2 = np.full(n, np.inf, F)
        for j in range(n):
            if uid[j] == pad_id or first[uid[j]] != j:
                continue
            if j < na:
                twin = knn_first.get(uid[j])
                pa, pb = j, (twin - na if twin is not None else -1)
            else:
                pa, pb = -1, j - na
            if fusion == "rrf":
                sa = F(F(1) / F(F(F(rc[b]) + F(pa)) + F(1))) if pa >= 0 \
                    else F(0)
                sb = F(F(1) / F(F(F(rc[b]) + F(pb)) + F(1))) if pb >= 0 \
                    else F(0)
            else:
                sa = F(tv[b, pa]) if pa >= 0 else F(0)
                sb = F(_knn_score(similarity, kv[b, pb]) * F(kboost[b])) \
                    if pb >= 0 else F(0)
            k2[j] = -F(sa + sb)
        u = np.where(k2 == 0, F(0), k2).astype(F).view(np.uint32)
        u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
        key = (u << np.uint64(32)) | (uid.astype(np.int64) ^ 0x80000000
                                      ).astype(np.uint32).astype(np.uint64)
        pos = np.arange(n)
        less = (key[None, :] < key[:, None]) | (
            (key[None, :] == key[:, None]) & (pos[None, :] < pos[:, None]))
        rank = less.sum(1)
        assert np.array_equal(np.sort(rank), pos)   # a permutation
        for j in range(n):
            r = rank[j]
            if r >= k:
                continue
            scored = k2[j] != np.inf
            vals[b, r] = -k2[j] if scored else -np.inf
            ids[b, r] = uid[j] if scored else pad_id
            sel[b, r] = j
        if payload is not None:
            cat_s = np.concatenate([payload[0][b], payload[2][b]])
            cat_f = np.concatenate([payload[1][b], payload[3][b]])
            sec[b], fnd[b] = cat_s[sel[b]], cat_f[sel[b]]
    out = (vals, ids, sel)
    return out + (sec, fnd) if payload is not None else out


def _case(seed, B, W, cut):
    c = fusion_case(seed, B=B, W=W)
    if not cut:
        c["wt"][:] = W
        c["wk"][:] = W
    return c


@pytest.mark.parametrize("fusion", ["rrf", "sum"])
@pytest.mark.parametrize("similarity", ["dot_product", "max_inner_product",
                                        "l2_norm"])
@pytest.mark.parametrize("W,cut", [(1, False), (16, False), (16, True),
                                   (128, True), (256, True)])
def test_count_fuse_model_equals_plain(fusion, similarity, W, cut):
    """Ties (RRF's equal ranks, the text lists' equal scores), twins (a
    third of a kNN list in the text list), windows that cut a list, −inf
    tails: the model's values, ids and sel are the plain version's bits;
    with the payload, its (sec, fnd) too."""
    c = _case(W + 3 * cut, 5, W, cut)
    rng = np.random.RandomState(W)
    B = c["tv"].shape[0]
    payload = (rng.rand(B, W).astype(F), rng.rand(B, W) < 0.5,
               rng.rand(B, W).astype(F), rng.rand(B, W) < 0.5)
    kw = dict(n_pad_t=c["n_pad_t"], n_pad_k=c["n_pad_k"], UP=c["UP"],
              pad_id=c["pad_id"], fusion=fusion, similarity=similarity)
    args = [c[n] for n in ("tv", "tg", "kv", "kg", "wt", "wk", "rc",
                           "kboost")]
    for k in (2 * W, min(10, 2 * W), 2 * W + 3):
        want = fq.fuse_rank_plain(*map(_t, args), **kw, k=k,
                                  **dict(zip(("tsec", "tfnd", "ksec",
                                              "kfnd"), map(_t, payload))))
        got = count_fuse_model(*args, **kw, k=k, payload=payload)
        for g, w in zip(got, want):
            g, w = np.asarray(g), w.numpy()
            if g.dtype == F:
                g, w = g.view(np.int32), w.view(np.int32)
            assert np.array_equal(g, w)
    v = np.asarray(got[0])
    if fusion == "rrf" and W > 1:
        assert (v[:, 1:] == v[:, :-1])[np.isfinite(v[:, 1:])].any()


@pytest.mark.parametrize("fusion", ["rrf", "sum"])
@pytest.mark.parametrize("W,cut", [(16, False), (100, True)])
def test_count_fuse_model_matches_reference(fusion, W, cut):
    """The model against the JAX package's rrf_fuse_body / sum_fuse_body
    (``elasticsearch_tpu/ops/fused_query.py:163``, ``:181``) on the
    unified, windowed lists: values and ids bitwise, sel equal at finite
    slots (the reference leaves the order of −inf slots open)."""
    c = _case(40 + W, 6, W, cut)
    kw = dict(n_pad_t=c["n_pad_t"], n_pad_k=c["n_pad_k"], UP=c["UP"],
              pad_id=c["pad_id"], fusion=fusion, similarity="dot_product")
    args = [c[n] for n in ("tv", "tg", "kv", "kg", "wt", "wk", "rc",
                           "kboost")]
    tv, tg, kv, kg, wt, wk, rc, kboost = args
    pad = c["pad_id"]
    pos = np.arange(W)
    t_ok = (tv > -np.inf) & (pos[None, :] < wt[:, None])
    k_ok = (kv > -np.inf) & (pos[None, :] < wk[:, None])
    tug = np.where(t_ok, (tg // c["n_pad_t"]) * c["UP"] + tg % c["n_pad_t"],
                   pad).astype(np.int32)
    kug = np.where(k_ok, (kg // c["n_pad_k"]) * c["UP"] + kg % c["n_pad_k"],
                   pad).astype(np.int32)
    k = 2 * W
    if fusion == "rrf":
        ref = jax.jit(jax.vmap(functools.partial(rfq.rrf_fuse_body, k=k,
                                                 pad_id=pad)))
        want = ref(tug, kug, rc)
    else:
        ks = np.where(k_ok, np.asarray(rfq.knn_raw_to_score(
            "dot_product", kv)) * kboost[:, None], -np.inf).astype(F)
        ts = np.where(t_ok, tv, -np.inf).astype(F)
        ref = jax.jit(jax.vmap(functools.partial(rfq.sum_fuse_body, k=k,
                                                 pad_id=pad)))
        want = ref(tug, ts, kug, ks)
    got = count_fuse_model(*args, **kw, k=k)
    wv, wi, ws = (np.asarray(x) for x in want)
    assert np.array_equal(_bits(got[0]), _bits(wv))
    assert np.array_equal(got[1], wi)
    fin = np.isfinite(wv)
    assert np.array_equal(got[2][fin], ws[fin])
    assert fin.any() and not fin.all()


# ---------------------------------------------------------------------------
# K5: the pivot search's model
# ---------------------------------------------------------------------------


def pivot_search_model(pd, pi, starts, lengths, idfw, cand, *, n_pad, T, g,
                       cand2=None, vals2=None):
    """K5 in numpy: pivots every stride-th doc (the run itself at len <=
    T), the lower bound among them, the open segment narrowed by a
    (g + 1)-ary search of g lanes and read at last by them, the impacts
    found, the sum from the highest slot down. Returns the plain version's
    (score, found) for each list."""
    B, S, Q = starts.shape
    lists = [(cand, None)] + ([(cand2, vals2)] if cand2 is not None
                              else [])
    outs = []
    for cd, vl in lists:
        R = cd.shape[2]
        score = np.zeros((B, S, R), F)
        found = np.zeros((B, S, R), bool)
        for b in range(B):
            for s in range(S):
                for r in range(R):
                    doc = int(cd[b, s, r])
                    if doc >= n_pad or (vl is not None
                                        and not vl[b, s, r] > -np.inf):
                        continue
                    acc, anyf = F(0), False
                    for q in range(Q - 1, -1, -1):
                        p = _slot_search(pd[s], int(starts[b, s, q]),
                                         int(lengths[b, s, q]), doc, T, g)
                        if p >= 0:
                            acc = F(acc + F(F(idfw[b, q]) * F(pi[s, p])))
                            anyf = True
                    score[b, s, r], found[b, s, r] = acc, anyf
        outs += [score, found]
    return outs


def _slot_search(ds, st, ln, doc, T, g):
    """The kernel's search of one (candidate, slot): the absolute position
    of doc in its run, or -1."""
    if ln <= 0:
        return -1
    stride = 1 if ln <= T else -(-ln // T)
    npiv = -(-ln // stride)
    piv = ds[st + np.arange(npiv) * stride]
    j = int(np.searchsorted(piv, doc, "left"))
    if stride == 1 or j == 0:
        return st + j * stride if j * stride < ln and piv[j] == doc else -1
    lo, hi = (j - 1) * stride + 1, min(j * stride, ln)
    if lo >= hi:
        return st + hi if hi < ln and piv[j] == doc else -1
    d = ds[st:]
    while hi - lo >= g:                   # g lanes sample the segment
        step = (hi - lo + g) // (g + 1)
        idx = lo + (np.arange(g) + 1) * step - 1
        cnt = int(((idx < hi) & (d[np.minimum(idx, ln - 1)] < doc)).sum())
        if cnt < g:
            hi = min(hi, lo + (cnt + 1) * step - 1)
        lo += cnt * step
    idx = lo + np.arange(g)               # the last read, hi included
    inside = (idx <= hi) & (idx < ln)
    v = np.where(inside, d[np.minimum(idx, ln - 1)], 0)
    cnt = int((inside & (idx < hi) & (v < doc)).sum())
    p = lo + cnt
    return st + p if p < ln and v[min(cnt, g - 1)] == doc else -1


RUN_LENGTHS = (0, 1, 2, 31, 1023, 1024, 1025, 2047, 33 * 1024 + 5)


@pytest.mark.parametrize("g", [1, 4, 32])
@pytest.mark.parametrize("Q,T", [(1, 128), (2, 128), (8, 128), (8, 1024),
                                 (300, 64), (3, 32)])
def test_pivot_search_model_equals_plain(g, Q, T):
    """Runs of length 0, 1, T - 1, T, T + 1 and past 32 T, candidates at
    runs' ends, inside, between and outside them, n_pad and n_pad - 1,
    two shards: the model at every group width is the plain version's
    bits."""
    c = runs_case(Q * 7 + g, S=2, B=3, Q=Q, R=24, lengths=RUN_LENGTHS +
                  (T - 1, T, T + 1), n_pad=1 << 20, R2=9)
    args = [c[n] for n in ("postings_docs", "postings_impact", "starts",
                           "lengths", "idfw", "cand_docs")]
    want = fq.bisect_exact_scores_plain(
        *map(_t, args), n_pad=c["n_pad"], cand_docs2=_t(c["cand_docs2"]),
        cand_vals2=_t(c["cand_vals2"]))
    got = pivot_search_model(*args, n_pad=c["n_pad"], T=T, g=g,
                             cand2=c["cand_docs2"], vals2=c["cand_vals2"])
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        y = y.numpy()
        if x.dtype == F:
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y)
    assert got[1].any() and not got[1].all()


def test_pivot_search_model_matches_reference():
    """The model against the JAX package's bisect_exact_scores
    (``elasticsearch_tpu/ops/fused_query.py:93``), one (query, shard) at a
    time: scores bitwise, found equal."""
    c = runs_case(5, S=2, B=2, Q=8, R=40, lengths=RUN_LENGTHS + (127, 128,
                                                               129),
                  n_pad=1 << 20)
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda pd, pi, st, ln, iw, cd: rfq.bisect_exact_scores(
            pd, pi, st, ln, iw, cd, n_pad=c["n_pad"]),
        in_axes=(0, 0, 0, 0, None, 0)), in_axes=(None, None, 0, 0, 0, 0)))
    args = [c[n] for n in ("postings_docs", "postings_impact", "starts",
                           "lengths", "idfw", "cand_docs")]
    want = ref(*args)
    got = pivot_search_model(*args, n_pad=c["n_pad"], T=K5["PIVOTS"],
                             g=32)
    assert np.array_equal(got[0].view(np.int32),
                          np.asarray(want[0]).view(np.int32))
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[1].any()


def test_two_lists_plain_is_two_calls():
    """The plain version with a second list is two calls, the second list's
    entries at −inf made empty first."""
    c = runs_case(9, S=1, B=4, Q=4, R=12, lengths=(5, 2000, 70000),
                  R2=16)
    args = [_t(c[n]) for n in ("postings_docs", "postings_impact", "starts",
                               "lengths", "idfw", "cand_docs")]
    both = fq.bisect_exact_scores_plain(
        *args, n_pad=c["n_pad"], cand_docs2=_t(c["cand_docs2"]),
        cand_vals2=_t(c["cand_vals2"]))
    one = fq.bisect_exact_scores_plain(*args, n_pad=c["n_pad"])
    d2 = np.where(c["cand_vals2"] > -np.inf, c["cand_docs2"], c["n_pad"])
    two = fq.bisect_exact_scores_plain(*args[:5], _t(d2.astype(np.int32)),
                                       n_pad=c["n_pad"])
    for x, y in zip(both, one + two):
        assert torch.equal(x, y)
    assert not both[3].numpy()[c["cand_vals2"] == -np.inf].any()


# ---------------------------------------------------------------------------
# the hybrid rescore's payload
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_planes():
    corpus = synthetic_csr_corpus_fast(np.random.RandomState(21), 900, 96,
                                       14)
    corpus["term_ids"] = {f"t{t}": t for t in range(96)}
    rng = np.random.RandomState(22)
    vecs = rng.randint(-3, 4, size=(800, 8)).astype(np.float32)
    tp = DistributedSearchPlane([corpus], "body", device="cpu",
                                dense_threshold=1 << 30)
    kp = DistributedKnnPlane([dict(vectors=vecs)], similarity="dot_product",
                             device="cpu")
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    fqs = []
    for i in range(6):
        terms = [f"t{t}" for t in rng.choice(el, 4, p=df[el] / df[el].sum())]
        fqs.append(dict(clauses=[("should", terms)], msm=1,
                        qv=rng.randint(-3, 4, 8).astype(np.float32),
                        rc=60.0, wt=[16, 16, 5, 0, 16, 9][i],
                        wk=[16, 3, 16, 16, 0, 9][i], k=10, kboost=1.0,
                        rescore={"terms": terms[:2], "qw": 0.7, "rw": 1.3,
                                 "window": [10, 0, 32, 5, 12, 3][i]}))
    return tp, kp, fqs


@pytest.mark.parametrize("fusion", ["rrf", "sum"])
@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_hybrid_rescore_payload_matches_reference(hybrid_planes, monkeypatch,
                                                  fusion, mode):
    """fused_hybrid_step's one K5 call scores both lists as the JAX
    package's bisect_exact_scores does each; its K10 call carries the
    payload through the fusion, and (sec, fnd) at each finite fused slot
    are the reference's payload gathered at the reference's selection
    (``rrf_fuse_body``/``sum_fuse_body``)."""
    tp, kp, fqs = hybrid_planes
    calls = []
    for name in ("bisect_exact_scores", "fuse_rank"):
        orig = getattr(dist_search, name)

        def rec(*a, _n=name, _o=orig, **kw):
            out = _o(*a, **kw)
            calls.append((_n, a, kw, out))
            return out
        monkeypatch.setattr(dist_search, name, rec)
    fused_search_device(tp, kp, fqs, fusion=fusion, rescore_mode=mode)
    (_, a5, kw5, o5), = [c for c in calls if c[0] == "bisect_exact_scores"]
    (_, a10, kw10, o10), = [c for c in calls if c[0] == "fuse_rank"]
    assert kw5["cand_docs2"] is not None and len(o5) == 4
    n_pad = kw5["n_pad"]
    ref5 = jax.jit(jax.vmap(jax.vmap(
        lambda pd, pi, st, ln, iw, cd: rfq.bisect_exact_scores(
            pd, pi, st, ln, iw, cd, n_pad=n_pad),
        in_axes=(0, 0, 0, 0, None, 0)), in_axes=(None, None, 0, 0, 0, 0)))
    pd, pi, st, ln, iw, td = (x.numpy() for x in a5)
    kd = np.where(kw5["cand_vals2"].numpy() > -np.inf,
                  kw5["cand_docs2"].numpy(), n_pad).astype(np.int32)
    for (sec, fnd), cd in ((o5[:2], td), (o5[2:], kd)):
        ws, wf = ref5(pd, pi, st, ln, iw, cd)
        assert np.array_equal(_bits(sec.numpy()), _bits(ws))
        assert np.array_equal(fnd.numpy(), np.asarray(wf))
    assert kw10["tsec"] is not None and len(o10) == 5
    tv, tg, kv, kg, wt, wk, rc, kboost = (x.numpy() for x in a10)
    pad = kw10["pad_id"]
    W = tv.shape[1]
    pos = np.arange(W)
    t_ok = (tv > -np.inf) & (pos[None, :] < wt[:, None])
    k_ok = (kv > -np.inf) & (pos[None, :kv.shape[1]] < wk[:, None])
    npt, npk, UP = kw10["n_pad_t"], kw10["n_pad_k"], kw10["UP"]
    tug = np.where(t_ok, (tg // npt) * UP + tg % npt, pad).astype(np.int32)
    kug = np.where(k_ok, (kg // npk) * UP + kg % npk, pad).astype(np.int32)
    k = kw10["k"]
    if fusion == "rrf":
        want = jax.jit(jax.vmap(functools.partial(
            rfq.rrf_fuse_body, k=k, pad_id=pad)))(tug, kug, rc)
    else:
        ks = np.where(k_ok, np.asarray(rfq.knn_raw_to_score(
            "dot_product", kv)) * kboost[:, None], -np.inf).astype(F)
        ts = np.where(t_ok, tv, -np.inf).astype(F)
        want = jax.jit(jax.vmap(functools.partial(
            rfq.sum_fuse_body, k=k, pad_id=pad)))(tug, ts, kug, ks)
    wv, ws = np.asarray(want[0]), np.asarray(want[2])
    cat_s = np.concatenate([kw10["tsec"].numpy(), kw10["ksec"].numpy()], 1)
    cat_f = np.concatenate([kw10["tfnd"].numpy(), kw10["kfnd"].numpy()], 1)
    fin = np.isfinite(wv)
    assert fin.any()
    assert np.array_equal(_bits(o10[0].numpy()), _bits(wv))
    assert np.array_equal(
        _bits(o10[3].numpy()[fin]),
        _bits(np.take_along_axis(cat_s, ws, 1)[fin]))
    assert np.array_equal(o10[4].numpy()[fin],
                          np.take_along_axis(cat_f, ws, 1)[fin])
    assert o10[4].numpy()[fin].any()
