"""Seeded numpy inputs shared by the PyTorch port's parity tests.

Everything is built with numpy from a seed, so the JAX reference and the
port see byte-identical inputs. Impacts and weights come from small value
sets so that equal scores (and with them the tie order) are common; some
query slots are empty runs, and the postings tables carry the ``n_pad``
sentinel padding the sorted-merge kernels rely on.
"""

from __future__ import annotations

import numpy as np


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even) and return the int16 bit pattern."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return r.astype(np.uint16).view(np.int16)


def sparse_case(seed: int, *, S: int, B: int, Q: int, L: int,
                n_pad: int = 4096, n_runs: int = 24) -> dict:
    """Postings tables i32/f32[S, P] and per-query run slots."""
    rng = np.random.RandomState(seed)
    imp_set = np.array([0.5, 0.75, 1.0, 1.25, 1.5], np.float32)
    tables_d, tables_i, run_st, run_ln = [], [], [], []
    for _ in range(S):
        docs, imps, st, ln = [], [], [], []
        pos = 0
        for r in range(n_runs):
            n = 0 if r % 7 == 3 else int(rng.randint(1, L + 1))
            d = np.sort(rng.choice(n_pad - 5, size=n, replace=False))
            docs.append(d.astype(np.int32))
            imps.append(rng.choice(imp_set, size=n))
            st.append(pos)
            ln.append(n)
            pos += n
        P = -(-(pos + L) // 256) * 256
        td = np.full(P, n_pad, np.int32)
        ti = np.zeros(P, np.float32)
        td[:pos] = np.concatenate(docs)
        ti[:pos] = np.concatenate(imps)
        tables_d.append(td)
        tables_i.append(ti)
        run_st.append(np.array(st))
        run_ln.append(np.array(ln))
    P = max(t.shape[0] for t in tables_d)
    docs = np.full((S, P), n_pad, np.int32)
    imps = np.zeros((S, P), np.float32)
    for s in range(S):
        docs[s, :tables_d[s].shape[0]] = tables_d[s]
        imps[s, :tables_i[s].shape[0]] = tables_i[s]
    pick = rng.randint(0, n_runs, size=(B, S, Q))
    starts = np.zeros((B, S, Q), np.int32)
    lengths = np.zeros((B, S, Q), np.int32)
    for s in range(S):
        starts[:, s] = run_st[s][pick[:, s]]
        lengths[:, s] = run_ln[s][pick[:, s]]
    lengths[rng.rand(B, S, Q) < 0.15] = 0          # empty slots
    idfw = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), size=(B, Q))
    return dict(docs=docs, imps=imps, starts=starts, lengths=lengths,
                idfw=idfw.astype(np.float32), n_pad=n_pad, L=L)


def bool_case(seed: int, *, S: int, L: int = 48, n_pad: int = 4096):
    """``sparse_case`` runs with clause bits and role masks per query:
    a filter-only tree, must + should + must_not, three should clauses at
    msm 2 with one term in two of them, a must clause with no slot, and
    random trees."""
    B, Q = 8, 6
    c = sparse_case(seed, S=S, B=B, Q=Q, L=L, n_pad=n_pad)
    rng = np.random.RandomState(seed + 100)
    cbits = np.zeros((B, Q), np.int32)
    idfw = c["idfw"].copy()
    req = np.zeros(B, np.int32)
    neg = np.zeros(B, np.int32)
    shd = np.zeros(B, np.int32)
    msm = np.zeros(B, np.int32)
    # 0: one filter clause: every hit scores 0.0
    cbits[0] = 1
    idfw[0] = 0.0
    req[0] = 1
    # 1: must (c0), should (c1), must_not (c2)
    cbits[1] = [1, 1, 2, 2, 4, 4]
    idfw[1, 4:] = 0.0
    req[1], neg[1], shd[1] = 1, 4, 2
    # 2: should c0, c1, c2 at msm 2; slots 1 and 2 are one term in c0, c1
    cbits[2] = [1, 1, 2, 2, 4, 4]
    c["starts"][2, :, 2] = c["starts"][2, :, 1]
    c["lengths"][2, :, 2] = c["lengths"][2, :, 1]
    shd[2], msm[2] = 7, 2
    # 3: a must clause (c3) that has no slot: no hits
    cbits[3] = [1, 1, 2, 2, 4, 4]
    req[3], shd[3], msm[3] = 8, 7, 1
    # 4: filter (c0) + should (c1) at msm 0: filter-only docs score 0.0
    cbits[4] = [1, 1, 1, 2, 2, 2]
    idfw[4, :3] = 0.0
    req[4], shd[4] = 1, 2
    for b in range(5, B):                    # random trees of 4 clauses
        cl = rng.randint(0, 4, size=Q)
        cbits[b] = 1 << cl
        roles = rng.randint(0, 4, size=4)    # must, should, filter, not
        for ci, r in enumerate(roles):
            bit = 1 << ci
            if r in (0, 2):
                req[b] |= bit
            elif r == 3:
                neg[b] |= bit
            else:
                shd[b] |= bit
            if r >= 2:
                idfw[b, cl == ci] = 0.0
        msm[b] = rng.randint(0, 2)
    return c, dict(idfw=idfw, cbits=cbits, req=req, neg=neg, shd=shd,
                   msm=msm)


def dense_case(seed: int, *, S: int, B: int, Q: int, T: int,
               n_pad: int = 4096, C: int = 1024, U=None,
               density: float = 0.3) -> dict:
    """Dense rows (bf16 bits [S, n_blk, T, C]) and the slot inputs the
    tiered step takes: rid/w [B, S, Q] and W [B, S, U or T]."""
    rng = np.random.RandomState(seed)
    n_blk = n_pad // C
    vals = rng.choice(np.array([0.3, 0.6, 0.9, 1.2], np.float32),
                      size=(S, n_blk, T, C))
    vals[rng.rand(S, n_blk, T, C) > density] = 0.0
    bits = bf16_bits(vals)
    width = T if U is None else U
    u_ids = None
    if U is not None:
        u_ids = np.stack([np.sort(rng.choice(T, size=U, replace=False))
                          for _ in range(S)]).astype(np.int32)
    rid = rng.randint(0, width, size=(B, S, Q)).astype(np.int32)
    w = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32),
                   size=(B, S, Q))
    W = np.zeros((B, S, width), np.float32)
    bi, si, qi = np.nonzero(w)
    np.add.at(W, (bi, si, rid[bi, si, qi]), w[bi, si, qi])
    return dict(bits=bits, rid=rid, w=w.astype(np.float32), W=W,
                u_ids=u_ids, n_pad=n_pad, C=C, T=T)


def topk_lists_case(seed: int, *, R: int, m: int, n_pad: int = 4096,
                    dup: bool = True) -> dict:
    """Two [R, m] (score desc, doc asc) lists sharing some docs, with ties
    and -inf tails."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in ("a", "b"):
        v = rng.choice(np.array([1.0, 1.5, 2.0, 3.0], np.float32),
                       size=(R, m))
        d = rng.choice(n_pad, size=(R, m)).astype(np.int32)
        if dup and name == "b":
            share = rng.rand(R, m) < 0.4
            d = np.where(share, out["a_docs"], d)
        v[rng.rand(R, m) < 0.2] = -np.inf
        order = np.lexsort((d, -v), axis=-1)
        v = np.take_along_axis(v, order, -1)
        d = np.take_along_axis(d, order, -1)
        # one copy per doc within a list, as a top-k list holds
        for r in range(R):
            _, first = np.unique(d[r], return_index=True)
            keep = np.zeros(m, bool)
            keep[first] = True
            v[r, ~keep] = -np.inf
        d = np.where(v > -np.inf, d, n_pad).astype(np.int32)
        order = np.lexsort((d, -v), axis=-1)
        out[f"{name}_vals"] = np.take_along_axis(v, order, -1)
        out[f"{name}_docs"] = np.take_along_axis(d, order, -1)
    return out


def assert_topk_close(v1, d1, v2, d2, *, rtol: float, atol: float,
                      v_next=None):
    """Two [R, k] top-k lists agree: values within tolerance slot by slot,
    and docs equal wherever the reference's neighbouring values (``v2``,
    and ``v_next`` [R] = its (k+1)-th value) differ by more than the
    tolerance. Slots at -inf carry no doc."""
    v1, v2 = np.asarray(v1, np.float64), np.asarray(v2, np.float64)
    fin1, fin2 = np.isfinite(v1), np.isfinite(v2)
    assert np.array_equal(fin1, fin2), "finite slots differ"
    np.testing.assert_allclose(np.where(fin1, v1, 0), np.where(fin2, v2, 0),
                               rtol=rtol, atol=atol)
    R, k = v2.shape
    nxt = np.full(R, -np.inf) if v_next is None else \
        np.asarray(v_next, np.float64)
    ext = np.concatenate([np.full((R, 1), np.inf), v2, nxt[:, None]], 1)
    tol = atol + rtol * np.abs(v2)
    with np.errstate(invalid="ignore"):
        sep = (np.abs(ext[:, :-2] - v2) > tol) & \
            (np.abs(v2 - ext[:, 2:]) > tol)
    sep &= fin2
    d1, d2 = np.asarray(d1), np.asarray(d2)
    bad = sep & (d1 != d2)
    assert not bad.any(), \
        f"docs differ at separated slots {np.argwhere(bad)[:5]}"


def query_mix(corpus: dict, seed: int, n: int, *, weighted: bool,
              terms: int = 4) -> list:
    """``n`` queries of ``terms`` terms over the terms of df >= 2: drawn in
    proportion to df (``weighted``, the benchmark's traffic) or uniformly
    (tail terms)."""
    rng = np.random.RandomState(seed)
    df = corpus["df"].astype(np.float64)
    el = np.flatnonzero(df >= 2)
    p = df[el] / df[el].sum() if weighted else None
    return [[f"t{t}" for t in rng.choice(el, terms, p=p)] for _ in range(n)]


def knn_tol(q, vecs, similarity: str) -> float:
    """The kNN parity bar's absolute tolerance for one query batch:
    1e-5·‖q‖·max‖v‖ for dot and cosine (unit norms), 1e-5·(‖q‖+max‖v‖)²
    for l2, where the expansion cancels. The scores may differ by that
    much because the dot's sum runs in another order."""
    qn = float(np.linalg.norm(q, axis=1).max())
    if similarity == "cosine":
        qn, vn = 1.0, 1.0
    else:
        vn = float(np.linalg.norm(vecs, axis=-1).max())
    return 1e-5 * (qn + vn) ** 2 if similarity == "l2_norm" else \
        1e-5 * qn * vn


def hit_ids(hits, n_pad: int, k: int) -> np.ndarray:
    """Decoded (shard, doc) hits as global ids ``shard · n_pad + doc``,
    int64[B, k], −1 past a row's last hit."""
    out = np.full((len(hits), k), -1, np.int64)
    for b, row in enumerate(hits):
        for j, (s, d) in enumerate(row):
            out[b, j] = s * n_pad + d
    return out


def fusion_case(seed: int, *, B: int, W: int, S: int = 2,
                n_pad_t: int = 1 << 15, n_pad_k: int = 1 << 14) -> dict:
    """The two ranked lists the hybrid step fuses, per query: a text list
    f32/i32[B, W] of global ids ``s · n_pad_t + doc`` and a kNN list of
    ``s · n_pad_k + row`` (about a third of its docs also in the text
    list), scores descending with equal scores, −inf tails holding the
    fill id, and per-query windows, rank constants and kNN weights."""
    rng = np.random.RandomState(seed)
    n_docs = min(n_pad_t, n_pad_k)
    tv = np.full((B, W), -np.inf, np.float32)
    kv = np.full((B, W), -np.inf, np.float32)
    tg = np.full((B, W), S * n_pad_t, np.int32)
    kg = np.full((B, W), S * n_pad_k, np.int32)
    for b in range(B):
        nt, nk = rng.randint(W // 2, W + 1), rng.randint(W // 2, W + 1)
        key_t = rng.choice(S * n_docs, nt, replace=False)
        pool = rng.choice(S * n_docs, nk, replace=False)
        share = rng.rand(nk) < 0.35
        pool[share] = rng.choice(key_t, share.sum())
        _, first = np.unique(pool, return_index=True)
        key_k = pool[np.sort(first)]
        vt = -np.sort(-rng.choice(np.arange(1, 40, dtype=np.float32) / 4,
                                  nt))
        vk = -np.sort(-rng.choice(np.linspace(-1, 1, 97).astype(np.float32),
                                  key_k.size))
        # (score desc, id asc) as the reduces order them
        s_t, d_t = np.divmod(key_t, n_docs)
        g_t = s_t * n_pad_t + d_t
        o = np.lexsort((g_t, -vt))
        tv[b, :nt], tg[b, :nt] = vt, g_t[o]
        s_k, d_k = np.divmod(key_k, n_docs)
        g_k = s_k * n_pad_k + d_k
        o = np.lexsort((g_k, -vk))
        kv[b, :key_k.size], kg[b, :key_k.size] = vk, g_k[o]
    wt = rng.randint(0, W + 2, B).astype(np.int32)
    wk = rng.randint(0, W + 2, B).astype(np.int32)
    wt[0] = wk[0] = W
    return dict(tv=tv, tg=tg, kv=kv, kg=kg, wt=wt, wk=wk,
                rc=rng.choice(np.array([60.0, 1.0, 0.5], np.float32), B),
                kboost=rng.choice(np.array([1.0, 2.0, 0.3], np.float32), B),
                n_pad_t=n_pad_t, n_pad_k=n_pad_k,
                UP=max(n_pad_t, n_pad_k), pad_id=S * max(n_pad_t, n_pad_k))


def agg_pairs_case(seed, M, V, n_pad, density, docs_kind):
    """An ordinal CSR of M pairs in V runs (zero-length runs included), as
    the aggregation kernels (K12–K15) take it, padded to powers of two as
    the caches pad: offsets repeat their last value, docs carry the
    ``n_pad`` sentinel, values are 0. Docs are drawn from the real docs
    ("perm") or also hold ids in [-n_pad, 0) that wrap and ids past either
    end that gather False ("wild")."""
    rng = np.random.RandomState(seed)
    weights = rng.dirichlet(np.full(V, 0.3))
    weights[rng.rand(V) < 0.2] = 0.0
    weights /= weights.sum()
    lens = rng.multinomial(M, weights)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    docs = rng.randint(0, n_pad, M).astype(np.int32)
    if docs_kind == "wild":
        pick = rng.rand(M)
        docs[pick < 0.2] = -rng.randint(1, n_pad + 1, (pick < 0.2).sum())
        docs[(pick >= 0.2) & (pick < 0.25)] = n_pad + 3
        docs[(pick >= 0.25) & (pick < 0.3)] = -n_pad - 2
    vals = rng.lognormal(3.0, 1.0, M).astype(np.float32)
    vals[rng.rand(M) < 0.1] = 7.25              # duplicate values
    for v in range(V):                           # ascending within a run
        vals[off[v]:off[v + 1]].sort()
    mask = rng.rand(n_pad) < density
    Mp = 1 << max(M - 1, 0).bit_length()

    def pad(a, size, fill):
        out = np.full(size, fill, a.dtype)
        out[:a.shape[0]] = a
        return out

    return dict(off=pad(off, 1 << V.bit_length(), off[-1]),
                docs=pad(docs, Mp, n_pad), vals=pad(vals, Mp, 0.0),
                mask=mask, M=Mp, n_pad=n_pad)


#: a mapping with every field kind the per-segment query path reads
SEGMENT_MAPPING = {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "tags": {"type": "keyword"},
    "price": {"type": "double"},
    "qty": {"type": "long"},
    "ts": {"type": "date"},
    "flag": {"type": "boolean"},
    "addr": {"type": "ip"},
    "vec": {"type": "dense_vector", "dims": 4},
    "span": {"type": "integer_range"},
    "alias_tag": {"type": "alias", "path": "tag"},
    "obj": {"properties": {"a": {"type": "keyword"}, "b": {"type": "long"}}},
    "ck": {"type": "constant_keyword", "value": "x"},
    "comments": {"type": "nested",
                 "properties": {"who": {"type": "keyword"},
                                "text": {"type": "text"}}},
}}

SEGMENT_WORDS = [f"w{i}" for i in range(24)] + ["hello", "world", "the"]
SEGMENT_TAGS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]


def segment_docs(seed: int, n: int, start: int = 0) -> list:
    """``n`` (id, source) documents over :data:`SEGMENT_MAPPING`: short
    bodies from a small vocabulary (so scores tie often), skewed tags,
    prices on a coarse grid, missing fields now and then."""
    rng = np.random.RandomState(seed)
    p_words = 1.0 / np.arange(1, len(SEGMENT_WORDS) + 1)
    p_words /= p_words.sum()
    docs = []
    for i in range(n):
        src = {}
        if rng.rand() < 0.92:
            ln = int(rng.randint(1, 9))
            src["body"] = " ".join(rng.choice(SEGMENT_WORDS, ln, p=p_words))
        if rng.rand() < 0.5:
            src["title"] = " ".join(rng.choice(SEGMENT_WORDS[:6], 2))
        if rng.rand() < 0.85:
            src["tag"] = SEGMENT_TAGS[min(int(rng.zipf(1.5)) - 1, 5)]
        if rng.rand() < 0.4:
            src["tags"] = list(rng.choice(SEGMENT_TAGS, rng.randint(1, 4)))
        if rng.rand() < 0.8:
            src["price"] = float(rng.randint(0, 40)) / 4
        if rng.rand() < 0.7:
            src["qty"] = int(rng.randint(-5, 50))
        if rng.rand() < 0.6:
            src["ts"] = f"2020-0{rng.randint(1, 10)}-1{rng.randint(0, 10)}"
        if rng.rand() < 0.5:
            src["flag"] = bool(rng.rand() < 0.5)
        if rng.rand() < 0.4:
            src["addr"] = f"10.0.{rng.randint(0, 3)}.{rng.randint(0, 256)}"
        if rng.rand() < 0.5:
            src["vec"] = [float(x) for x in rng.randn(4).round(3)]
        if rng.rand() < 0.3:
            lo = int(rng.randint(0, 20))
            src["span"] = {"gte": lo, "lte": lo + int(rng.randint(0, 10))}
        if rng.rand() < 0.3:
            src["obj"] = {"a": SEGMENT_TAGS[rng.randint(0, 6)],
                          "b": int(rng.randint(0, 5))}
        if rng.rand() < 0.3:
            src["ck"] = "x"
        if rng.rand() < 0.2:
            src["comments"] = [
                {"who": SEGMENT_TAGS[rng.randint(0, 6)],
                 "text": " ".join(rng.choice(SEGMENT_WORDS[:8], 2))}
                for _ in range(rng.randint(1, 3))]
        docs.append((str(start + i), src))
    return docs


def build_segments(mapping_cls, builder_cls, seed: int, sizes=(70, 1, 45),
                   deletes=((3, 10, 11), (), (0, 44)), **build_kw):
    """Segments of :func:`segment_docs` built through ``parse_document`` and
    a ``SegmentBuilder`` each (the reference's classes or the port's),
    with deletes: before ``build`` for the first segment, after it for
    the others. Returns (mapper, segments)."""
    svc = mapping_cls(SEGMENT_MAPPING)
    segs = []
    start = 0
    for si, (n, dels) in enumerate(zip(sizes, deletes)):
        b = builder_cls(f"_{si}")
        for seq, (uid, src) in enumerate(segment_docs(seed + si, n, start)):
            b.add(svc.parse_document(uid, src), seq_no=start + seq)
        start += n
        if si == 0:
            b.deleted.update(dels)
        seg = b.build(**build_kw)
        if si:
            for d in dels:
                seg.delete_doc(d)
        segs.append(seg)
    return svc, segs


def csr_case(seed, *, n_pad, Q, L, P_pad, wild):
    """Q postings runs of unique ascending docs (some longer than L, some
    empty, one absent term at start P), flat and padded with n_pad; with
    ``wild`` some postings hold their doc as doc - n_pad (it wraps back, so
    a run still holds each doc once), and some a doc below -n_pad or at or
    after n_pad (dropped)."""
    rng = np.random.RandomState(seed)
    runs, starts, lengths = [], [], []
    pos = 0
    for q in range(Q):
        n = 0 if q % 5 == 4 else int(rng.randint(1, min(2 * L, n_pad)))
        runs.append(np.sort(rng.choice(n_pad, n, replace=False)))
        starts.append(pos)
        lengths.append(n)
        pos += n
    docs = np.full(P_pad, n_pad, np.int32)
    flat = np.concatenate(runs).astype(np.int32)
    assert flat.size <= P_pad
    docs[:flat.size] = flat
    if wild:
        pick = rng.rand(flat.size)
        docs[:flat.size][pick < 0.05] -= n_pad
        docs[:flat.size][(pick >= 0.05) & (pick < 0.07)] = n_pad + 5
        docs[:flat.size][(pick >= 0.07) & (pick < 0.09)] = -n_pad - 3
    starts = np.asarray(starts, np.int32)
    lengths = np.asarray(lengths, np.int32)
    if Q > 1:
        starts[-1] = P_pad                   # an absent term
        lengths[-1] = 0
    tf = rng.randint(1, 7, P_pad).astype(np.float32)
    dl = rng.randint(0, 120, n_pad).astype(np.float32)
    idf = (rng.rand(Q) * 6).astype(np.float32)
    w = rng.choice(np.array([1, 1, 2, 3], np.float32), Q)
    return docs, tf, dl, starts, lengths, idf, w


def pairs_case(seed, n_pad, M, M_pad):
    """M (value, doc) pairs padded to M_pad with doc n_pad; some docs in
    [-n_pad, 0) (they wrap), below it or at/after n_pad (dropped)."""
    rng = np.random.RandomState(seed)
    docs = np.full(M_pad, n_pad, np.int32)
    docs[:M] = rng.randint(0, n_pad, M)
    pick = rng.rand(M)
    docs[:M][pick < 0.05] = -rng.randint(1, n_pad + 1, (pick < 0.05).sum())
    docs[:M][(pick >= 0.05) & (pick < 0.07)] = n_pad + 2
    docs[:M][(pick >= 0.07) & (pick < 0.09)] = -n_pad - 1
    return rng, docs


def topk_scores(seed, n, kind):
    """Scores from a few values (ties) and a 60 % mask; ``nan`` adds NaNs
    of both signs and a payload, signed zeros and infinities, ``masked``
    masks everything, ``distinct`` draws distinct values."""
    rng = np.random.RandomState(seed)
    s = rng.choice(np.array([0.5, 1.0, 1.25, 2.0, 3.5], np.float32), n)
    mask = rng.rand(n) < 0.6
    if kind == "nan":
        s[rng.rand(n) < 0.05] = np.nan
        s[rng.rand(n) < 0.02] = -np.nan
        s[rng.rand(n) < 0.05] = np.float32(-0.0)
        s[rng.rand(n) < 0.05] = np.float32(0.0)
        s[rng.rand(n) < 0.03] = np.inf
        s[rng.rand(n) < 0.03] = -np.inf
        payload = np.asarray([0x7FC00001], np.uint32).view(np.float32)[0]
        s[rng.rand(n) < 0.02] = payload
    elif kind == "masked":
        mask[:] = False
    elif kind == "distinct":
        s = rng.permutation(n).astype(np.float32) / 7
    return s, mask


def assert_same_bits(ref, got):
    """A reference array (jax or numpy) and a port tensor (or array): the
    same dtype, shape and bit patterns (floats compared as integers, so
    NaN payloads and signed zeros count)."""
    r = np.asarray(ref)
    g = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert r.dtype == g.dtype and r.shape == g.shape, (r.dtype, g.dtype,
                                                       r.shape, g.shape)
    if r.dtype.kind == "f":
        as_int = {4: np.int32, 8: np.int64}[r.dtype.itemsize]
        r, g = r.view(as_int), g.view(as_int)
    assert np.array_equal(r, g)



def tree_arrays_case(seed, *, T, N, n, F, missing=0.2):
    """Padded tree node arrays (feats/left/right/dleft i32 [T, N], thresh
    f32 [T, N]) drawn at random, so every index rule of the tree walk
    shows: children past N and below -N, feature indices past F, leaves
    (feat -1); plus pinned trees: a leaf at the root (tree 0), a child
    >= N (1), a negative child (2), a feature >= F (3). X f32 [n, F] with
    ``missing`` of its entries NaN (followed by dleft 0 or 1)."""
    rng = np.random.RandomState(seed)
    feats = rng.randint(-1, F + 2, (T, N)).astype(np.int32)
    thresh = rng.randn(T, N).astype(np.float32)
    left = rng.randint(-2 * N, 2 * N, (T, N)).astype(np.int32)
    right = rng.randint(-2 * N, 2 * N, (T, N)).astype(np.int32)
    dleft = rng.randint(0, 2, (T, N)).astype(np.int32)
    pins = [(0, -1, 1, 2), (1, 0, N + 5, N + 1), (2, 0, -1, -3 * N),
            (3, F + 1, 1, 2)]
    for t, f, lc, rc in pins[:T]:
        feats[t, 0], left[t, 0], right[t, 0] = f, lc, rc
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return dict(X=X, feats=feats, thresh=thresh, left=left, right=right,
                dleft=dleft)


def full_tree_arrays(seed, *, T, depth, F, n, missing=0.1,
                     default_right=0.2):
    """T full binary trees of ``depth`` split levels (2^(depth+1) - 1
    nodes, heap order: children of i at 2i+1, 2i+2) as padded arrays, and
    docs X f32 [n, F] with ``missing`` of the features NaN; a fifth of the
    splits send missing values right. Walk them ``depth + 1`` levels."""
    rng = np.random.RandomState(seed)
    N = 2 ** (depth + 1) - 1
    n_split = 2 ** depth - 1
    i = np.arange(N)
    feats = np.full((T, N), -1, np.int32)
    feats[:, :n_split] = rng.randint(0, F, (T, n_split))
    thresh = np.zeros((T, N), np.float32)
    thresh[:, :n_split] = rng.randn(T, n_split)
    left = np.zeros((T, N), np.int32)
    right = np.zeros((T, N), np.int32)
    left[:, :n_split] = (2 * i + 1)[:n_split]
    right[:, :n_split] = (2 * i + 2)[:n_split]
    dleft = np.zeros((T, N), np.int32)
    dleft[:, :n_split] = rng.rand(T, n_split) >= default_right
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < missing] = np.nan
    return dict(X=X, feats=feats, thresh=thresh, left=left, right=right,
                dleft=dleft)


def outlier_frame(seed, n, f, *, duplicates=0):
    """A standardised-looking frame f32 [n, f]: two Gaussian clusters and
    a few far rows, so the kNN distances are well spread (a near-constant
    spread would amplify rounding through 1/std); ``duplicates`` rows
    repeat earlier ones (zero distances)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[: n // 2] += 3.0
    X[-max(1, n // 50):] *= 6.0
    if duplicates:
        X[-duplicates:] = X[:duplicates]
    return X


def logreg_case(seed, n, f, C, *, bad_labels=False):
    """Features f32 [n, f] with class structure and int labels in [0, C);
    ``bad_labels`` puts a few labels outside it (zero one-hot rows)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, C, n)
    centers = rng.randn(C, f).astype(np.float32) * 2.0
    X = (centers[y] + rng.randn(n, f)).astype(np.float32)
    if bad_labels:
        y[::17] = C + 1
        y[5::23] = -1
    return X, y
