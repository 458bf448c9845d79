"""Fused-query stages (port of ``elasticsearch_tpu/ops/fused_query.py``)
and the wrappers of kernels K5 (``csrc/bisect_exact_scores.cu``), K9
(``csrc/bool_bm25_topk.cu``), K10 (``csrc/fuse_rank.cu``) and K11
(``csrc/rescore_reorder.cu``).

- :func:`bool_bm25_topk` (K9): the sorted-merge BM25 scoring of K1 over a
  lowered bool tree. Each term slot carries its clause's bit; a doc's
  group ORs the bits of every slot holding it, and the doc is a hit iff
  every required clause (must, filter) is present, no prohibited clause
  (must_not) is, and at least ``msm`` should clauses are. Filter and
  must_not slots carry weight 0.0: they set bits and add nothing.
- :func:`bisect_exact_scores` (K5): exact per-candidate scores by a
  search per (candidate, term slot), summed highest slot first, so a
  candidate's score is bitwise the eager step's. The block-max pruned
  step re-scores its survivors with it, the bool and hybrid steps their
  rescore query (the hybrid both its lists in one call). On the card
  each (query, shard) stages its slots' pivots in shared memory.
- :func:`fuse_rank` (K10): the hybrid step's fusion of a text and a kNN
  ranking in one id space, by reciprocal rank (``rrf_fuse_body``) or a
  linear sum (``sum_fuse_body``), first list first, the first occurrence
  of an id winning, ordered (score desc, id asc); with the rescore
  payload it also gathers each list's rescore scores in the fused order.
  On the card a query of at most ``K10_COUNT_MAX`` entries is ranked by
  counting, a longer one sorted.
- :func:`rescore_reorder` (K11): the rescore window re-sorted by the
  combined score (``rescore_combine``, five modes), ahead of the tail in
  its old order. On the card a query of at most ``K11_COUNT_MAX`` entries
  is ranked by counting, a longer one sorted.

Arithmetic follows what XLA:CPU compiles for the reference: it contracts
the rescore's ``qw·primary + rw·secondary`` into ``fma(rw, secondary,
qw·primary)`` (the product that also feeds the window's fallback stays
rounded), so the plain versions form that FMA exactly and K11 calls
``__fmaf_rn``; RRF's ``1 / ((rc + rank) + 1)`` is two f32 adds and an
IEEE division.

Tie order. Every ranking is (score desc, id asc); entries at −inf are
ordered (id asc, position asc) where the reference leaves them in an
unspecified order, so the plain versions and the kernels agree on every
slot, the selection ``sel`` of −inf slots included.
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels import build as _kb
from .blockmax import fma_f32
from .sorted_merge import (SPARSE_TILE_SHIFT, TILE_BLOCKS_PER_SM,
                           TILE_EDGES_MAX, TILE_MERGE_MAX, TILE_SHIFT,
                           _select_topk, merge_runs, run_bits, slice_runs,
                           sm_count, tile_plan)

NEG_INF = float("-inf")

#: clause-count ceiling of a lowered bool tree: the should-clause count
#: reads the low ``MAX_BOOL_CLAUSES`` bits of a doc's clause mask
MAX_BOOL_CLAUSES = 8

#: K9's doc tiles and plan sizes: those of the doc-tile kernels
#: (``sorted_merge``), named here so a measurement can change K9's alone
BOOL_TILE_SHIFT = TILE_SHIFT
BOOL_SPARSE_TILE_SHIFT = SPARSE_TILE_SHIFT
BOOL_BLOCKS_PER_SM = TILE_BLOCKS_PER_SM
BOOL_MERGE_MAX = TILE_MERGE_MAX
BOOL_EDGES_MAX = TILE_EDGES_MAX

#: K10 ranks a query of at most this many entries (both lists) by
#: counting (n² compares, no sort, no workspace); longer ones take its
#: sorting path (``csrc/fuse_rank.cu``)
K10_COUNT_MAX = 512

#: K11 ranks a query of at most this many entries by counting (the window
#: by key counts, the tail and the −inf entries by a prefix count; no
#: sort, no workspace); longer ones take its sorting path
#: (``csrc/rescore_reorder.cu``)
K11_COUNT_MAX = 512

#: rescore score modes in K11's numbering
RESCORE_MODES = ("total", "multiply", "avg", "max", "min")
#: fusion methods and kNN similarities in K10's numbering
FUSIONS = ("rrf", "sum")
_SIM_CODE = {"cosine": 0, "cos": 0, "dot_product": 0,
             "max_inner_product": 1, "l2_norm": 2}


def bisect_exact_scores_plain(postings_docs, postings_impact, starts,
                              lengths, idfw, cand_docs, *, n_pad: int,
                              cand_docs2=None, cand_vals2=None):
    """Plain version of K5 (see :func:`bisect_exact_scores`): the
    reference's fixed-trip vectorised bisect, once for each list."""
    if cand_docs2 is not None:
        if cand_vals2 is not None:
            cand_docs2 = torch.where(cand_vals2 > NEG_INF, cand_docs2,
                                     torch.full_like(cand_docs2, n_pad))
        return (*bisect_exact_scores_plain(
                    postings_docs, postings_impact, starts, lengths, idfw,
                    cand_docs, n_pad=n_pad),
                *bisect_exact_scores_plain(
                    postings_docs, postings_impact, starts, lengths, idfw,
                    cand_docs2, n_pad=n_pad))
    B, S, Q = starts.shape
    R = cand_docs.shape[2]
    P = postings_docs.shape[1]
    dev = postings_docs.device
    flat_d = postings_docs.reshape(-1)
    flat_i = postings_impact.reshape(-1)
    base = (torch.arange(S, device=dev) * P)[None, :, None, None]
    lo = starts.long()[:, :, None, :].expand(B, S, R, Q)
    end = lo + lengths.long()[:, :, None, :]
    hi = end
    doc = cand_docs.long()[..., None]

    def at(table, pos):
        return table[base + pos.clamp(0, P - 1)]

    for _ in range(max(int(math.ceil(math.log2(P + 1))) + 1, 1)):
        cont = lo < hi
        mid = (lo + hi) // 2
        go = at(flat_d, mid).long() < doc
        lo = torch.where(cont & go, mid + 1, lo)
        hi = torch.where(cont & ~go, mid, hi)
    found = (lo < end) & (at(flat_d, lo).long() == doc)
    c = torch.where(found, idfw[:, None, None, :] * at(flat_i, lo),
                    torch.zeros((), dtype=torch.float32, device=dev))
    score = c[..., Q - 1]
    for q in range(Q - 2, -1, -1):
        score = score + c[..., q]
    live = cand_docs < n_pad
    return (torch.where(live, score, torch.zeros_like(score)),
            found.any(-1) & live)


def bisect_exact_scores(postings_docs, postings_impact, starts, lengths,
                        idfw, cand_docs, *, n_pad: int, cand_docs2=None,
                        cand_vals2=None):
    """Exact f32 scores of candidates against each query's term runs (K5).

    postings_docs i32[S, P] / postings_impact f32[S, P]: the sparse table;
    starts / lengths i32[B, S, Q]: every slot's whole run (its docs in
    non-decreasing order); idfw f32[B, Q]; cand_docs i32[B, S, R]:
    shard-local docs, ``n_pad`` on empty slots. A second list,
    ``cand_docs2`` i32[B, S, R2] with its ranking's ``cand_vals2`` f32[B,
    S, R2] (an entry at −inf is empty; None: none is), is scored in the
    same launch.

    Returns (scores f32[B, S, R], found_any bool[B, S, R]), and the second
    list's two after them when it is given: a slot holding the candidate
    adds ``idfw · impact``, summed from the highest slot down; empty slots
    score 0 and are not found.

    A CPU tensor runs the plain version; a CUDA tensor launches K5.
    """
    dev = postings_docs.device
    if dev.type == "cpu":
        return bisect_exact_scores_plain(postings_docs, postings_impact,
                                         starts, lengths, idfw, cand_docs,
                                         n_pad=n_pad, cand_docs2=cand_docs2,
                                         cand_vals2=cand_vals2)
    if dev.type != "cuda":
        raise ValueError(f"bisect_exact_scores: unsupported device {dev}")
    S, P = postings_docs.shape
    B, _, Q = starts.shape
    R = cand_docs.shape[2]
    _kb.check(postings_docs, "postings_docs", torch.int32, (S, P), dev)
    _kb.check(postings_impact, "postings_impact", torch.float32, (S, P), dev)
    _kb.check(starts, "starts", torch.int32, (B, S, Q), dev)
    _kb.check(lengths, "lengths", torch.int32, (B, S, Q), dev)
    _kb.check(idfw, "idfw", torch.float32, (B, Q), dev)
    _kb.check(cand_docs, "cand_docs", torch.int32, (B, S, R), dev)
    two = cand_docs2 is not None
    R2 = cand_docs2.shape[2] if two else 0
    if two:
        _kb.check(cand_docs2, "cand_docs2", torch.int32, (B, S, R2), dev)
        if cand_vals2 is not None:
            _kb.check(cand_vals2, "cand_vals2", torch.float32, (B, S, R2),
                      dev)
    score = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    found = torch.empty((B, S, R), dtype=torch.bool, device=dev)
    out = (score, found)
    if two:
        out += (torch.empty((B, S, R2), dtype=torch.float32, device=dev),
                torch.empty((B, S, R2), dtype=torch.bool, device=dev))
    if B * S * (R + R2) == 0:
        return out
    _kb.launch("bisect_exact_scores", dev, postings_docs.data_ptr(),
               postings_impact.data_ptr(), P, starts.data_ptr(),
               lengths.data_ptr(), idfw.data_ptr(), cand_docs.data_ptr(), R,
               cand_docs2.data_ptr() if two else None,
               cand_vals2.data_ptr() if two and cand_vals2 is not None
               else None, R2, B, S, Q, n_pad, score.data_ptr(),
               found.data_ptr(),
               out[2].data_ptr() if two else None,
               out[3].data_ptr() if two else None)
    return out


# ---------------------------------------------------------------------------
# K9: bool-tree BM25 (table row 10)
# ---------------------------------------------------------------------------


def bool_bm25_topk_plan(n_pad: int, B: int, S: int, Q: int, L: int,
                        k: int, n_sm: int) -> dict:
    """K9's launch shape: :func:`~.sorted_merge.tile_plan` at the
    ``BOOL_*`` sizes."""
    return tile_plan(n_pad, B, S, Q, L, k, n_sm, shift=BOOL_TILE_SHIFT,
                     sparse_shift=BOOL_SPARSE_TILE_SHIFT,
                     blocks_per_sm=BOOL_BLOCKS_PER_SM,
                     merge_max=BOOL_MERGE_MAX, edges_max=BOOL_EDGES_MAX)


def bool_bm25_topk_plain(postings_docs, postings_impact, starts, lengths,
                         idfw, cbits, req, neg, shd, msm, *, n_pad: int,
                         L: int, k: int, nc: int = MAX_BOOL_CLAUSES):
    """Plain version of K9 (see :func:`bool_bm25_topk`): the reference's
    ``bool_bm25_topk_body`` for each (query, shard)."""
    B, S, Q = starts.shape
    low = (1 << nc) - 1
    vals_out, docs_out, count_out = [], [], []
    for s in range(S):
        docs, contrib = slice_runs(postings_docs[s], postings_impact[s],
                                   starts[:, s], lengths[:, s], idfw,
                                   n_pad=n_pad, L=L)
        sdocs, gscore, _gcount, is_last, gbits = merge_runs(
            docs, contrib, n_pad=n_pad,
            bits=run_bits(cbits, lengths[:, s], L))
        sb = gbits & (shd[:, None] & low)
        should_hits = torch.zeros_like(gbits)
        for ci in range(nc):
            should_hits = should_hits + ((sb >> ci) & 1)
        eligible = ((gbits & req[:, None]) == req[:, None]) \
            & ((gbits & neg[:, None]) == 0) & (should_hits >= msm[:, None])
        matched = is_last & (sdocs < n_pad) & eligible
        score = torch.where(matched, gscore, NEG_INF)
        v, d = _select_topk(sdocs, score, k=k, n_pad=n_pad)
        vals_out.append(v)
        docs_out.append(d)
        count_out.append(matched.sum(1).to(torch.int32))
    return (torch.stack(vals_out, 1), torch.stack(docs_out, 1),
            torch.stack(count_out, 1))


def bool_bm25_topk(postings_docs, postings_impact, starts, lengths, idfw,
                   cbits, req, neg, shd, msm, *, n_pad: int, L: int, k: int,
                   nc: int = MAX_BOOL_CLAUSES):
    """Bool-tree scoring + top-k for a batch over S shards (K9).

    postings_docs i32[S, P] / postings_impact f32[S, P]: the sparse
    tables; starts / lengths i32[B, S, Q]: one slot per (clause, term);
    idfw f32[B, Q] (0.0 on filter and must_not slots); cbits i32[B, Q]:
    each slot's clause bit ``1 << clause``; req / neg / shd / msm i32[B]:
    the required, prohibited and should clause masks and the minimum
    number of should clauses. ``nc``: the should count reads the low
    ``nc`` bits.

    Returns (vals f32[B, S, k], docs i32[B, S, k], count i32[B, S]): a
    doc whose only matches are filter clauses is a hit at 0.0; empty slots
    hold (−inf, ``n_pad``); count is the number of eligible docs. Each
    run's valid prefix must hold docs in strictly ascending order, as the
    plane's postings do.

    A CPU tensor runs the plain version; a CUDA tensor launches K9 (over
    the doc tiles of :func:`bool_bm25_topk_plan`, its G lists a (query,
    shard) merged in the same launch call).
    """
    dev = postings_docs.device
    if dev.type == "cpu":
        return bool_bm25_topk_plain(postings_docs, postings_impact, starts,
                                    lengths, idfw, cbits, req, neg, shd,
                                    msm, n_pad=n_pad, L=L, k=k, nc=nc)
    if dev.type != "cuda":
        raise ValueError(f"bool_bm25_topk: unsupported device {dev}")
    S, P = postings_docs.shape
    B, _, Q = starts.shape
    _kb.check(postings_docs, "postings_docs", torch.int32, (S, P), dev)
    _kb.check(postings_impact, "postings_impact", torch.float32, (S, P), dev)
    _kb.check(starts, "starts", torch.int32, (B, S, Q), dev)
    _kb.check(lengths, "lengths", torch.int32, (B, S, Q), dev)
    _kb.check(idfw, "idfw", torch.float32, (B, Q), dev)
    _kb.check(cbits, "cbits", torch.int32, (B, Q), dev)
    for name, t in (("req", req), ("neg", neg), ("shd", shd), ("msm", msm)):
        _kb.check(t, name, torch.int32, (B,), dev)
    if L > P:
        raise ValueError(f"bool_bm25_topk: L={L} > table {P}")
    vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    docs = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    count = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B * S == 0:
        return vals, docs, count
    plan = bool_bm25_topk_plan(n_pad, B, S, Q, L, k, sm_count(dev))
    G = plan["G"]
    # the G lists and counts of each (query, shard), merged by the launch
    part = torch.empty(B * S * G * (2 * k + 1) if G > 1 else 1,
                       dtype=torch.int32, device=dev)
    n_part = B * S * G * k
    _kb.launch("bool_bm25_topk", dev, postings_docs.data_ptr(),
               postings_impact.data_ptr(), P, starts.data_ptr(),
               lengths.data_ptr(), idfw.data_ptr(), cbits.data_ptr(),
               req.data_ptr(), neg.data_ptr(), shd.data_ptr(),
               msm.data_ptr(), B, S, Q, L, n_pad, k, nc, plan["tile_shift"],
               plan["tiles_per_block"], plan["edge_tiles"], G,
               part.data_ptr(),
               part.data_ptr() + 4 * n_part,
               part.data_ptr() + 8 * n_part, vals.data_ptr(),
               docs.data_ptr(), count.data_ptr())
    return vals, docs, count


# ---------------------------------------------------------------------------
# K10: rank fusion (table row 11)
# ---------------------------------------------------------------------------


def knn_raw_to_score(similarity: str, raw):
    """The plane's raw similarity → ES ``_score`` (the plane's l2 raw is
    ``−‖q−v‖²``, clamped at 0 for float cancellation)."""
    if similarity in ("cosine", "cos", "dot_product"):
        return (1.0 + raw) / 2.0
    if similarity == "max_inner_product":
        return torch.where(raw < 0, 1.0 / (1.0 - raw), raw + 1.0)
    return 1.0 / (1.0 + torch.clamp(-raw, min=0.0))


def _list_lookup(ids, list_ids, list_valid):
    """Where each of ``ids`` [B, n] sits in a ranked list [B, m] that holds
    an id at most once among its valid entries: (present bool[B, n],
    position i64[B, n]). A sort and a binary search, not the reference's
    n × m compare."""
    m = list_ids.shape[-1]
    key = torch.where(list_valid, list_ids.long(),
                      torch.full_like(list_ids, 1 << 40, dtype=torch.int64))
    sk, order = torch.sort(key, dim=-1, stable=True)
    ids = ids.long()
    p = torch.searchsorted(sk, ids).clamp(max=m - 1)
    present = torch.gather(sk, -1, p) == ids
    return present, torch.gather(order, -1, p)


def _dedupe_first(ids, pad_id: int):
    """True for entries that are a later duplicate of an earlier id (first
    occurrence wins), pads excluded."""
    sid, order = torch.sort(ids, dim=-1, stable=True)
    later = torch.zeros_like(sid, dtype=torch.bool)
    later[..., 1:] = sid[..., 1:] == sid[..., :-1]
    dup = torch.zeros_like(later).scatter(-1, order, later)
    return dup & (ids != pad_id)


def _rank_contrib(ids, list_ids, list_valid, rc):
    """Each id's RRF contribution from one ranked list: ``1 / ((rc +
    rank) + 1)`` where the id sits in the list, else 0. rc f32[B]."""
    m = list_ids.shape[-1]
    w = 1.0 / (rc[..., None] + torch.arange(m, dtype=torch.float32,
                                            device=ids.device) + 1.0)
    present, pos = _list_lookup(ids, list_ids, list_valid)
    return torch.where(present, torch.gather(w, -1, pos),
                       torch.zeros((), device=ids.device))


def _fused_topk(score, ids, k: int, pad_id: int):
    """(score desc, id asc, position asc) selection: (vals f32[B, k], ids
    i32[B, k], sel i32[B, k]); −inf slots carry ``pad_id``, slots past the
    candidates (−inf, ``pad_id``, 0)."""
    n = score.shape[-1]
    o1 = torch.sort(ids, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(score, -1, o1), dim=-1, descending=True,
                    stable=True).indices
    sel = torch.gather(o1, -1, o2)[..., :min(k, n)]
    vals = torch.gather(score, -1, sel)
    out_ids = torch.where(vals > NEG_INF, torch.gather(ids, -1, sel),
                          torch.full_like(sel, pad_id)).to(torch.int32)
    sel = sel.to(torch.int32)
    if n < k:
        pad = score.shape[:-1] + (k - n,)
        vals = torch.cat([vals, vals.new_full(pad, NEG_INF)], -1)
        out_ids = torch.cat([out_ids, out_ids.new_full(pad, pad_id)], -1)
        sel = torch.cat([sel, sel.new_zeros(pad)], -1)
    return vals, out_ids, sel


def rrf_fuse_body(ids_a, ids_b, rc, *, k: int, pad_id: int):
    """Reciprocal-rank fusion of two ranked id lists [B, na], [B, nb]
    (``pad_id`` on empty slots), rc f32[B]: list a's contribution plus
    list b's, a later duplicate dropped. Returns (vals, ids, sel) as
    :func:`_fused_topk`; ``sel`` indexes ``concat(a, b)``."""
    cat = torch.cat([ids_a, ids_b], -1)
    score = _rank_contrib(cat, ids_a, ids_a != pad_id, rc) + \
        _rank_contrib(cat, ids_b, ids_b != pad_id, rc)
    live = (cat != pad_id) & ~_dedupe_first(cat, pad_id)
    score = torch.where(live, score, NEG_INF)
    return _fused_topk(score, cat, k, pad_id)


def sum_fuse_body(ids_a, vals_a, ids_b, vals_b, *, k: int, pad_id: int):
    """Linear fusion: an id in both lists sums its two scores (list a's
    first); an id in one list keeps that list's score. Same return
    convention as :func:`rrf_fuse_body`."""
    cat = torch.cat([ids_a, ids_b], -1)
    zero = torch.zeros((), device=cat.device)
    in_a, pa = _list_lookup(cat, ids_a, ids_a != pad_id)
    in_b, pb = _list_lookup(cat, ids_b, ids_b != pad_id)
    score = torch.where(in_a, torch.gather(vals_a, -1, pa), zero) + \
        torch.where(in_b, torch.gather(vals_b, -1, pb), zero)
    live = (cat != pad_id) & ~_dedupe_first(cat, pad_id)
    score = torch.where(live, score, NEG_INF)
    return _fused_topk(score, cat, k, pad_id)


def fuse_rank_plain(tv, tg, kv, kg, wt, wk, rc, kboost, *, n_pad_t: int,
                    n_pad_k: int, UP: int, pad_id: int, fusion: str,
                    similarity: str, k: int, tsec=None, tfnd=None,
                    ksec=None, kfnd=None):
    """Plain version of K10 (see :func:`fuse_rank`): the reference's
    ``finish`` before its rescore, and its payload gather."""
    out = _fuse_rank_plain(tv, tg, kv, kg, wt, wk, rc, kboost,
                           n_pad_t=n_pad_t, n_pad_k=n_pad_k, UP=UP,
                           pad_id=pad_id, fusion=fusion,
                           similarity=similarity, k=k)
    if tsec is None:
        return out
    sel = out[2].long()
    return (*out, torch.gather(torch.cat([tsec, ksec], 1), 1, sel),
            torch.gather(torch.cat([tfnd, kfnd], 1), 1, sel))


def _fuse_rank_plain(tv, tg, kv, kg, wt, wk, rc, kboost, *, n_pad_t: int,
                     n_pad_k: int, UP: int, pad_id: int, fusion: str,
                     similarity: str, k: int):
    pos_t = torch.arange(tv.shape[-1], device=tv.device)
    pos_k = torch.arange(kv.shape[-1], device=kv.device)
    t_ok = (tv > NEG_INF) & (pos_t < wt[:, None])
    k_ok = (kv > NEG_INF) & (pos_k < wk[:, None])
    tg, kg = tg.long(), kg.long()
    tug = torch.where(t_ok, (tg // n_pad_t) * UP + tg % n_pad_t,
                      torch.full_like(tg, pad_id))
    kug = torch.where(k_ok, (kg // n_pad_k) * UP + kg % n_pad_k,
                      torch.full_like(kg, pad_id))
    if fusion == "rrf":
        return rrf_fuse_body(tug, kug, rc, k=k, pad_id=pad_id)
    if fusion != "sum":
        raise ValueError(f"unknown fusion [{fusion}]")
    ks = torch.where(k_ok, knn_raw_to_score(similarity, kv) * kboost[:, None],
                     NEG_INF)
    ts = torch.where(t_ok, tv, NEG_INF)
    return sum_fuse_body(tug, ts, kug, ks, k=k, pad_id=pad_id)


@functools.lru_cache(maxsize=256)
def _fuse_rank_workspace_bytes(n: int, B: int) -> int:
    """K10's sorting-path workspace for B queries of n entries, as its C
    entry sizes it (0 where a query's keys fit a block's shared memory),
    asked once a shape."""
    return _kb.query("fuse_rank", "es_fuse_rank_workspace_bytes", n, B)


def fuse_rank(tv, tg, kv, kg, wt, wk, rc, kboost, *, n_pad_t: int,
              n_pad_k: int, UP: int, pad_id: int, fusion: str,
              similarity: str, k: int, tsec=None, tfnd=None, ksec=None,
              kfnd=None):
    """Fusion of a text and a kNN ranking (K10).

    tv f32[B, na] / tg i32[B, na]: the text ranking (ids ``s · n_pad_t +
    doc``); kv f32[B, nb] / kg i32[B, nb]: the kNN ranking of raw
    similarities (ids ``s · n_pad_k + row``); wt / wk i32[B]: each query's
    rank windows (entries at or past them leave the fusion); rc f32[B]:
    the RRF rank constant; kboost f32[B]: the kNN weight of ``"sum"``.
    Ids unify to ``s · UP + doc``. ``fusion``: ``"rrf"`` (``1 / ((rc +
    rank) + 1)`` per list) or ``"sum"`` (text score + ``knn_raw_to_score
    · kboost``), list a first; a later duplicate drops out. The rescore
    payload, all four or none: ``tsec`` f32 / ``tfnd`` bool [B, na] and
    ``ksec`` / ``kfnd`` [B, nb], each list entry's rescore score and
    match.

    Returns (vals f32[B, k], ids i32[B, k], sel i32[B, k]) ordered (score
    desc, id asc); ``sel`` indexes ``concat(text, knn)``; −inf slots hold
    ``pad_id``. With the payload also (sec f32[B, k], fnd bool[B, k]), the
    payload of ``concat(text, knn)`` at ``sel``.

    A CPU tensor runs the plain version; a CUDA tensor launches K10 (by
    counting up to ``K10_COUNT_MAX`` entries, else by its sorts).
    """
    dev = tv.device
    if dev.type == "cpu":
        return fuse_rank_plain(tv, tg, kv, kg, wt, wk, rc, kboost,
                               n_pad_t=n_pad_t, n_pad_k=n_pad_k, UP=UP,
                               pad_id=pad_id, fusion=fusion,
                               similarity=similarity, k=k, tsec=tsec,
                               tfnd=tfnd, ksec=ksec, kfnd=kfnd)
    if dev.type != "cuda":
        raise ValueError(f"fuse_rank: unsupported device {dev}")
    if fusion not in FUSIONS:
        raise ValueError(f"unknown fusion [{fusion}]")
    B, na = tv.shape
    nb = kv.shape[1]
    _kb.check(tv, "tv", torch.float32, (B, na), dev)
    _kb.check(tg, "tg", torch.int32, (B, na), dev)
    _kb.check(kv, "kv", torch.float32, (B, nb), dev)
    _kb.check(kg, "kg", torch.int32, (B, nb), dev)
    for name, t, dt in (("wt", wt, torch.int32), ("wk", wk, torch.int32),
                        ("rc", rc, torch.float32),
                        ("kboost", kboost, torch.float32)):
        _kb.check(t, name, dt, (B,), dev)
    payload = (tsec, tfnd, ksec, kfnd)
    with_payload = tsec is not None
    if any((x is None) == with_payload for x in payload):
        raise ValueError("fuse_rank: give all of tsec, tfnd, ksec, kfnd "
                         "or none")
    if with_payload:
        for name, t, dt, m in (("tsec", tsec, torch.float32, na),
                               ("tfnd", tfnd, torch.bool, na),
                               ("ksec", ksec, torch.float32, nb),
                               ("kfnd", kfnd, torch.bool, nb)):
            _kb.check(t, name, dt, (B, m), dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    sel = torch.empty((B, k), dtype=torch.int32, device=dev)
    out = (vals, ids, sel)
    if with_payload:
        out += (torch.empty((B, k), dtype=torch.float32, device=dev),
                torch.empty((B, k), dtype=torch.bool, device=dev))
    if B == 0 or k == 0:
        return out
    ws_bytes = 0 if na + nb <= K10_COUNT_MAX else \
        _fuse_rank_workspace_bytes(na + nb, B)
    ws = torch.empty(ws_bytes // 4, dtype=torch.int32,
                     device=dev) if ws_bytes else None
    pl = [t.data_ptr() if with_payload else None for t in payload]
    _kb.launch("fuse_rank", dev, tv.data_ptr(), tg.data_ptr(), na,
               kv.data_ptr(), kg.data_ptr(), nb, wt.data_ptr(),
               wk.data_ptr(), rc.data_ptr(), kboost.data_ptr(), *pl, B,
               n_pad_t, n_pad_k, UP, pad_id, FUSIONS.index(fusion),
               _SIM_CODE[similarity], k,
               vals.data_ptr(), ids.data_ptr(), sel.data_ptr(),
               out[3].data_ptr() if with_payload else None,
               out[4].data_ptr() if with_payload else None,
               None if ws is None else ws.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K11: the rescore window's reorder (table row 11)
# ---------------------------------------------------------------------------


def rescore_combine(mode: str, primary, secondary, matched, in_window, qw,
                    rw):
    """The rescore window's combine (``QueryRescorer``'s five score
    modes), rows [B, n] with qw / rw f32[B]: in-window docs the rescore
    query matched combine per ``mode``; every other doc keeps
    ``qw·primary``."""
    if mode not in RESCORE_MODES:
        raise ValueError(f"illegal rescore score_mode [{mode}]")
    qw, rw = qw[:, None], rw[:, None]
    ps = qw * primary
    if mode in ("total", "avg"):
        ns = fma_f32(rw.expand_as(secondary), secondary, ps)
        if mode == "avg":
            ns = ns / 2.0
    else:
        rs = rw * secondary
        ns = ps * rs if mode == "multiply" else \
            torch.maximum(ps, rs) if mode == "max" else torch.minimum(ps, rs)
    return torch.where(in_window & matched, ns, ps)


def rescore_reorder_body(vals, ids, secondary, matched, qw, rw, window, *,
                         mode: str, k: int, pad_id: int):
    """Plain version of K11 (see :func:`rescore_reorder`): the entries of
    the window re-sorted by (combined score desc, id asc), then the tail in
    its old order, then the entries at −inf."""
    n = vals.shape[-1]
    pos = torch.arange(n, device=vals.device)
    live = vals > NEG_INF
    in_window = live & (pos < window[:, None])
    ns = rescore_combine(mode, vals, secondary, matched, in_window, qw, rw)
    ns = torch.where(live, ns, NEG_INF)
    region = torch.where(live, torch.where(in_window, 0, 1), 2)
    k2 = torch.where(in_window, -ns, pos.to(torch.float32))
    k3 = torch.where(in_window, ids, 0)
    # lexicographic (region, k2, k3, position): stable sorts, last key first
    o = torch.sort(k3, dim=-1, stable=True).indices
    o = torch.gather(o, -1, torch.sort(torch.gather(k2, -1, o), dim=-1,
                                       stable=True).indices)
    o = torch.gather(o, -1, torch.sort(torch.gather(region, -1, o), dim=-1,
                                       stable=True).indices)
    sel = o[..., :min(k, n)]
    out_v = torch.gather(ns, -1, sel)
    out_i = torch.where(out_v > NEG_INF, torch.gather(ids, -1, sel),
                        torch.full_like(sel, pad_id)).to(torch.int32)
    if n < k:
        pad = vals.shape[:-1] + (k - n,)
        out_v = torch.cat([out_v, out_v.new_full(pad, NEG_INF)], -1)
        out_i = torch.cat([out_i, out_i.new_full(pad, pad_id)], -1)
    return out_v, out_i


@functools.lru_cache(maxsize=256)
def _rescore_reorder_workspace_bytes(n: int, B: int) -> int:
    """K11's workspace for B queries of n entries, asked of its C entry
    once a shape (0 on the counting path, and when a query's sort keys fit
    shared memory)."""
    return _kb.query("rescore_reorder", "es_rescore_reorder_workspace_bytes",
                     n, B)


def rescore_reorder(vals, ids, secondary, matched, qw, rw, window, *,
                    mode: str, k: int, pad_id: int):
    """The rescore stage (K11): reorder each query's window of an already
    ranked list by the combined score; the rest keeps its order.

    vals f32[B, n] / ids i32[B, n]: the ranking (score desc, −inf padded);
    secondary f32[B, n] / matched bool[B, n]: the rescore query's score
    and match of each entry; qw / rw f32[B]: the query and rescore
    weights; window i32[B]: each query's window (a runtime value).
    ``mode``: one of ``RESCORE_MODES``.

    Returns (vals f32[B, k], ids i32[B, k]): the window's entries by
    (combined score desc, id asc), then the tail's at ``qw · score`` in
    their order, then −inf slots holding ``pad_id``.

    A CPU tensor runs the plain version; a CUDA tensor launches K11 (by
    counting up to ``K11_COUNT_MAX`` entries, else by its sort).
    """
    dev = vals.device
    if dev.type == "cpu":
        return rescore_reorder_body(vals, ids, secondary, matched, qw, rw,
                                    window, mode=mode, k=k, pad_id=pad_id)
    if dev.type != "cuda":
        raise ValueError(f"rescore_reorder: unsupported device {dev}")
    if mode not in RESCORE_MODES:
        raise ValueError(f"illegal rescore score_mode [{mode}]")
    B, n = vals.shape
    _kb.check(vals, "vals", torch.float32, (B, n), dev)
    _kb.check(ids, "ids", torch.int32, (B, n), dev)
    _kb.check(secondary, "secondary", torch.float32, (B, n), dev)
    _kb.check(matched, "matched", torch.bool, (B, n), dev)
    for name, t, dt in (("qw", qw, torch.float32), ("rw", rw, torch.float32),
                        ("window", window, torch.int32)):
        _kb.check(t, name, dt, (B,), dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return out_v, out_i
    ws_bytes = _rescore_reorder_workspace_bytes(n, B)
    ws = torch.empty(ws_bytes // 4, dtype=torch.int32,
                     device=dev) if ws_bytes else None
    _kb.launch("rescore_reorder", dev, vals.data_ptr(), ids.data_ptr(),
               secondary.data_ptr(), matched.data_ptr(), qw.data_ptr(),
               rw.data_ptr(), window.data_ptr(), B, n,
               RESCORE_MODES.index(mode), k, pad_id, out_v.data_ptr(),
               out_i.data_ptr(), None if ws is None else ws.data_ptr())
    return out_v, out_i
