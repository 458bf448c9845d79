"""Sorted-merge BM25 candidate scoring (port of
``elasticsearch_tpu/ops/sorted_merge.py``) and the wrapper of kernel K1
(``csrc/sparse_candidates_topk.cu``).

A query's Q postings runs (doc ids + precomputed impacts) form Q·L
candidates; a doc matched by several terms sums its contributions, and the
top-k over the candidates is exact because every matching doc sits in some
run. The reference merges the runs with a stable pairwise network and sums
each doc group with Q-1 shifted adds, which places the group total at the
posting of the highest slot holding the doc and sums in descending slot
order. The plain version here gets the same doc order from one stable sort
of the slot-major [Q·L] sequence and then repeats the shifted adds, so its
scores are bitwise the reference's.

Table padding contract (as in the reference): the postings tables are
padded with sentinel ``doc = n_pad`` entries to at least ``max(starts) +
L``; a start is clamped to ``P - L`` as ``dynamic_slice`` clamps it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..kernels import build as _kb
from .topk import topk_stable

NEG_INF = float("-inf")

#: the doc-tile kernels (K1 here, K9 in ``fused_query``): 2^11 docs a
#: shared-memory tile, 2^12 where a (query, shard)'s slots hold at most one
#: posting a doc (Q·L <= n_pad): there a tile's fixed costs (its slots'
#: barriers, its eligibility pass) outweigh its postings (PERF.md's K9
#: finding: the tile sizes measured at bool mix (c) and the hybrid on an
#: H100)
TILE_SHIFT = 11
SPARSE_TILE_SHIFT = 12
#: blocks a tile launch aims at per SM: about twice what an SM holds at
#: once (4 of the tile kernel's blocks at 2,048-doc tiles), so the grid
#: fills the card twice over
TILE_BLOCKS_PER_SM = 8
#: cap on G·k, the entries the merge kernel reads a (query, shard)
TILE_MERGE_MAX = 4096
#: cap on Q·(edge_tiles + 1), a block's table of slot positions
TILE_EDGES_MAX = 4096


def make_impacts(tf: np.ndarray, docs: np.ndarray, doc_len: np.ndarray,
                 avgdl: float, k1: float, b: float) -> np.ndarray:
    """Per-posting query-independent BM25 impact (host-side, at build)."""
    dl = doc_len[docs]
    return ((k1 + 1.0) * tf / (tf + k1 * (1.0 - b + b * dl / avgdl))
            ).astype(np.float32)


def slice_runs(postings_docs, postings_impact, starts, lengths, idfw, *,
               n_pad: int, L: int):
    """[..., Q, L] tiles of each slot's run: doc ids (``n_pad`` past the
    run's length) and contributions ``impact · idfw`` (0 there)."""
    P = postings_docs.shape[-1]
    st = starts.long().clamp(0, P - L)
    pos = torch.arange(L, device=postings_docs.device)
    idx = st[..., None] + pos
    docs = postings_docs[idx]
    imps = postings_impact[idx]
    valid = pos < lengths.long()[..., None]
    docs = torch.where(valid, docs, torch.full_like(docs, n_pad))
    contrib = torch.where(valid, imps * idfw[..., None],
                          torch.zeros_like(imps))
    return docs, contrib


def merge_runs(docs, contrib, *, n_pad: int, bits=None):
    """Merge [R, Q, L] run tiles into doc-ascending [R, Q·L] candidates.

    Returns ``(sdocs, gscore, gcount, is_last)`` as the reference's
    ``bm25_merge_candidates`` does: each doc group's summed score and
    matched-slot count sit at its last slot. ``bits`` (optional i32[R, Q,
    L], 0 past a run's length) is a tag channel OR-reduced per doc group
    the same way; its group value is appended as a fifth output."""
    R, Q, L = docs.shape
    flat_d = docs.reshape(R, Q * L)
    flat_c = contrib.reshape(R, Q * L)
    # slot-major order + a stable sort = the reference's stable merge:
    # equal docs keep ascending slot order
    sdocs, order = torch.sort(flat_d, dim=1, stable=True)
    scontrib = torch.gather(flat_c, 1, order)
    svalid = (sdocs < n_pad).to(torch.float32)
    sbits = None if bits is None else \
        torch.gather(bits.reshape(R, Q * L), 1, order)
    nxt = torch.cat([sdocs[:, 1:], sdocs.new_full((R, 1), -2)], 1)
    is_last = sdocs != nxt
    gscore = scontrib
    gcount = svalid
    gbits = sbits
    for j in range(1, Q):
        same = torch.cat([sdocs.new_full((R, j), -1), sdocs[:, :-j]],
                         1) == sdocs
        gscore = gscore + torch.where(
            same, torch.cat([scontrib.new_zeros((R, j)), scontrib[:, :-j]],
                            1), 0.0)
        gcount = gcount + torch.where(
            same, torch.cat([svalid.new_zeros((R, j)), svalid[:, :-j]], 1),
            0.0)
        if gbits is not None:
            gbits = gbits | torch.where(
                same, torch.cat([sbits.new_zeros((R, j)), sbits[:, :-j]],
                                1), 0)
    if gbits is not None:
        return sdocs, gscore, gcount, is_last, gbits
    return sdocs, gscore, gcount, is_last


def bm25_merge_candidates(postings_docs, postings_impact, starts, lengths,
                          idfw, *, n_pad: int, L: int, slot_bits=None):
    """One query's candidate stage: ``(sdocs i32[Q·L], gscore f32[Q·L],
    gcount f32[Q·L], is_last bool[Q·L])``, as in the reference. With
    ``slot_bits`` (i32[Q], each slot's tag) a fifth output ``gbits
    i32[Q·L]`` holds the OR of the tags of every slot holding the doc, at
    the group's last slot (the bool-tree kernel's clause membership)."""
    docs, contrib = slice_runs(postings_docs, postings_impact, starts,
                               lengths, idfw, n_pad=n_pad, L=L)
    bits = None
    if slot_bits is not None:
        bits = run_bits(slot_bits, lengths, L)[None]
    out = merge_runs(docs[None], contrib[None], n_pad=n_pad, bits=bits)
    return tuple(o[0] for o in out)


def run_bits(slot_bits, lengths, L: int):
    """[..., Q, L] tiles of each slot's tag over its run's valid prefix (0
    past the run's length)."""
    pos = torch.arange(L, device=slot_bits.device)
    valid = pos < lengths.long()[..., None]
    return torch.where(valid, slot_bits[..., None].to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=slot_bits.device))


def _select_topk(sdocs, score, *, k: int, n_pad: int):
    """Top-k of [R, n] candidate scores, padded to k; -inf slots carry
    ``n_pad``."""
    n = sdocs.shape[1]
    vals, sel = topk_stable(score, min(k, n))
    out_docs = torch.gather(sdocs, 1, sel.long())
    out_docs = torch.where(vals > NEG_INF, out_docs,
                           torch.full_like(out_docs, n_pad))
    if n < k:
        R = sdocs.shape[0]
        vals = torch.cat([vals, vals.new_full((R, k - n), NEG_INF)], 1)
        out_docs = torch.cat(
            [out_docs, out_docs.new_full((R, k - n), n_pad)], 1)
    return vals, out_docs.to(torch.int32)


def bm25_topk_merge_body(postings_docs, postings_impact, starts, lengths,
                         idfw, *, n_pad: int, L: int, k: int,
                         min_should_match: int = 1,
                         with_count: bool = False):
    """Score one query against one shard: (values f32[k], local_doc
    i32[k]) plus, with ``with_count``, the i32 number of matching docs."""
    sdocs, gscore, gcount, is_last = bm25_merge_candidates(
        postings_docs, postings_impact, starts, lengths, idfw,
        n_pad=n_pad, L=L)
    matched = is_last & (sdocs < n_pad) & (gcount >= min_should_match)
    score = torch.where(matched, gscore, NEG_INF)
    vals, docs = _select_topk(sdocs[None], score[None], k=k, n_pad=n_pad)
    if with_count:
        return vals[0], docs[0], matched.sum().to(torch.int32)
    return vals[0], docs[0]


def tile_plan(n_pad: int, B: int, S: int, Q: int, L: int, k: int,
              n_sm: int, *, shift: int, sparse_shift: int,
              blocks_per_sm: int, merge_max: int, edges_max: int) -> dict:
    """A doc-tile kernel's launch shape (``csrc/tile_topk.cuh``): tiles of
    2^``tile_shift`` docs over [0, n_pad) (``sparse_shift`` when the Q
    slots of at most L postings hold at most one posting a doc, else
    ``shift``), G blocks a (query, shard), each walking
    ``tiles_per_block`` consecutive tiles (the last block may walk fewer),
    ``edge_tiles`` at a time. G aims at ``blocks_per_sm`` blocks an SM over
    the B·S (query, shard) pairs, with at most one block a tile and G·k at
    most ``merge_max``, so the merge of the G lists stays small (G = 1
    when k alone passes it, or when B·S alone fills the card); a block
    keeps the slots' positions at ``edge_tiles + 1`` tile edges at a time,
    at most ``edges_max`` (Q·(edge_tiles + 1)) unless one tile needs
    more."""
    shift = sparse_shift if Q * L <= n_pad else shift
    tile = 1 << shift
    n_tiles = -(-n_pad // tile)
    want = -(-blocks_per_sm * n_sm // max(B * S, 1))
    G = max(1, min(want, n_tiles, merge_max // max(k, 1)))
    tpb = max(1, -(-n_tiles // G))
    G = max(1, -(-n_tiles // tpb))
    W = min(tpb, max(1, edges_max // max(Q, 1) - 1))
    return dict(tile=tile, tile_shift=shift, n_tiles=n_tiles,
                tiles_per_block=tpb, edge_tiles=W, G=G)


def sparse_candidates_topk_plan(n_pad: int, B: int, S: int, Q: int, L: int,
                                k: int, n_sm: int) -> dict:
    """K1's launch shape: :func:`tile_plan` at this module's ``TILE_*``
    sizes."""
    return tile_plan(n_pad, B, S, Q, L, k, n_sm, shift=TILE_SHIFT,
                     sparse_shift=SPARSE_TILE_SHIFT,
                     blocks_per_sm=TILE_BLOCKS_PER_SM,
                     merge_max=TILE_MERGE_MAX, edges_max=TILE_EDGES_MAX)


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of a CUDA card (the tile plans fill
    them)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sparse_candidates_topk_plain(postings_docs, postings_impact, starts,
                                 lengths, idfw, *, n_pad: int, L: int,
                                 k: int, min_should_match: int = 1,
                                 dense=None, dense_rid=None, dense_w=None,
                                 u_ids=None):
    """Plain version of K1 (see :func:`sparse_candidates_topk`)."""
    # tiered_bm25 imports this module; the dense gather lives there
    from .tiered_bm25 import gather_dense_for_candidates
    B, S, Q = starts.shape
    vals_out, docs_out, count_out = [], [], []
    for s in range(S):
        docs, contrib = slice_runs(postings_docs[s], postings_impact[s],
                                   starts[:, s], lengths[:, s], idfw,
                                   n_pad=n_pad, L=L)
        sdocs, gscore, gcount, is_last = merge_runs(docs, contrib,
                                                    n_pad=n_pad)
        overlap = None
        if dense is not None:
            dense_s = dense[s] if u_ids is None else \
                dense[s][:, u_ids[s].long()]
            add, cnt = gather_dense_for_candidates(
                dense_s, sdocs, dense_rid[:, s], dense_w[:, s], n_pad=n_pad)
            gscore = gscore + add
            gcount = gcount + cnt
        matched = is_last & (sdocs < n_pad) & (gcount >= min_should_match)
        if dense is not None:
            overlap = (matched & (cnt > 0)).sum(1)
        score = torch.where(matched, gscore, NEG_INF)
        v, d = _select_topk(sdocs, score, k=k, n_pad=n_pad)
        c = matched.sum(1)
        if overlap is not None:
            c = c - overlap
        vals_out.append(v)
        docs_out.append(d)
        count_out.append(c.to(torch.int32))
    return (torch.stack(vals_out, 1), torch.stack(docs_out, 1),
            torch.stack(count_out, 1))


def sparse_candidates_topk(postings_docs, postings_impact, starts, lengths,
                           idfw, *, n_pad: int, L: int, k: int,
                           min_should_match: int = 1,
                           dense: Optional[torch.Tensor] = None,
                           dense_rid: Optional[torch.Tensor] = None,
                           dense_w: Optional[torch.Tensor] = None,
                           u_ids: Optional[torch.Tensor] = None):
    """Sparse candidate scoring + top-k for a batch over S shards (K1).

    postings_docs i32[S, P] / postings_impact f32[S, P]: the sparse tables;
    starts / lengths i32[B, S, Q]; idfw f32[B, Q]. With ``dense``
    (bf16[S, n_blk, T, C]) each candidate also gets its dense-tier terms
    (``dense_rid`` i32[B, S, Q] row ids, or slots into ``u_ids`` i32[S, U];
    ``dense_w`` f32[B, S, Q], 0 on inert slots), as ``tiered_bm25_topk``'s
    per-query stage does.

    Returns (vals f32[B, S, k], docs i32[B, S, k], count i32[B, S]): docs
    are shard-local (``n_pad`` on empty slots); count is the number of
    matching candidates, less those the dense tier also matches when
    ``dense`` is given (the tiered step's overlap rule).

    A CPU tensor runs the plain version; a CUDA tensor launches K1 (over
    the doc tiles of :func:`sparse_candidates_topk_plan`, its G lists a
    (query, shard) merged in the same launch call). Each run's valid prefix
    must hold docs in strictly ascending order, as the plane's postings
    do.
    """
    dev = postings_docs.device
    if dev.type == "cpu":
        return sparse_candidates_topk_plain(
            postings_docs, postings_impact, starts, lengths, idfw,
            n_pad=n_pad, L=L, k=k, min_should_match=min_should_match,
            dense=dense, dense_rid=dense_rid, dense_w=dense_w, u_ids=u_ids)
    if dev.type != "cuda":
        raise ValueError(f"sparse_candidates_topk: unsupported device {dev}")
    S, P = postings_docs.shape
    B, _, Q = starts.shape
    _kb.check(postings_docs, "postings_docs", torch.int32, (S, P), dev)
    _kb.check(postings_impact, "postings_impact", torch.float32, (S, P), dev)
    _kb.check(starts, "starts", torch.int32, (B, S, Q), dev)
    _kb.check(lengths, "lengths", torch.int32, (B, S, Q), dev)
    _kb.check(idfw, "idfw", torch.float32, (B, Q), dev)
    if L > P:
        raise ValueError(f"sparse_candidates_topk: L={L} > table {P}")
    n_blk = T = C = U = 0
    if dense is not None:
        _, n_blk, T, C = dense.shape
        _kb.check(dense, "dense", torch.bfloat16, (S, n_blk, T, C), dev)
        _kb.check(dense_rid, "dense_rid", torch.int32, (B, S, Q), dev)
        _kb.check(dense_w, "dense_w", torch.float32, (B, S, Q), dev)
        if u_ids is not None:
            U = u_ids.shape[1]
            _kb.check(u_ids, "u_ids", torch.int32, (S, U), dev)
    vals = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    docs = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    count = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B * S == 0:
        return vals, docs, count
    plan = sparse_candidates_topk_plan(n_pad, B, S, Q, L, k, sm_count(dev))
    G = plan["G"]
    # the G lists and counts of each (query, shard), merged by the launch
    part = torch.empty(B * S * G * (2 * k + 1) if G > 1 else 1,
                       dtype=torch.int32, device=dev)
    n_part = B * S * G * k
    opt = (lambda t: None if t is None else t.data_ptr())
    _kb.launch("sparse_candidates_topk", dev, postings_docs.data_ptr(),
               postings_impact.data_ptr(), P, starts.data_ptr(),
               lengths.data_ptr(), idfw.data_ptr(), opt(dense),
               opt(dense_rid if dense is not None else None),
               opt(dense_w if dense is not None else None),
               opt(u_ids if dense is not None else None), B, S, Q, L,
               n_pad, k, min_should_match, n_blk, T, C, U,
               plan["tile_shift"], plan["tiles_per_block"],
               plan["edge_tiles"], G, part.data_ptr(),
               part.data_ptr() + 4 * n_part, part.data_ptr() + 8 * n_part,
               vals.data_ptr(), docs.data_ptr(), count.data_ptr())
    return vals, docs, count
