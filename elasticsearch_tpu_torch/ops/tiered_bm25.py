"""Tiered BM25 top-k (port of ``elasticsearch_tpu/ops/tiered_bm25.py``) and
the wrapper of kernel K2 (``csrc/dense_stream_topk.cu``).

The vocabulary splits by document frequency. Head terms (df above a
threshold) get dense bf16 impact rows, block-major [n_blk, T, C]; a query
batch scores them as ``W[B, T] @ f32(rows)`` with a running top-k (K2).
Tail terms stay in the sorted-merge tier (K1), whose candidates also pick up
their dense-tier contributions. The union of the two k-lists, deduplicated
(K3), is exact: see the reference module's docstring for the argument.

The port writes the reference's ``vmap`` over shards out as a leading shard
dimension S: dense rows are [S, n_blk, T, C], per-query inputs [B, S, ...].
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..kernels import build as _kb
from .sorted_merge import sparse_candidates_topk
from .topk import H100_SHARED_OPTIN, card_limits, topk_merge, topk_stable

NEG_INF = float("-inf")

#: K2's sizes, as ``csrc/dense_stream_topk.cu`` defines them: queries a
#: block, a query's candidate buffer, the non-zero weights a query keeps in
#: shared memory, the ring's slots, docs a pass and passes a chunk
K2_QUERIES = 64
K2_CAND = 64
K2_NZ = 16
K2_STAGES = 4
K2_PASS = 128
K2_MAX_PASSES = 8
#: a tile is a multiple of this many docs (of every chunk the ring takes)
K2_TILE_ALIGN = K2_PASS * K2_MAX_PASSES
#: K3's first call reduces rows of n_tiles · k tile lists: at most this
K2_MAX_PARTIALS = 1 << 14


# ---------------------------------------------------------------------------
# host-side tier construction
# ---------------------------------------------------------------------------


def split_tiers(shard: dict, *, dense_threshold: int,
                max_dense_terms: int = 512) -> dict:
    """Split one shard's CSR postings into sparse CSR + dense-term list
    (same arrays as the reference's ``split_tiers``)."""
    df = shard["df"]
    dense_mask = df > dense_threshold
    dense_tids = np.nonzero(dense_mask)[0]
    if dense_tids.size > max_dense_terms:
        # keep the heaviest; overflow terms fall back to the sparse tier
        order = np.argsort(-df[dense_tids], kind="stable")
        keep = dense_tids[order[:max_dense_terms]]
        dense_mask = np.zeros_like(dense_mask)
        dense_mask[keep] = True
        dense_tids = np.sort(keep)
    else:
        dense_tids = np.sort(dense_tids)

    offsets = shard["offsets"]
    keep_posting = np.ones(shard["docs"].shape[0], bool)
    for t in dense_tids:
        keep_posting[offsets[t]: offsets[t + 1]] = False
    new_df = df.copy()
    new_df[dense_mask] = 0
    new_offsets = np.zeros_like(offsets)
    np.cumsum(new_df, out=new_offsets[1:])
    return dict(
        docs=shard["docs"][keep_posting],
        tf=shard["tf"][keep_posting],
        offsets=new_offsets, df=new_df,
        dense_tids=dense_tids.astype(np.int64),
        sparse_max_df=int(new_df.max()) if new_df.size else 0)


def build_dense_rows(shard: dict, dense_tids: np.ndarray, impacts: np.ndarray,
                     *, n_pad: int, block: int, t_pad: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 impact rows of the dense tier, block-major [n_blk, t_pad, C].

    Filled one row at a time into ``out`` (a zero tensor on the plane's
    device; a new host tensor when None), with no f32 [T, n_pad]
    transient. The f32 → bf16 rounding
    is round-to-nearest-even, as ``ml_dtypes`` rounds in the reference.
    """
    n_blk = -(-n_pad // block)
    if out is None:
        out = torch.zeros((n_blk, t_pad, block), dtype=torch.bfloat16)
    flat = out.view(-1)
    offsets = shard["offsets"]
    docs_all = shard["docs"]
    for r, t in enumerate(dense_tids):
        st, en = int(offsets[t]), int(offsets[t + 1])
        d = torch.from_numpy(docs_all[st:en].astype(np.int64))
        idx = ((d // block) * t_pad + r) * block + d % block
        vals = torch.from_numpy(np.ascontiguousarray(impacts[st:en]))
        flat[idx.to(out.device)] = vals.to(out.device).to(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# device pieces
# ---------------------------------------------------------------------------


def dense_stream_topk_plain(W, dense, *, k: int, u_ids=None,
                            min_should_match: int = 1):
    """Plain version of :func:`dense_stream_topk`: per shard and block,
    ``W @ f32(block)`` and a running stable top-k, as the reference."""
    B, S, _ = W.shape
    _, n_blk, T, C = dense.shape
    n_pad = n_blk * C
    need_count = min_should_match > 1
    vals_out, docs_out, nm_out = [], [], []
    for s in range(S):
        rows = dense[s] if u_ids is None else dense[s][:, u_ids[s].long()]
        Ws = W[:, s]
        Wpos = (Ws > 0).to(torch.float32)
        best_v = W.new_full((B, 0), NEG_INF)
        best_i = torch.zeros((B, 0), dtype=torch.int32, device=W.device)
        n_matched = torch.zeros(B, dtype=torch.int32, device=W.device)
        for blk in range(n_blk):
            block = rows[blk].to(torch.float32)
            sc = Ws @ block
            if need_count:
                cnt = Wpos @ (block > 0).to(torch.float32)
                sc = torch.where(cnt >= min_should_match, sc, NEG_INF)
            # a matched doc always scores > 0 (impacts > 0, idf > 0)
            sc = torch.where(sc > 0, sc, NEG_INF)
            n_matched += (sc > NEG_INF).sum(1).to(torch.int32)
            v, i = topk_stable(sc, k)
            # earlier blocks sit first: ties keep doc-ascending order
            cat_v = torch.cat([best_v, v], 1)
            cat_i = torch.cat([best_i, i + blk * C], 1)
            best_v, sel = topk_stable(cat_v, k)
            best_i = torch.gather(cat_i, 1, sel.long())
        if best_v.shape[1] < k:
            pad = k - best_v.shape[1]
            best_v = torch.cat([best_v, best_v.new_full((B, pad), NEG_INF)],
                               1)
            best_i = torch.cat([best_i, best_i.new_full((B, pad), n_pad)], 1)
        best_i = torch.where(best_v > NEG_INF, best_i,
                             torch.full_like(best_i, n_pad))
        vals_out.append(best_v)
        docs_out.append(best_i)
        nm_out.append(n_matched)
    return (torch.stack(vals_out, 1), torch.stack(docs_out, 1),
            torch.stack(nm_out, 1))


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def k2_shared_bytes(QB: int, U: int, k: int, top_shared: bool,
                    rows_max: int) -> int:
    """Dynamic shared memory of K2's tile kernel (``k2_shared_bytes`` of
    the source): candidate buffers, per-query state, weights, staged row
    ids, the lists when they sit there, the ring's barriers, and the ring
    of ``K2_STAGES`` slots of ``rows_max`` rows of one pass."""
    return (_align16(QB * K2_CAND * 8) + _align16(QB * 16)
            + _align16(QB * K2_NZ * 8) + _align16(U * 4)
            + (_align16(QB * k * 8) if top_shared else 0)
            + _align16(K2_STAGES * 16) + K2_STAGES * rows_max * K2_PASS * 2)


def k2_workspace_bytes(B: int, S: int, U: int, n_tiles: int, QB: int,
                       rows_max: int) -> int:
    """K2's workspace, in the order ``es_dense_stream_topk`` lays it out
    (the entry refuses fewer bytes than its sections take): each query's
    compacted (staged row, weight) pairs [B·S, U], their counts,
    the staged rows' ids [S, U] and their number a shard; and, when U rows
    may pass one group of the ring (U > ``rows_max``), each block's sums
    between row groups (1 KB a query)."""
    groups = -(-B // QB)
    carry = n_tiles * S * groups * QB * 1024 if U > rows_max else 0
    return (_align16(8 * B * S * U) + _align16(4 * B * S)
            + _align16(4 * S * U) + _align16(4 * S) + carry)


def dense_stream_topk_plan(B: int, S: int, U: int, n_pad: int, k: int,
                           n_sm: int, shared: int = H100_SHARED_OPTIN
                           ) -> dict:
    """K2's launch shape: groups of at most ``K2_QUERIES`` queries (every
    query of a headline batch in one block, which reads each row slice
    once), doc tiles (multiples of ``K2_TILE_ALIGN`` docs) enough for one
    block an SM over the card, one wave, at most ``K2_MAX_PARTIALS // k``
    tiles so that K3's row of tile lists stays short; the lists in shared
    memory when they take at most a quarter of the ``shared`` bytes a
    block may have; the ring (``rows_max`` rows of a pass, at most
    ``K2_MAX_PASSES`` passes of U rows) filling the rest (where not even
    one row fits, one row, which the C entry refuses)."""
    QB = max(1, min(B, K2_QUERIES))
    groups = -(-B // QB)
    want = -(-n_sm // max(S * groups, 1))
    tiles = max(1, min(want, K2_MAX_PARTIALS // max(k, 1),
                       -(-n_pad // K2_TILE_ALIGN)))
    per = -(-n_pad // tiles)
    per = -(-per // K2_TILE_ALIGN) * K2_TILE_ALIGN
    n_tiles = -(-n_pad // per)
    row = K2_STAGES * K2_PASS * 2
    top_shared = _align16(QB * k * 8) <= shared // 4
    rows = (shared - k2_shared_bytes(QB, U, k, top_shared, 0)) // row
    if rows < 1 and top_shared:
        top_shared = False
        rows = (shared - k2_shared_bytes(QB, U, k, False, 0)) // row
    rows = max(1, min(rows, K2_MAX_PASSES * max(U, 1)))
    return dict(QB=QB, groups=groups, tile=per, n_tiles=n_tiles,
                top_shared=top_shared, rows_max=rows,
                shared_bytes=k2_shared_bytes(QB, U, k, top_shared, rows),
                blocks=n_tiles * S * groups,
                workspace_bytes=k2_workspace_bytes(B, S, U, n_tiles, QB,
                                                   rows))


@functools.lru_cache(maxsize=256)
def _k2_launch_plan(B: int, S: int, U: int, n_pad: int, k: int, index):
    """:func:`dense_stream_topk_plan` on card ``index`` as the C entry
    takes it."""
    p = dense_stream_topk_plan(B, S, U, n_pad, k, *card_limits(index))
    return (p["tile"], p["n_tiles"], p["QB"], int(p["top_shared"]),
            p["rows_max"], p["workspace_bytes"])


def dense_stream_partials(W, dense, *, k: int, u_ids=None,
                          min_should_match: int = 1):
    """Launch K2 on CUDA tensors: per doc tile, each query's k best
    dense-only (score, doc) pairs and the matched counts. Returns
    (part_vals f32[B, S, n_tiles, k], part_docs i32[B, S, n_tiles, k],
    n_matched i32[B, S]); see :func:`dense_stream_topk`."""
    dev = W.device
    if dev.type != "cuda":
        raise ValueError(f"dense_stream_partials: needs CUDA, got {dev}")
    B, S, U = W.shape
    _, n_blk, T, C = dense.shape
    n_pad = n_blk * C
    _kb.check(W, "W", torch.float32, (B, S, U), dev)
    _kb.check(dense, "dense", torch.bfloat16, (S, n_blk, T, C), dev)
    if u_ids is not None:
        _kb.check(u_ids, "u_ids", torch.int32, (S, U), dev)
    if u_ids is None and U != T:
        raise ValueError("dense_stream_topk: W spans all T rows unless "
                         "u_ids selects them")
    if C % 4 or dense.data_ptr() % 8:
        raise ValueError("dense_stream_topk: block width must be a "
                         "multiple of 4 and the rows 8-byte aligned")
    per, n_tiles, QB, top_shared, rows_max, ws_bytes = _k2_launch_plan(
        B, S, U, n_pad, k, dev.index)
    part_v = torch.empty((B, S, n_tiles, k), dtype=torch.float32,
                         device=dev)
    part_d = torch.empty((B, S, n_tiles, k), dtype=torch.int32, device=dev)
    n_matched = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if B * S:
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
        _kb.launch("dense_stream_topk", dev, W.data_ptr(),
                   dense.data_ptr(),
                   None if u_ids is None else u_ids.data_ptr(), B, S, U,
                   n_blk, T, C, n_pad, k, min_should_match, per, n_tiles,
                   QB, top_shared, rows_max, part_v.data_ptr(),
                   part_d.data_ptr(), n_matched.data_ptr(), ws.data_ptr(),
                   ws_bytes)
    return part_v, part_d, n_matched


def dense_stream_topk(W, dense, *, k: int, u_ids=None,
                      min_should_match: int = 1):
    """Batched streaming top-k over the dense tier of S shards.

    W: f32[B, S, U] per-query weights over the shard's rows (or over the
    used rows ``u_ids`` i32[S, U], read in place); dense: bf16[S, n_blk, T,
    C]. Returns (vals f32[B, S, k], docs i32[B, S, k], n_matched i32[B, S])
    of docs scored by dense terms alone (unmatched docs excluded, empty
    slots ``n_pad``); ``n_matched`` counts every dense-matched doc.

    A CPU tensor runs the plain version; a CUDA tensor launches K2 (per
    tile partial top-k + counts), then K3 to reduce the tiles.
    """
    if W.device.type == "cpu":
        return dense_stream_topk_plain(W, dense, k=k, u_ids=u_ids,
                                       min_should_match=min_should_match)
    part_v, part_d, n_matched = dense_stream_partials(
        W, dense, k=k, u_ids=u_ids, min_should_match=min_should_match)
    B, S, n_tiles, _ = part_v.shape
    n_pad = dense.shape[1] * dense.shape[3]
    vals, docs = topk_merge(part_v.view(B * S, n_tiles * k),
                            part_d.view(B * S, n_tiles * k), k=k,
                            fill_id=n_pad)
    return vals.view(B, S, k), docs.view(B, S, k), n_matched


def gather_dense_for_candidates(dense_blocks, cand_docs, dense_rid, dense_w,
                                *, n_pad: int):
    """Per-candidate dense-tier contributions.

    dense_blocks: bf16[n_blk, T, C]; cand_docs: i32[..., M] (n_pad =
    absent); dense_rid / dense_w: i32[..., Qd] / f32[..., Qd] (w = 0 on
    padding slots). Returns (add f32[..., M], match_cnt f32[..., M]),
    accumulated from 0 in slot order j = 0..Qd-1 as in the reference.
    """
    C = dense_blocks.shape[2]
    safe = torch.clamp(cand_docs.long(), max=n_pad - 1)
    blk_i = safe // C
    off = safe % C
    add = torch.zeros(cand_docs.shape, dtype=torch.float32,
                      device=cand_docs.device)
    cnt = torch.zeros_like(add)
    for j in range(dense_rid.shape[-1]):
        rid = dense_rid[..., j:j + 1].long().expand_as(blk_i)
        row_vals = dense_blocks[blk_i, rid, off].to(torch.float32)
        w = dense_w[..., j:j + 1]
        hit = (row_vals > 0) & (w > 0) & (cand_docs < n_pad)
        add = add + torch.where(hit, w * row_vals, 0.0)
        cnt = cnt + torch.where(hit, 1.0, 0.0)
    return add, cnt


def merge_topk_lists(vals_a, docs_a, vals_b, docs_b, *, k: int,
                     n_pad: int):
    """Exact union of two [R, k] top-k lists that may share docs (a doc in
    both keeps its higher score). Returns (vals, docs) ordered (score
    desc, doc asc); empty slots hold (-inf, n_pad). K3 with dedup."""
    return topk_merge(vals_a, docs_a, vals_b, docs_b, k=k, fill_id=n_pad,
                      dedup=True)


def tiered_bm25_topk(postings_docs, postings_impact, dense_blocks,
                     starts, lengths, idfw, dense_rid, dense_w, W,
                     *, n_pad: int, L: int, k: int,
                     min_should_match: int = 1, with_count: bool = False,
                     u_ids=None):
    """Full tiered scoring of a query batch against S shards.

    Shapes: postings i32/f32[S, P], dense_blocks bf16[S, n_blk, T, C],
    starts/lengths i32[B, S, Q], idfw f32[B, Q], dense_rid i32[B, S, Q],
    dense_w f32[B, S, Q], W f32[B, S, U] (``u_ids`` i32[S, U] when U < T).
    Returns (vals f32[B, S, k], docs i32[B, S, k]) plus i32[B, S] exact
    match counts with ``with_count`` (sparse candidates + dense-matched −
    overlap; requires min_should_match == 1)."""
    if with_count and min_should_match != 1:
        raise ValueError("with_count requires min_should_match == 1")
    B, S, _ = starts.shape
    cand_v, cand_d, cand_net = sparse_candidates_topk(
        postings_docs, postings_impact, starts, lengths, idfw, n_pad=n_pad,
        L=L, k=k, min_should_match=min_should_match, dense=dense_blocks,
        dense_rid=dense_rid, dense_w=dense_w, u_ids=u_ids)
    dense_v, dense_d, dense_n = dense_stream_topk(
        W, dense_blocks, k=k, u_ids=u_ids,
        min_should_match=min_should_match)
    vals, docs = merge_topk_lists(
        cand_v.reshape(B * S, k), cand_d.reshape(B * S, k),
        dense_v.reshape(B * S, k), dense_d.reshape(B * S, k), k=k,
        n_pad=n_pad)
    vals, docs = vals.view(B, S, k), docs.view(B, S, k)
    if with_count:
        return vals, docs, cand_net + dense_n
    return vals, docs
