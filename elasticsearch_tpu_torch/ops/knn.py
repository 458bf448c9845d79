"""Brute-force and IVF kNN scans (the per-document work of
``_knn_shard_scan``, ``build_knn_step`` and ``build_ivf_knn_step`` in
``elasticsearch_tpu/parallel/dist_search.py``) and the wrappers of kernels
K6 (``csrc/knn_scan.cu``), K7 (``csrc/ivf_scan.cu``) and K8
(``csrc/ivf_rerank.cu``).

Every list here is ordered (score desc, id asc), as ``lax.top_k`` orders
the reference's: the exact scan's ids are shard-local rows, the IVF
window's ids are positions ``p · block + i`` in the gathered union of
probed blocks, and the re-ranked candidates carry their rows. A slot with
no entry holds (−inf, fill), where the fill is ``n_pad`` for rows and
``P · block`` for positions; the reference leaves an arbitrary index
beside −inf, which no caller reads.

Scores are f32. The reference's products sum in XLA's order; the kernels
sum each dot product over d in ascending order with one FMA a term, so
duplicate rows score bitwise alike and the exact scan and the re-rank give
one row the same score.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..kernels import build as _kb
from .topk import (H100_SHARED_OPTIN, NEG_INF, card_limits, topk_merge,
                   topk_merge_row_max, topk_stable)

#: rows per tile of K6/K7 (``KS_ROWS`` in ``csrc/knn_common.cuh``)
TILE_ROWS = 128
#: queries per block of K6/K7 (``KS_BT``)
QUERY_TILE = 16
#: tiles a K6 block tracks in its live-tile bitmap (``K6_BM_WORDS`` · 32
#: in ``csrc/knn_scan.cu``); past them it reads every tile
K6_BITMAP_TILES = 4096


def scan_chunks(rows: int, k: int, S: int, B: int, n_sm: int,
                per_sm: int = 4, max_tiles: Optional[int] = None,
                shared: int = H100_SHARED_OPTIN) -> int:
    """Blocks along the row axis of K6/K7 for ``rows`` rows a shard:
    ``per_sm`` blocks on each of ``n_sm`` SMs over the (shard, query tile)
    grid, at least enough that a block takes at most ``max_tiles`` tiles,
    a multiple of the SM count past one wave, and few enough that K3's
    reduce row (chunks · k) stays within what its plan reduces in shared
    memory (:func:`~.topk.topk_merge_row_max` for a block's ``shared``
    bytes)."""
    tiles = max(-(-rows // TILE_ROWS), 1)
    q_tiles = max(-(-B // QUERY_TILE), 1)
    target = max(1, per_sm * n_sm // max(S * q_tiles, 1))
    if max_tiles:
        target = max(target, -(-tiles // max_tiles))
    chunks = min(tiles, target,
                 max(1, topk_merge_row_max(max(k, 1), shared) // max(k, 1)))
    if chunks > n_sm:
        chunks -= chunks % n_sm
    return chunks


@functools.lru_cache(maxsize=256)
def _k6_blocks_per_sm(B: int, D: int, k: int) -> int:
    """Blocks of a K6 launch one SM holds (at least one: a launch that
    fits none is refused by the library)."""
    return max(1, _kb.query("knn_scan", "es_knn_scan_blocks_per_sm", B, D,
                            k))


def reduce_chunks(part_v, part_i, *, k: int, fill: int):
    """Each row's top-k over its C chunk lists [R, C, k]: one K3 call on
    the [R, C · k] rows (K3 spreads a long row over several blocks itself,
    :func:`~.topk.topk_merge_plan`). Returns (f32[R, k], i32[R, k])."""
    R, C, _ = part_v.shape
    return topk_merge(part_v.reshape(R, C * k), part_i.reshape(R, C * k),
                      k=k, fill_id=fill)


def _pad_list(v, i, k: int, fill: int):
    """Pad [R, m] lists to width k with (−inf, fill)."""
    if v.shape[-1] >= k:
        return v, i
    pad = k - v.shape[-1]
    return (torch.cat([v, v.new_full(v.shape[:-1] + (pad,), NEG_INF)], -1),
            torch.cat([i, i.new_full(i.shape[:-1] + (pad,), fill)], -1))


# ---------------------------------------------------------------------------
# K6: the exact blocked scan (table row 12)
# ---------------------------------------------------------------------------


def knn_scores_plain(qq, vecs_b, vn_b, exists_b, qn, *, l2: bool):
    """The reference's ``score_block``: ``qq · vᵀ`` (l2: ``2q·v − ‖v‖² −
    ‖q‖²``), −inf where the row does not exist. [B, n]."""
    dots = qq @ vecs_b.T
    scores = 2.0 * dots - vn_b[None, :] - qn[:, None] if l2 else dots
    return torch.where(exists_b[None, :], scores,
                       torch.full_like(scores, NEG_INF))


def knn_shard_scan_plain(vecs, vn, exists, qq, qn, *, similarity: str,
                         kk: int, blk: Optional[int] = None,
                         use_blocks: bool = False):
    """Plain version of K6 (see :func:`knn_shard_scan`): per shard, the
    reference's scores, block by block when ``use_blocks`` with a carried
    stable top-kk (earlier blocks first), else in one shot."""
    S, n_pad, _ = vecs.shape
    l2 = similarity == "l2_norm"
    step = blk if use_blocks else n_pad
    out_v, out_i = [], []
    for s in range(S):
        acc_v = acc_i = None
        for lo in range(0, n_pad, step):
            sc = knn_scores_plain(qq, vecs[s, lo:lo + step],
                                  vn[s, lo:lo + step],
                                  exists[s, lo:lo + step], qn, l2=l2)
            v, i = topk_stable(sc, kk)
            i = i + lo
            if acc_v is not None:
                v = torch.cat([acc_v, v], 1)
                i = torch.cat([acc_i, i], 1)
                v, sel = topk_stable(v, kk)
                i = torch.gather(i, 1, sel.long())
            acc_v, acc_i = v, i
        acc_v, acc_i = _pad_list(acc_v, acc_i, kk, n_pad)
        out_v.append(acc_v)
        out_i.append(torch.where(acc_v > NEG_INF, acc_i,
                                 torch.full_like(acc_i, n_pad)))
    return torch.stack(out_v, 1), torch.stack(out_i, 1).to(torch.int32)


def knn_scan_partials(vecs, vn, exists, qq, qn, *, l2: bool, kk: int):
    """Launch K6 on CUDA tensors: each (query, shard, chunk of rows)'s kk
    best (score, row). Returns (part_vals f32[B, S, C, kk], part_rows
    i32[B, S, C, kk])."""
    dev = vecs.device
    if dev.type != "cuda":
        raise ValueError(f"knn_scan_partials: needs CUDA, got {dev}")
    S, n_pad, D = vecs.shape
    B = qq.shape[0]
    _kb.check(vecs, "vecs", torch.float32, (S, n_pad, D), dev)
    _kb.check(vn, "vnorm2", torch.float32, (S, n_pad), dev)
    _kb.check(exists, "exists", torch.bool, (S, n_pad), dev)
    _kb.check(qq, "qq", torch.float32, (B, D), dev)
    _kb.check(qn, "qn", torch.float32, (B,), dev)
    n_sm, shared = card_limits(dev.index)
    C = scan_chunks(n_pad, kk, S, B, n_sm, _k6_blocks_per_sm(B, D, kk),
                    K6_BITMAP_TILES, shared)
    part_v = torch.empty((B, S, C, kk), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, S, C, kk), dtype=torch.int32, device=dev)
    if B * S == 0:
        return part_v, part_i
    ws_bytes = _kb.query("knn_scan", "es_knn_scan_workspace_bytes",
                         B, S, C, kk, D)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                     device=dev) if ws_bytes else None
    _kb.launch("knn_scan", dev, vecs.data_ptr(), vn.data_ptr(),
               exists.data_ptr(), qq.data_ptr(), qn.data_ptr(), B, S, n_pad,
               D, kk, int(l2), C, part_v.data_ptr(), part_i.data_ptr(),
               None if ws is None else ws.data_ptr())
    return part_v, part_i


def knn_shard_scan(vecs, vn, exists, qq, qn, *, similarity: str, kk: int,
                   blk: Optional[int] = None, use_blocks: bool = False):
    """Exact top-kk of every shard for a query batch (K6 + K3).

    vecs f32[S, n_pad, D] (the packed convention: unit rows for cosine),
    vn f32[S, n_pad] (``‖v‖²``, read for l2 only), exists bool[S, n_pad],
    qq f32[B, D] (unit rows for cosine), qn f32[B] (``Σq²`` of the raw
    query, l2 only). Returns (vals f32[B, S, kk], rows i32[B, S, kk]),
    ordered (score desc, row asc), empty slots (−inf, ``n_pad``).
    ``blk``/``use_blocks`` are the reference's blocking, which the plain
    version follows and the kernel, whose result does not depend on it,
    ignores.

    A CPU tensor runs the plain version; a CUDA tensor launches K6 (per
    chunk of rows) and K3 to reduce the chunks (:func:`reduce_chunks`).
    """
    if vecs.device.type == "cpu":
        return knn_shard_scan_plain(vecs, vn, exists, qq, qn,
                                    similarity=similarity, kk=kk, blk=blk,
                                    use_blocks=use_blocks)
    part_v, part_i = knn_scan_partials(vecs, vn, exists, qq, qn,
                                       l2=similarity == "l2_norm", kk=kk)
    B, S, C, _ = part_v.shape
    v, i = reduce_chunks(part_v.view(B * S, C, kk), part_i.view(B * S, C, kk),
                         k=kk, fill=vecs.shape[1])
    return v.view(B, S, kk), i.view(B, S, kk)


# ---------------------------------------------------------------------------
# K7: the IVF scan over the probed union (table row 13, the scan)
# ---------------------------------------------------------------------------


def ivf_scores_plain(codes, scale, off, rowid, rcl, vn, qq, qsum, qn,
                     probed, u_s, *, l2: bool, n_pad: int):
    """One shard's dequantized scores over its gathered union: [B, P·blk],
    −inf where the row is padding or its cluster is not in the query's
    probed set. ``codes`` etc. are the shard's [NB+1, blk, ...] tier."""
    u = u_s.long()
    g_codes = codes[u].to(torch.float32).reshape(-1, codes.shape[-1])
    g_rowid = rowid[u].reshape(-1)
    g_rcl = rcl[u].reshape(-1)
    dots = qq @ g_codes.T
    s = scale[u].reshape(-1)[None, :] * dots + \
        off[u].reshape(-1)[None, :] * qsum[:, None]
    if l2:
        vn_g = vn[g_rowid.clamp(0, n_pad - 1).long()]
        s = 2.0 * s - vn_g[None, :] - qn[:, None]
    member = (g_rcl[None, :, None] == probed[:, None, :]).any(-1)
    live = (g_rowid < n_pad)[None, :]
    return torch.where(member & live, s, torch.full_like(s, NEG_INF))


def ivf_scan_plain(codes, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
                   u_blocks, *, l2: bool, n_pad: int, r_cand: int):
    """Plain version of K7 (see :func:`ivf_scan`)."""
    S, P = u_blocks.shape
    blk = rowid.shape[-1]
    fill = P * blk
    out_v, out_p = [], []
    for s in range(S):
        sc = ivf_scores_plain(codes[s], scale[s], off[s], rowid[s], rcl[s],
                              vn[s], qq, qsum, qn, probed, u_blocks[s], l2=l2,
                              n_pad=n_pad)
        v, p = _pad_list(*topk_stable(sc, r_cand), r_cand, fill)
        out_v.append(v)
        out_p.append(torch.where(v > NEG_INF, p, torch.full_like(p, fill)))
    return torch.stack(out_v, 1), torch.stack(out_p, 1).to(torch.int32)


def ivf_scan_partials(codes, scale, off, rowid, rcl, vn, qq, qsum, qn,
                      probed, u_blocks, *, l2: bool, n_pad: int, nlist: int,
                      r_cand: int):
    """Launch K7 on CUDA tensors: each (query, shard, chunk of the union)'s
    ``r_cand`` best (quantized score, position). Returns (part_vals
    f32[B, S, C, r_cand], part_pos i32[B, S, C, r_cand])."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan_partials: needs CUDA, got {dev}")
    S, NB1, blk, D = codes.shape
    B, nprobe = probed.shape
    P = u_blocks.shape[1]
    if codes.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"codes: expected int8 or bfloat16, got "
                        f"{codes.dtype}")
    _kb.check(codes, "codes", codes.dtype, (S, NB1, blk, D), dev)
    for name, t, dt in (("scale", scale, torch.float32),
                        ("off", off, torch.float32),
                        ("rowid", rowid, torch.int32),
                        ("rcl", rcl, torch.int32)):
        _kb.check(t, name, dt, (S, NB1, blk), dev)
    _kb.check(vn, "vnorm2", torch.float32, (S, n_pad), dev)
    _kb.check(qq, "qq", torch.float32, (B, D), dev)
    _kb.check(qsum, "qsum", torch.float32, (B,), dev)
    _kb.check(qn, "qn", torch.float32, (B,), dev)
    _kb.check(probed, "probed", torch.int32, (B, nprobe), dev)
    _kb.check(u_blocks, "u_blocks", torch.int32, (S, P), dev)
    n_sm, shared = card_limits(dev.index)
    C = scan_chunks(P * blk, r_cand, S, B, n_sm, shared=shared)
    part_v = torch.empty((B, S, C, r_cand), dtype=torch.float32, device=dev)
    part_p = torch.empty((B, S, C, r_cand), dtype=torch.int32, device=dev)
    if B * S == 0:
        return part_v, part_p
    ws_bytes = _kb.query("ivf_scan", "es_ivf_scan_workspace_bytes",
                         B, S, C, r_cand, nlist, D)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                     device=dev) if ws_bytes else None
    _kb.launch("ivf_scan", dev, codes.data_ptr(),
               int(codes.dtype == torch.bfloat16), scale.data_ptr(),
               off.data_ptr(), rowid.data_ptr(), rcl.data_ptr(),
               vn.data_ptr(), qq.data_ptr(), qsum.data_ptr(), qn.data_ptr(),
               probed.data_ptr(), u_blocks.data_ptr(), B, S, NB1, blk, D,
               n_pad, nlist, nprobe, P, r_cand, int(l2), C,
               part_v.data_ptr(), part_p.data_ptr(),
               None if ws is None else ws.data_ptr())
    return part_v, part_p


def ivf_scan(codes, scale, off, rowid, rcl, vn, qq, qsum, qn, probed,
             u_blocks, *, l2: bool, n_pad: int, nlist: int, r_cand: int):
    """The re-rank window of every (query, shard) over the probed union
    (K7 + K3).

    codes int8 or bf16 [S, NB+1, blk, D] (block NB is all padding), scale/
    off f32, rowid i32 (original local row, ``n_pad`` = padding), rcl i32
    (cluster, −1 = padding) [S, NB+1, blk]; vn f32[S, n_pad]; qq f32[B, D];
    qsum/qn f32[B]; probed i32[B, nprobe] (the query's clusters, of
    ``nlist``); u_blocks i32[S, P] (the union's blocks, NB = padding).

    A row scores ``scale·(qq·c) + off·Σqq`` (l2: ``2s − ‖v‖² − ‖q‖²`` with
    ‖v‖² of its row), and takes part only if it is real and its cluster is
    probed by the query. Returns the window the reference's scan carries:
    (vals f32[B, S, r_cand], pos i32[B, S, r_cand]), the exact top-r_cand
    over positions ``p · blk + i`` ordered (value desc, position asc),
    empty slots (−inf, P · blk).

    A CPU tensor runs the plain version; a CUDA tensor launches K7 (per
    chunk of the union) and K3 to reduce the chunks (:func:`reduce_chunks`).
    """
    kw = dict(l2=l2, n_pad=n_pad, r_cand=r_cand)
    args = (codes, scale, off, rowid, rcl, vn, qq, qsum, qn, probed, u_blocks)
    if codes.device.type == "cpu":
        return ivf_scan_plain(*args, **kw)
    part_v, part_p = ivf_scan_partials(*args, **kw, nlist=nlist)
    B, S, C, _ = part_v.shape
    v, p = reduce_chunks(part_v.view(B * S, C, r_cand),
                         part_p.view(B * S, C, r_cand), k=r_cand,
                         fill=u_blocks.shape[1] * rowid.shape[-1])
    return v.view(B, S, r_cand), p.view(B, S, r_cand)


# ---------------------------------------------------------------------------
# K8: the exact re-rank of the window (table row 13, the re-rank)
# ---------------------------------------------------------------------------


def window_rows(win_pos, u_blocks, rowid):
    """Original local rows of window positions: [B, S, R] (positions past
    the union clip to its last slot; callers mask those entries)."""
    S, P = u_blocks.shape
    blk = rowid.shape[-1]
    out = []
    for s in range(S):
        rid = rowid[s][u_blocks[s].long()].reshape(-1)
        out.append(rid[win_pos[:, s].long().clamp(0, P * blk - 1)])
    return torch.stack(out, 1)


def ivf_rerank_plain(win_vals, win_pos, u_blocks, rowid, vecs, vn, qq, qn,
                     *, l2: bool, n_pad: int):
    """Plain version of K8 (see :func:`ivf_rerank`)."""
    live = win_vals > NEG_INF
    rows = torch.where(live, window_rows(win_pos, u_blocks, rowid),
                       torch.full_like(win_pos, n_pad))
    safe = rows.clamp(0, n_pad - 1).long()
    out = []
    for s in range(vecs.shape[0]):
        cv = vecs[s][safe[:, s]]                          # [B, R, D]
        ex = torch.einsum("bd,brd->br", qq, cv)
        if l2:
            ex = 2.0 * ex - vn[s][safe[:, s]] - qn[:, None]
        out.append(ex)
    ex = torch.stack(out, 1)
    return (torch.where(live, ex, torch.full_like(ex, NEG_INF)),
            rows.to(torch.int32))


def ivf_rerank(win_vals, win_pos, u_blocks, rowid, vecs, vn, qq, qn, *,
               l2: bool, n_pad: int):
    """Exact f32 re-score of each window entry from the f32 tier (K8).

    win_vals/win_pos [B, S, R]: :func:`ivf_scan`'s window; u_blocks and
    rowid as there; vecs f32[S, n_pad, D]; vn f32[S, n_pad]; qq f32[B, D];
    qn f32[B]. Returns (scores f32[B, S, R], rows i32[B, S, R]): the
    entry's row and ``qq·v`` (l2: ``2·dot − ‖v‖² − ‖q‖²``); −inf and
    ``n_pad`` where the window held −inf.

    A CPU tensor runs the plain version; a CUDA tensor launches K8.
    """
    dev = vecs.device
    if dev.type == "cpu":
        return ivf_rerank_plain(win_vals, win_pos, u_blocks, rowid, vecs, vn,
                                qq, qn, l2=l2, n_pad=n_pad)
    if dev.type != "cuda":
        raise ValueError(f"ivf_rerank: unsupported device {dev}")
    B, S, R = win_vals.shape
    D = vecs.shape[2]
    P = u_blocks.shape[1]
    _, NB1, blk = rowid.shape
    _kb.check(win_vals, "win_vals", torch.float32, (B, S, R), dev)
    _kb.check(win_pos, "win_pos", torch.int32, (B, S, R), dev)
    _kb.check(u_blocks, "u_blocks", torch.int32, (S, P), dev)
    _kb.check(rowid, "rowid", torch.int32, (S, NB1, blk), dev)
    _kb.check(vecs, "vecs", torch.float32, (S, n_pad, D), dev)
    _kb.check(vn, "vnorm2", torch.float32, (S, n_pad), dev)
    _kb.check(qq, "qq", torch.float32, (B, D), dev)
    _kb.check(qn, "qn", torch.float32, (B,), dev)
    score = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    rows = torch.empty((B, S, R), dtype=torch.int32, device=dev)
    if B * S * R == 0:
        return score, rows
    _kb.launch("ivf_rerank", dev, win_vals.data_ptr(), win_pos.data_ptr(),
               u_blocks.data_ptr(), rowid.data_ptr(), vecs.data_ptr(),
               vn.data_ptr(), qq.data_ptr(), qn.data_ptr(), B, S, R, P, NB1,
               blk, n_pad, D, int(l2), score.data_ptr(), rows.data_ptr())
    return score, rows
