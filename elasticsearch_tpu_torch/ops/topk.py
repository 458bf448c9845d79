"""Tie-stable top-k (port of ``elasticsearch_tpu/ops/topk.py``), the
wrapper of kernel K3 (``csrc/topk_merge.cu``) and the masked segment top-k,
kernel K19 (``csrc/segment_topk.cu``).

Every top-k in the engine orders hits (score desc, doc asc): ``lax.top_k``
returns the lowest index among equal values, and candidate lists are laid
out doc-ascending. ``torch.topk`` promises no order among equal values,
so nothing here uses it: the plain versions select with
``torch.sort(..., descending=True, stable=True)``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..kernels import build as _kb

NEG_INF = float("-inf")

_BLOCK = 16384          # scores per block in the two-stage path


def topk_stable(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, equal
    values in ascending index order. Returns (values, int32 indices)."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def batched_blockwise_topk(scores: torch.Tensor, k: int,
                           block: int = _BLOCK):
    """Exact top-k over the last axis of ``scores`` [B, n], two-stage
    (per-block top-k, then a top-k over the block-major candidates) when
    the shape blocks, as the reference does; ties go to the lower index
    (candidates stay block-major and every stage is stable)."""
    n = scores.shape[-1]
    if n % block or n < 2 * block or k > block:
        return topk_stable(scores, k)
    nb = n // block
    bv, bi = topk_stable(scores.reshape(scores.shape[0], nb, block), k)
    base = (torch.arange(nb, dtype=torch.int32,
                         device=scores.device) * block)[None, :, None]
    cand_idx = (bi + base).reshape(scores.shape[0], nb * k)
    cand_vals = bv.reshape(scores.shape[0], nb * k)
    vals, sel = topk_stable(cand_vals, k)
    return vals, torch.gather(cand_idx, 1, sel.long())


def topk_merge_plain(a_vals, a_ids, b_vals=None, b_ids=None, *, k: int,
                     fill_id: int, dedup: bool = False,
                     seg_len: Optional[int] = None, seg_stride: int = 0,
                     with_sel: bool = False):
    """Plain version of K3 (see :func:`topk_merge`)."""
    vals = a_vals if b_vals is None else torch.cat([a_vals, b_vals], -1)
    ids = a_ids if b_ids is None else torch.cat([a_ids, b_ids], -1)
    R, m = vals.shape
    ids = ids.to(torch.int64)
    if seg_stride:
        col = torch.arange(m, device=vals.device)
        ids = ids + (col // seg_len)[None, :] * seg_stride
    ok = (vals > NEG_INF) & (ids < fill_id)
    vals = torch.where(ok, vals, torch.full_like(vals, NEG_INF))
    if dedup:
        # group by (id asc, value desc, column asc); all but the first of a
        # group are dominated duplicates
        o1 = torch.sort(vals, dim=1, descending=True, stable=True).indices
        o2 = torch.sort(torch.gather(ids, 1, o1), dim=1, stable=True).indices
        order = torch.gather(o1, 1, o2)
        sid = torch.gather(ids, 1, order)
        dup = torch.zeros_like(sid, dtype=torch.bool)
        dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
        drop = torch.zeros_like(dup).scatter(1, order, dup)
        vals = torch.where(drop, torch.full_like(vals, NEG_INF), vals)
    # final order (value desc, id asc, column asc): two stable sorts
    o1 = torch.sort(ids, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(vals, 1, o1), dim=1, descending=True,
                    stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    out_v = torch.gather(vals, 1, order)
    out_i = torch.gather(ids, 1, order)
    out_i = torch.where(out_v > NEG_INF, out_i,
                        torch.full_like(out_i, fill_id))
    sel = torch.where(out_v > NEG_INF, order, torch.zeros_like(order))
    if out_v.shape[1] < k:
        pad = k - out_v.shape[1]
        out_v = torch.cat([out_v, out_v.new_full((R, pad), NEG_INF)], 1)
        out_i = torch.cat([out_i, out_i.new_full((R, pad), fill_id)], 1)
        sel = torch.cat([sel, sel.new_zeros((R, pad))], 1)
    if with_sel:
        return out_v, out_i.to(torch.int32), sel.to(torch.int32)
    return out_v, out_i.to(torch.int32)


#: bytes of shared memory kept free beside a K3 block's buffers (its
#: static histogram, warp sums and counters take 1,072)
K3_STATIC_SHARED = 2048
#: bytes a K3 buffer entry takes: its 64-bit key and its column
K3_ENTRY_BYTES = 12
#: the smallest survivor buffer of a block that selects
K3_MIN_SURVIVORS = 256
#: K3 blocks an SM holds at once (2,048 threads): the plan keeps a
#: launch's segments within one wave
K3_BLOCKS_PER_SM = 8
#: the shortest segment the plan gives a block of its own (shorter rows
#: take one block: a launch and a merge cost more than the select saves)
K3_SEGMENT_MIN = 1024
#: a block's shared memory on an H100 (the plan's default)
H100_SHARED_OPTIN = 232448


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def k3_survivors(n: int, k: int, dedup: bool) -> int:
    """The survivor buffer of a K3 block that reduces ``n`` entries to
    ``k``: a power of two holding the whole segment with ``dedup`` (whose
    pass sorts it by id), else at least 2k (and 256) entries or the whole
    segment, whichever is fewer."""
    if dedup:
        return _pow2(max(n, 1))
    return _pow2(max(min(n, max(2 * k, K3_MIN_SURVIVORS)), 1))


def k3_block_bytes(cap: int, S: int) -> int:
    """Bytes of a K3 block's buffers: ``cap`` row entries and ``S``
    survivors, 12 bytes each, rounded to 16."""
    return -(-(cap + S) * K3_ENTRY_BYTES // 16) * 16


def _k3_fits(n: int, k: int, dedup: bool, shared: int) -> bool:
    return k3_block_bytes(n, k3_survivors(n, k, dedup)) <= \
        shared - K3_STATIC_SHARED


def k3_segment_max(k: int, dedup: bool, shared: int = H100_SHARED_OPTIN
                   ) -> int:
    """The most entries a K3 block holds in shared memory when it reduces
    them to ``k`` (0: not even one)."""
    lo, hi = 0, shared // K3_ENTRY_BYTES
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _k3_fits(mid, k, dedup, shared):
            lo = mid
        else:
            hi = mid - 1
    return lo


def topk_merge_plan(R: int, m: int, k: int, dedup: bool, n_sm: int,
                    shared: int = H100_SHARED_OPTIN) -> dict:
    """K3's launch for ``R`` rows of ``m`` entries reduced to ``k``.

    A row of at least 4k entries is split into ``G`` segments of ``L``
    columns, one block each (``R · G`` blocks), whose k best go to a
    second kernel that merges a row's G lists (``G · k`` entries). A
    block's time grows with the entries it holds, so G is √(m / k), which
    makes a segment as long as the merge's row (16 rows of 132 lists of
    128, the hybrid's: 11 segments, 176 blocks on 132 SMs), cut to one
    wave of ``K3_BLOCKS_PER_SM`` blocks an SM, to segments of at least
    ``K3_SEGMENT_MIN`` entries and so that the merge's row fits a block's
    shared memory, raised so that a segment does, and at most m / 2k (a
    segment keeps at least twice what it passes on). ``S0``/``S1``: the
    segment's and the merge's survivor buffers; ``glob0``/``glob1``:
    buffers past shared memory, held in the workspace instead
    (``workspace_bytes``, with the partial lists)."""
    G = 1
    if k >= 1 and m >= 4 * k:
        g_max = m // (2 * k)
        seg = k3_segment_max(k, dedup, shared)
        G = round(math.sqrt(m / k))
        G = min(G, max(1, K3_BLOCKS_PER_SM * n_sm // max(R, 1)),
                max(1, seg // k), max(1, m // K3_SEGMENT_MIN))
        if seg >= 2 * k:
            G = max(G, -(-m // seg))
        G = max(1, min(G, g_max))
    L = -(-m // G) if m else 0
    if L:
        G = -(-m // L)
    S0 = k3_survivors(L, k, dedup)
    S1 = k3_survivors(G * k, k, dedup) if G > 1 else 1
    room = shared - K3_STATIC_SHARED
    glob0 = k3_block_bytes(L, S0) > room
    glob1 = G > 1 and k3_block_bytes(G * k, S1) > room
    ws = -(-R * G * k * K3_ENTRY_BYTES // 16) * 16 if G > 1 else 0
    ws += R * G * k3_block_bytes(L, S0) if glob0 else 0
    ws += R * k3_block_bytes(G * k, S1) if glob1 else 0
    return dict(G=G, L=L, S0=S0, S1=S1, glob0=glob0, glob1=glob1,
                blocks=R * G, merge_entries=G * k if G > 1 else 0,
                workspace_bytes=ws)


@functools.lru_cache(maxsize=256)
def topk_merge_row_max(k: int, shared: int = H100_SHARED_OPTIN) -> int:
    """The longest row of lists of ``k`` that K3's plan reduces with both
    kernels' buffers in shared memory (segments of ``k3_segment_max``, a
    merge of as many lists of k as one block holds), and at least 2^15
    entries: longer rows still reduce, through device memory."""
    seg = k3_segment_max(k, False, shared)
    return max(1 << 15, seg * (seg // k) if seg >= 2 * k else 0)


@functools.lru_cache(maxsize=16)
def card_limits(index) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a card."""
    props = torch.cuda.get_device_properties(index or 0)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def topk_merge(a_vals, a_ids, b_vals=None, b_ids=None, *, k: int,
               fill_id: int, dedup: bool = False,
               seg_len: Optional[int] = None, seg_stride: int = 0,
               with_sel: bool = False):
    """Row-wise top-k over the concatenated lists [a | b] (f32 values,
    int32 ids, [R, m] each), ordered (value desc, id asc, column asc).

    Column c's id becomes ``id + (c // seg_len) * seg_stride`` (shard-major
    lists globalised as ``s * n_pad + local``). Entries at -inf, or with
    an id >= ``fill_id``, take no part; with ``dedup`` an id keeps only its
    highest value (``merge_topk_lists``). Returns (f32[R, k], i32[R, k]);
    slots past the available entries hold (-inf, ``fill_id``). With
    ``with_sel`` a third output i32[R, k] holds each selected entry's
    column in [a | b] (0 on empty slots), so that per-entry payloads
    follow the selection with one ``torch.gather``.

    A CPU tensor runs the plain version; a CUDA tensor launches K3 on the
    plan of :func:`topk_merge_plan` (cached a shape). Each output is its
    own allocation: on the card two ``torch.empty`` calls cost less host
    time than one buffer cut into views.
    """
    if a_vals.device.type == "cpu":
        return topk_merge_plain(a_vals, a_ids, b_vals, b_ids, k=k,
                                fill_id=fill_id, dedup=dedup,
                                seg_len=seg_len, seg_stride=seg_stride,
                                with_sel=with_sel)
    dev = a_vals.device
    if dev.type != "cuda":
        raise ValueError(f"topk_merge: unsupported device {dev}")
    R, ma = a_vals.shape
    mb = 0 if b_vals is None else b_vals.shape[1]
    _kb.check(a_vals, "a_vals", torch.float32, (R, ma), dev)
    _kb.check(a_ids, "a_ids", torch.int32, (R, ma), dev)
    if mb:
        _kb.check(b_vals, "b_vals", torch.float32, (R, mb), dev)
        _kb.check(b_ids, "b_ids", torch.int32, (R, mb), dev)
    out_v = torch.empty((R, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((R, k), dtype=torch.int32, device=dev)
    sel = torch.empty((R, k), dtype=torch.int32, device=dev) \
        if with_sel else None
    outs = (out_v, out_i) if sel is None else (out_v, out_i, sel)
    if R == 0 or k == 0:
        return outs
    G, L, S0, S1, glob0, glob1, ws_bytes = _k3_launch_plan(
        R, ma + mb, k, bool(dedup), dev.index)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) \
        if ws_bytes else None
    _kb.launch("topk_merge", dev, a_vals.data_ptr(), a_ids.data_ptr(), ma,
               b_vals.data_ptr() if mb else None,
               b_ids.data_ptr() if mb else None, mb, R, k, int(dedup),
               seg_len or max(ma + mb, 1), seg_stride, fill_id, G, L, S0,
               S1, glob0, glob1, out_v.data_ptr(), out_i.data_ptr(),
               None if sel is None else sel.data_ptr(),
               None if ws is None else ws.data_ptr())
    return outs


@functools.lru_cache(maxsize=1024)
def _k3_launch_plan(R: int, m: int, k: int, dedup: bool, index):
    """:func:`topk_merge_plan` on card ``index`` as the C entry takes it."""
    p = topk_merge_plan(R, m, k, dedup, *card_limits(index))
    return (p["G"], p["L"], p["S0"], p["S1"], int(p["glob0"]),
            int(p["glob1"]), p["workspace_bytes"])


# ---------------------------------------------------------------------------
# K19: the masked top-k over one segment's scores
# ---------------------------------------------------------------------------


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """Int64 keys that order f32 values as ``lax.top_k`` does: by their
    bits' total order (+NaN > +inf > ... > +0 > -0 > ... > -inf > -NaN)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def masked_topk_plain(scores, mask, k: int):
    """Plain version of K19 (see :func:`masked_topk`)."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(_order_keys(masked), descending=True,
                       stable=True).indices[:k]
    return masked[order], order.to(torch.int32)


def masked_topk(scores, mask, k: int):
    """``where(mask, scores, -inf)``, then its k largest values (k <= n) in
    the reference's order: values by their bits' total order, descending,
    equal values (the masked slots' -inf among them) in ascending index
    order. Returns (f32[k] values, i32[k] indices).

    A CPU tensor runs the plain version; a CUDA tensor launches K19.
    """
    dev = _kb.wrapper_device("masked_topk", scores)
    n = scores.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"masked_topk: k={k} outside [0, {n}]")
    if dev.type == "cpu":
        return masked_topk_plain(scores, mask, k)
    _kb.check(scores, "scores", torch.float32, (n,), dev)
    _kb.check(mask, "mask", torch.bool, (n,), dev)
    vals = torch.empty(k, dtype=torch.float32, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    if k == 0:
        return vals, idx
    ws = torch.empty(_kb.query("segment_topk",
                               "es_segment_topk_workspace_bytes", n, k),
                     dtype=torch.uint8, device=dev)
    _kb.launch("segment_topk", dev, scores.data_ptr(), mask.data_ptr(), n, k,
               vals.data_ptr(), idx.data_ptr(), ws.data_ptr())
    return vals, idx


def _topk_on(scores, mask, *, n: int, k: int):
    if scores.shape[0] != n:
        raise ValueError(f"topk kernel for n={n} got {scores.shape[0]} "
                         f"scores")
    return masked_topk(scores, mask, k)


def get_topk_kernel(n: int, k: int):
    """:func:`masked_topk` at one (n, k) shape, called as the reference
    calls ``get_topk_kernel(n_pad, k)(scores, mask)``."""
    return functools.partial(_topk_on, n=n, k=k)
