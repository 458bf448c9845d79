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

    A CPU tensor runs the plain version; a CUDA tensor launches K3.
    """
    if a_vals.device.type == "cpu":
        return topk_merge_plain(a_vals, a_ids, b_vals, b_ids, k=k,
                                fill_id=fill_id, dedup=dedup,
                                seg_len=seg_len, seg_stride=seg_stride,
                                with_sel=with_sel)
    if a_vals.device.type != "cuda":
        raise ValueError(f"topk_merge: unsupported device {a_vals.device}")
    R, ma = a_vals.shape
    mb = 0 if b_vals is None else b_vals.shape[1]
    _kb.check(a_vals, "a_vals", torch.float32, (R, ma), a_vals.device)
    _kb.check(a_ids, "a_ids", torch.int32, (R, ma), a_vals.device)
    if mb:
        _kb.check(b_vals, "b_vals", torch.float32, (R, mb), a_vals.device)
        _kb.check(b_ids, "b_ids", torch.int32, (R, mb), a_vals.device)
    out_v = torch.empty((R, k), dtype=torch.float32, device=a_vals.device)
    out_i = torch.empty((R, k), dtype=torch.int32, device=a_vals.device)
    sel = torch.empty((R, k), dtype=torch.int32, device=a_vals.device) \
        if with_sel else None
    outs = (out_v, out_i) if sel is None else (out_v, out_i, sel)
    if R == 0 or k == 0:
        return outs
    # rows too long for shared memory are held in device memory
    ws_bytes = _kb.query("topk_merge", "es_topk_merge_workspace_bytes",
                         ma + mb, R)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                     device=a_vals.device) if ws_bytes else None
    _kb.launch("topk_merge", a_vals.device, a_vals.data_ptr(),
               a_ids.data_ptr(), ma, b_vals.data_ptr() if mb else None,
               b_ids.data_ptr() if mb else None, mb, R, k, int(dedup),
               seg_len or max(ma + mb, 1), seg_stride, fill_id,
               out_v.data_ptr(), out_i.data_ptr(),
               None if sel is None else sel.data_ptr(),
               None if ws is None else ws.data_ptr())
    return outs


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
