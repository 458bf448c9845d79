"""Fused planner stages (port of the device half of
``elasticsearch_tpu/search/query_planner.py``).

The reference's planner lowers a request's bool tree, kNN clause, rank
fusion and rescore window into one serving dispatch. This module holds
what that dispatch needs on one card: :func:`bool_rescore_device` (the
bool step with its rescore stage, ``FusedPlanRunner._bool_rescore_device``
as a free function of the text plane) and the host twins the fused path
is checked against: :class:`FusedFallback`, :func:`knn_raw_to_score_host`,
:func:`rrf_fuse_rows` and :func:`sum_fuse_rows`. The lowering of request
bodies and the runner over serving generations are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_query import MAX_BOOL_CLAUSES
from ..parallel.dist_search import bool_bm25_step, decode_hits
from ..utils.shapes import round_up_pow2


class FusedFallback(Exception):
    """The runner cannot serve this dispatch after all (dense-tier terms
    on the sparse slice, …): the caller re-serves through the two-dispatch
    path."""


def knn_raw_to_score_host(similarity: str, raw: float) -> float:
    """Host scalar twin of ``ops.fused_query.knn_raw_to_score``."""
    if similarity in ("cosine", "cos", "dot_product"):
        return (1.0 + raw) / 2.0
    if similarity == "max_inner_product":
        return 1.0 / (1.0 - raw) if raw < 0 else raw + 1.0
    return 1.0 / (1.0 + max(0.0, -raw))


def rrf_fuse_rows(rankings, rc: int):
    """Host RRF fusion: a float64 sum of ``1 / (rc + rank + 1)`` over the
    rankings in list order, sorted (score desc, shard asc, doc asc).
    ``rankings``: ranked ``[(score, shard, doc), ...]`` lists."""
    rrf: Dict[Tuple[int, int], float] = {}
    for ranking in rankings:
        for rank_i, row in enumerate(ranking):
            si, d = row[1], row[2]
            rrf[(si, d)] = rrf.get((si, d), 0.0) + 1.0 / (rc + rank_i + 1)
    return sorted(((sc, si, d) for (si, d), sc in rrf.items()),
                  key=lambda c: (-c[0], c[1], c[2]))


def sum_fuse_rows(rankings):
    """Host linear fusion: docs in several rankings sum their scores in
    list order; sorted as :func:`rrf_fuse_rows`."""
    combined: Dict[Tuple[int, int], float] = {}
    for ranking in rankings:
        for sc, si, d in ranking:
            combined[(si, d)] = combined.get((si, d), 0.0) + sc
    return sorted(((sc, si, d) for (si, d), sc in combined.items()),
                  key=lambda c: (-c[0], c[1], c[2]))


def bool_rescore_device(plane, bqs, items, wt: int, mode: str,
                        stages: Optional[dict] = None):
    """A bool-tree batch with its rescore window in one dispatch
    (:func:`bool_bm25_step` with the rescore query: K9, K5, K3 with the
    payload, K11).

    ``plane``: the text plane; ``bqs``: the lowered bool trees
    (``clauses``/``msm``); ``items``: one dict per query whose
    ``rescore`` (``terms``/``qw``/``rw``/``window``, or None) gives the
    rescore query; ``wt``: the width of the ranking; ``mode``: the score
    mode. Returns (vals f32[B, w], hits list[list[(shard, doc)]], totals
    list[int]). A batch that touches a dense-tier term raises
    ``ValueError``. ``stages`` receives ``prep_ms``, ``dispatch_ms``
    (synchronised) and ``fetch_ms``."""
    t0 = time.perf_counter()
    pad_rs = {"terms": [], "qw": 1.0, "rw": 1.0, "window": 0}
    rss = [it.get("rescore") or pad_rs for it in items]
    prep = plane.prepare_bool(bqs)
    bags2 = [list(rs["terms"]) for rs in rss]
    Q2 = max(8, round_up_pow2(max(
        max((len(set(b)) for b in bags2), default=1), 1)))
    (st2, ln2, iw2, _dr, _dh, _ml2, dense2) = plane._lookup(bags2, Q2)
    if dense2:
        raise ValueError("rescore touches dense-tier terms")
    up = plane._upload
    qw = np.asarray([rs["qw"] for rs in rss], np.float32)
    rw = np.asarray([rs["rw"] for rs in rss], np.float32)
    rwin = np.asarray([rs["window"] for rs in rss], np.int32)
    t1 = time.perf_counter()
    out = bool_bm25_step(**prep["args"], st2=up(st2), ln2=up(ln2),
                         iw2=up(iw2), qw=up(qw), rw=up(rw), rwin=up(rwin),
                         n_pad=plane.n_pad, L=prep["L"], k=wt,
                         nc=MAX_BOOL_CLAUSES, rescore_mode=mode)
    if stages is not None and plane.device.type == "cuda":
        torch.cuda.synchronize(plane.device)
    t2 = time.perf_counter()
    plane.n_dispatches += 1
    vals, gdocs, counts = (o.cpu().numpy() for o in out)
    hits = decode_hits(vals, gdocs, plane.n_pad)
    if stages is not None:
        stages["prep_ms"] = (t1 - t0) * 1e3
        stages["dispatch_ms"] = (t2 - t1) * 1e3
        stages["fetch_ms"] = (time.perf_counter() - t2) * 1e3
    return vals, hits, [int(c) for c in counts]
